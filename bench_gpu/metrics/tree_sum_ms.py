"""tree_sum_ms (program span `points.tree_sum`): ms a call in the fused
tier's signature tree-sum (`_g1_tree_sum` inside `_fused_points`), every
chunk's summed, the median over the window's calls."""

from bench_gpu import program_spans as PS

install = PS.install


def read(run):
    return PS.span_ms(run, ["points.tree_sum"])
