"""ladder_ms (program span `points.ladder`): ms a call in the fused tier's
GLV weight ladders (`_apply_weights` inside `_fused_points`), every chunk's
summed, the median over the window's calls."""

from bench_gpu import program_spans as PS

install = PS.install


def read(run):
    return PS.span_ms(run, ["points.ladder"])
