"""to_affine_ms (program span `points.to_affine`): ms a call in the fused
tier's batched affine conversion of the weighted points and the signature
sum (`DG1.to_affine` inside `_fused_points`), every chunk's summed, the
median over the window's calls."""

from bench_gpu import program_spans as PS

install = PS.install


def read(run):
    return PS.span_ms(run, ["points.to_affine"])
