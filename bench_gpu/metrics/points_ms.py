"""points_ms (program span): ms a call in the fused tier's points stage
(`_fused_points`: the GLV weight ladders, the signature tree-sum and the
batched `to_affine`), every chunk's summed, the median over the window's
calls."""

from bench_gpu import tracing as TR

SPANS = {"points": ["bn254_tpu_torch.dist.batch_verify:_fused_points"]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["points"]))
    return None if s is None else s * 1e3
