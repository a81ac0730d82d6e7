"""miller_ms (program span): ms a call in the fused tier's batched Miller
loop and Fq12 product (`_miller_reduce`), every chunk's summed, the median
over the window's calls."""

from bench_gpu import tracing as TR

SPANS = {"miller": ["bn254_tpu_torch.dist.batch_verify:_miller_reduce"]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["miller"]))
    return None if s is None else s * 1e3
