"""fallback_ms (program span): ms a call in the independent tier
(`verify_batch_independent`), which a rejected batch runs to find its bad
tuples, the median over the window's calls that ran it."""

from bench_gpu import tracing as TR

SPANS = {"fallback": [
    "bn254_tpu_torch.dist.batch_verify:verify_batch_independent"]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["fallback"]))
    return None if s is None else s * 1e3
