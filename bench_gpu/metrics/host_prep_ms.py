"""host_prep_ms (program span): ms a call in the API's host conversions of
signatures and public keys and in the RLC weight draw, the median over the
window's calls."""

from bench_gpu import tracing as TR

SPANS = {"host_prep": [
    "bn254_tpu_torch.utils.convert:g1_batch_to_device_affine",
    "bn254_tpu_torch.utils.convert:g2_batch_to_device_affine",
    "bn254_tpu_torch.dist.batch_verify:random_weights",
]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["host_prep"]))
    return None if s is None else s * 1e3
