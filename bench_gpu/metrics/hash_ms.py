"""hash_ms (program span): ms a call in the device hash-to-G1
(`hash_to_g1_device`: host block preparation, SHA-256 and the square roots
of K candidates on the card, the host fallback), the median over the
window's calls."""

from bench_gpu import tracing as TR

SPANS = {"hash": ["bn254_tpu_torch.api:hash_to_g1_device",
                  "bn254_tpu_torch.hash.tai_batch:hash_to_g1_device"]}


def read(run):
    s = run.per_call(lambda c: TR.span_seconds(c, ["hash"]))
    return None if s is None else s * 1e3
