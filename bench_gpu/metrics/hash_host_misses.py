"""hash_host_misses (program counter `hash.tai_batch:host_fallbacks`):
messages a call that the device hash's K-candidate search missed and the
host hashed, the median over the window's calls (0 when none missed)."""

COUNTERS = {"hash_host_misses":
            "bn254_tpu_torch.hash.tai_batch:host_fallbacks"}


def read(run):
    return run.per_call(lambda c: c.counters.get("hash_host_misses"))
