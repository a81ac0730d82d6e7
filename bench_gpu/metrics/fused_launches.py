"""fused_launches (program counter): fused-kernel launches a call, the
exact count of `kernels/fused.py`'s `launches`, the median over the
window's calls."""

COUNTERS = {"fused_launches": "bn254_tpu_torch.kernels.fused:launches"}


def read(run):
    return run.per_call(lambda c: c.counters.get("fused_launches"))
