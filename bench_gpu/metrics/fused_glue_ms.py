"""fused_glue_ms (program counter `kernels.fused:host_ns`): host ms a call
in `fused_op`'s CUDA path from entry to each launch's return (bound checks,
the output template, `pack`, the allocation, the launch call), the median
over the window's calls. The counter runs only while an `obs` recorder is
installed, which `install` does."""

from bench_gpu import program_spans as PS

COUNTERS = {"fused_glue_ms": "bn254_tpu_torch.kernels.fused:host_ns"}
install = PS.install


def read(run):
    ns = run.per_call(lambda c: c.counters.get("fused_glue_ms"))
    return None if ns is None else ns * 1e-6
