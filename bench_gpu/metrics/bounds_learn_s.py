"""bounds_learn_s (program counter `kernels.fused:bounds_learn_ns`): s the
process spent, by the run's end, learning `fused_op`'s output bounds from
one-lane CPU runs of the plain bodies (`_out_struct`'s misses), nearly all
in set-up's first call. The count of bodies learned
(`kernels.fused:bounds_learned`) goes to the run's log."""

from bench_gpu import tracing as TR

NS = "bn254_tpu_torch.kernels.fused:bounds_learn_ns"
COUNT = "bn254_tpu_torch.kernels.fused:bounds_learned"


def read(run):
    ns = TR.counter_value(NS)
    if ns is None:
        return None
    print(f"bounds_learn_s: {TR.counter_value(COUNT)} bodies learned",
          file=run.log)
    return ns * 1e-9
