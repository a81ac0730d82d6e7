"""kernels_roofline (device trace): the port's hand-written kernels
(`kernels/fused.cu`, `kernels/montmul.cu`) against their roofline over the
profiled calls, %.

Numerator: the sum over their launches of the least time each could take,
the larger of its bytes over the HBM rate and its 32-bit multiply-adds over
the INT32 rate (`peaks.json`), from `kernel_work/<key>.json` and the lanes
each launch had (recorded around `fused._launch` and montmul's launcher).
Denominator: the profiler's device time of their kernel rows. A row of the
port that no work file names counts in the denominator and is named on
standard error; so is a launched key with no work file.
"""

import re

from bench_gpu import spec

# kernel rows of the port's libraries that a work file may not name yet
PORT_ROWS = ("bn254", "coop_kernel")


def install(tracer):
    def fused_launch(orig):
        def launch(key, packed, out):
            tracer.launch(key, int(packed.shape[2]))
            return orig(key, packed, out)
        return launch

    def montmul_kernel(orig):
        def kernel():
            fn = orig()

            def launch(a, b, out, n, stream):
                tracer.launch("montmul", int(n))
                return fn(a, b, out, n, stream)
            return launch
        return kernel

    tracer.patch("bn254_tpu_torch.kernels.fused:_launch", fused_launch)
    tracer.patch("bn254_tpu_torch.kernels.montmul:_kernel", montmul_kernel)


def least_seconds(work: dict, lanes: int, peaks: dict) -> float:
    """The least time of one launch at `lanes` lanes."""
    t_bytes = ((work["els_read"] + work["els_written"]) * work["bytes_per_el"]
               * lanes / peaks["hbm_bytes_per_s"])
    t_ops = (work["products_per_lane"] * work["mads_per_product"] * lanes
             / peaks["int32_mad_per_s"])
    return max(t_bytes, t_ops)


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    work, peaks = spec.kernel_work(), spec.peaks()
    patterns = [re.compile(w["kernel_regex"]) for w in work.values()]
    device_s, unnamed = 0.0, set()
    for name, seconds in run.trace.op_seconds().items():
        if any(p.search(name) for p in patterns):
            device_s += seconds
        elif any(m in name for m in PORT_ROWS):
            device_s += seconds
            unnamed.add(name)
    least, no_work = 0.0, set()
    for call in run.profiled:
        for key, lanes in call.launches:
            if key in work:
                least += least_seconds(work[key], lanes, peaks)
            else:
                no_work.add(key)
    for name in sorted(unnamed):
        print(f"kernels_roofline: no work file names the row {name}",
              file=run.log)
    for key in sorted(no_work):
        print(f"kernels_roofline: no work file for launched key {key}",
              file=run.log)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
