"""device_idle_share (device trace): the share of the profiled calls' wall
time in which no kernel, copy or fill ran on the card, %."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
