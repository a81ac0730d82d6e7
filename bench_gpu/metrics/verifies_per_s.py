"""verifies_per_s (host clock): all tuples of the window's calls over the
time from the first call's start to the last call's end, every call's
verdict on the host."""


def read(run):
    if not run.calls:
        return None
    span = run.calls[-1].t1 - run.calls[0].t0
    return run.tuples * len(run.calls) / span
