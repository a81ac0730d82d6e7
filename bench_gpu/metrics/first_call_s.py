"""first_call_s (host clock): the first call of the timed path in set-up,
its verdict on the host: `fused_op` learns each body's output bounds on
one-lane CPU inputs, first-call templates run, the allocator grows."""


def read(run):
    return run.first_call_s
