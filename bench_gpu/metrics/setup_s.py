"""setup_s (host clock): from the start of the process to the end of the
warm-up: imports, the CUDA context, loading (on a checkout's first run,
building) the kernel libraries, loading or making the inputs, the entry's
set-up and the warm-up calls."""


def read(run):
    return run.setup_s
