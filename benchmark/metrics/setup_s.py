"""Everything before the window, host clock: imports, the CUDA context,
the program's library build or load, the inputs from the seed, and the
warm-up calls."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
