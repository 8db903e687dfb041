"""setup_s: the process's start to the window's open, in seconds: imports,
inputs, the session's cached inputs, the warm-up (and, in a checkout's
first run, the kernels' build)."""

UNIT, SOURCE = "s", "host_clock"


def read(run):
    return run.setup_s
