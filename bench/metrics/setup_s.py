"""setup_s: seconds from the start of the benchmark's process to the
window's first moment: imports, the weight draw, the kernels' build or
cache load, the scheduler and the warm-up traffic."""


def read(run):
    return run.setup_s
