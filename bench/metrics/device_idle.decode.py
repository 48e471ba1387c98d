"""device_idle.decode: share of the traced window in which no operation
ran on the device (union of kernel, copy and set intervals), in %."""
from bench.harness import readers


def read(run):
    return readers.idle_share(run)
