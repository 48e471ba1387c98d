"""mfu.decode: model FLOPs (2 x active parameters a token, plus the
recurrences) of every token the traced steps processed, over the traced
window at the H100's dense int8 peak (1,979 TOP/s), in %."""
from bench.harness import readers


def read(run):
    return readers.mfu(run)
