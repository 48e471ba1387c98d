"""crossbar_exec_roofline: the least times of the pim_sim linears the traced
decode steps ran (the crossbar state read and written once over HBM, or one
32-bit operation per gate per row-word; the 37-term program, M the step's
tokens), over the device time of crossbar_exec_kernel under the decode
spans, in %."""
from bench.harness import readers


def read(run):
    return readers.roofline(run, readers.CROSSBAR_KERNEL, "decode")
