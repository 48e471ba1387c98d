"""pim_crossbar_share: device time of crossbar_exec_kernel over the device's
busy time in the traced window, in %; the rest of the pim engine's work is
packing operands and reading results."""
from bench.harness import readers


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * t.kernel_s(readers.CROSSBAR_KERNEL) / t.busy_s
