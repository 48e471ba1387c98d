"""pim_read_share: device time launched under the program's repro:pim.read
spans (the accumulators read back from the crossbar state, the chunk sums)
over the device's busy time in the traced window, in %."""
from bench.harness import spans


def read(run):
    return None if run.spans is None else run.spans.share(
        *spans.SHARES["pim_read_share"])
