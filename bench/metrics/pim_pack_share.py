"""pim_pack_share: device time launched under the program's repro:pim.pack
spans (blank crossbar state, the bit-sliced writes of both operands, x's
chunk padding) over the device's busy time in the traced window, in %."""
from bench.harness import spans


def read(run):
    return None if run.spans is None else run.spans.share(
        *spans.SHARES["pim_pack_share"])
