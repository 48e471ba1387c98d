"""linear_quant_share: device time launched under the program's
repro:linear.quantize and repro:linear.rescale spans (the activations'
quantization and the products' rescale around each integer linear) over
the device's busy time in the traced window, in %."""
from bench.harness import spans


def read(run):
    return None if run.spans is None else run.spans.share(
        *spans.SHARES["linear_quant_share"])
