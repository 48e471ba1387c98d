"""moe_shared_share: device time launched under the program's repro:moe.shared
spans (models/model.py::_moe: the shared expert's gated MLP, its linears'
quantization, packing, crossbar execution and reading included) over the
device's busy time in the traced window, in %."""


def read(run):
    return None if run.spans is None else run.spans.share("moe.shared")
