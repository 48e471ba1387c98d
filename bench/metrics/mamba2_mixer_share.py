"""mamba2_mixer_share: device time launched under the program's
repro:ssm.mamba2 spans (models/ssm.py::mamba2_mixer: in_proj, the conv,
the recurrence, the gated norm and out_proj) over the device's busy time
in the traced window, in %."""


def read(run):
    return None if run.spans is None else run.spans.share("ssm.mamba2")
