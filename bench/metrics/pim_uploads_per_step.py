"""pim_uploads_per_step: the pim engine's crossbar state uploads
(engine.cache_info().exec_uploads) over the window, per decode step;
resident state stays resident, so 0 is expected."""


def read(run):
    steps = len(run.decode_steps)
    return run.uploads / steps if steps else None
