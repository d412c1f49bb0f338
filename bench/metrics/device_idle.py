"""device_idle.<cells> (``device_idle.chat``, ``device_idle.docs``; the
manifest finds this file for each): the share of the traced slice in which
no CUDA activity ran (torch.profiler). Layer: the device."""


def read(run):
    s = run.slice
    if s is None or s.window_s <= 0:
        return None
    return (1.0 - s.busy_s() / s.window_s) * 100
