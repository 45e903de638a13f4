"""Runtime calls after which the host waited for the card (the copied
HOST_WAITS list), per frame of the profiled sub-window."""


def read(record):
    t = record.get("trace")
    if t is None or t.frames == 0:
        return None
    return t.host_waits / t.frames
