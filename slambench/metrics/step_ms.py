"""Device ms a frame of the tracking step: the union of the device intervals
of the chunk-graph replays (stream), or of the core, LOST and tail
replays (per frame), less the stamped mapping passes inside them, over the
window's frames."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    if s is None:
        return None
    return spans.per_frame_ms(s, s.device_ns(*spans.STEP, without_passes=True))
