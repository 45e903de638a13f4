"""Device ms a frame of the frame phase: the union of the device intervals
of the uploads' host-to-device copies (frame.h2d) and the frame-phase
(stream) or frame-build (per frame) replays, over the window's frames."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    return spans.per_frame_ms(s, s.device_ns(*spans.FRAME_PHASE)) if s is not None else None
