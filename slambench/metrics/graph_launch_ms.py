"""Host ms a frame spent launching CUDA graphs (the graph.launch spans
around every replay) over the window's frames."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    return spans.per_frame_ms(s, s.host_ns("graph.launch")) if s is not None else None
