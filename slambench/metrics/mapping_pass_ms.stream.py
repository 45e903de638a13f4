"""Mean ms of a local-mapping pass over the window, from the stamps each
pass writes on the device where it runs (inside the chunk graph too)."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    passes = s.pass_ns() if s is not None else []
    return sum(passes) / len(passes) / 1e6 if passes else None
