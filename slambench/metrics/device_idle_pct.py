"""The device's idle share of the window, %: 100 x (1 - the union of every
device interval the program's spans recorded, with the stamped passes,
over the window).  A lower bound on idle: a gap inside one span's
interval is not seen."""

from slambench.harness import spans


def read(record):
    s = spans.summary(record)
    if s is None or s.window_ns <= 0:
        return None
    return 100.0 * (1.0 - s.busy_ns() / s.window_ns)
