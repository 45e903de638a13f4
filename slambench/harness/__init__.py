"""The benchmark's general code: the registry of configurations, traffic
mixes, limits and metric readers found by name (spec.py), the frames
(frames.py), the closed-loop run of a cell (drive.py), the trace reduction
(trace.py) and the output check (check.py)."""
