"""Mean ms of a local-mapping pass over the window (the program's
pipeline.timed_mapping_passes(): host clock, synchronized around each
pass; only the per-frame steps can time one)."""


def read(record):
    passes = record.get("timers", {}).get("pass_s", [])
    return sum(passes) / len(passes) * 1e3 if passes else None
