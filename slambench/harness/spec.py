"""Everything the harness runs is found by name: a configuration in
configs/<name>/config.json (beside its upstream settings file), a traffic
mix in traffic/<name>.json, a cell's output limits in limits/<cell>.json and
a per-layer metric's reader in metrics/<metric>.py.  Adding one of these is
adding a file and an entry of BENCHMARK.json; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO_DIR = BENCH_DIR.parent


def benchmark(root: Path = REPO_DIR) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, bench: dict | None = None) -> dict:
    bench = bench or benchmark()
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    """configs/<name>/config.json, with `dir` set to its folder."""
    path = BENCH_DIR / "configs" / name / "config.json"
    cfg = _load_json(path)
    cfg["dir"] = str(path.parent)
    return cfg


def traffic(name: str) -> dict:
    """traffic/<name>.json; a key the generator does not read is refused."""
    from .traffic import check_mix

    return check_mix(_load_json(BENCH_DIR / "traffic" / f"{name}.json"))


def limits(cell: str) -> dict:
    """limits/<cell>.json: {number: limit} of the output check."""
    return _load_json(BENCH_DIR / "limits" / f"{cell}.json")


def metric_reader(name: str):
    """The `read(record)` function of metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(cell: str, bench: dict | None = None) -> list[dict]:
    """The end-to-end metrics the cell reports."""
    bench = bench or benchmark()
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(cell: str, bench: dict | None = None) -> list[dict]:
    """The per-layer metrics the cell reports: those that list it, and those
    with no list whose end-to-end metric the cell reports."""
    bench = bench or benchmark()
    e2e = {m["name"] for m in end_to_end(cell, bench)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
