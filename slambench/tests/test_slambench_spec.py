"""BENCHMARK.json against the contract's rules, and the registry: every
configuration, traffic mix, limits file and metric reader is found by its
name, and a new one is picked up by adding files and entries alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from slambench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len(set(names[:len(BENCH["configs"]) + len(BENCH["workloads"])])) == \
        len(BENCH["configs"]) + len(BENCH["workloads"])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_layer_metric_is_reported_where_it_moves_something():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.end_to_end(cell, BENCH)}, (m, cell)
    for cell in cells:
        e2e = {m["name"] for m in spec.end_to_end(cell, BENCH)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(cell, BENCH)


def test_bounds_run_length_and_chips_follow_the_rules():
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells has to fit the check's time
    assert 1200 + (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 <= 43200
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_name_is_found(cell):
    w = spec.workload(cell)
    cfg = spec.config(w["config"])
    assert cfg["name"] == w["config"] and (Path(cfg["dir"]) / cfg["settings"]).exists()
    assert spec.traffic(w["traffic"])["frames_per_call"] >= 1
    assert spec.limits(cell)
    for m in spec.per_layer(cell):
        assert callable(spec.metric_reader(m["name"]))
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert Path(spec.REPO_DIR / entry["file"]).resolve() == Path(cfg["dir"]) / "config.json"
    assert set(entry["reduced"]) == set(cfg["reduced"])


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_mix_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add a configuration, a mix, a metric reader and
    a cell's limits as new files with their BENCHMARK.json entries, and
    find them all; no file the copy had before changes."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "slambench",
                    ignore=shutil.ignore_patterns("_out", "__pycache__"))
    before = _digest(root / "slambench")
    b = dict(BENCH)
    d = root / "slambench"
    (d / "configs" / "new_cfg").mkdir()
    shutil.copy(d / "configs" / "tum1_rgbd" / "TUM1.yaml", d / "configs" / "new_cfg" / "A.yaml")
    cfg = json.loads((d / "configs" / "tum1_rgbd" / "config.json").read_text())
    cfg.update(name="new_cfg", settings="A.yaml")
    (d / "configs" / "new_cfg" / "config.json").write_text(json.dumps(cfg))
    (d / "traffic" / "new_mix.json").write_text(json.dumps(
        {"api": "batch", "frames_per_call": 8, "loop": "closed", "clients": 1,
         "trajectory": "lookat", "cycle_frames": 160, "warmup_cycles": 1, "trace_calls": 1}))
    (d / "metrics" / "new_metric.py").write_text("def read(record):\n    return 42.0\n")
    (d / "limits" / "new_cfg.new_mix.json").write_text(json.dumps({"feat_diff": 0}))
    b["configs"] = b["configs"] + [{"name": "new_cfg", "source": "x", "reduced": [],
                                    "file": "slambench/configs/new_cfg/config.json",
                                    "why": "x"}]
    b["workloads"] = b["workloads"] + [{"name": "new_cfg.new_mix", "config": "new_cfg",
                                        "traffic": "new_mix", "chips": 1, "why": "x"}]
    b["per_layer"] = b["per_layer"] + [{"name": "new_metric", "unit": "%", "better": "higher",
                                        "source": "device_trace", "layer": "device",
                                        "moves": "fps", "workloads": ["new_cfg.new_mix"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    probe = (
        "from slambench.harness import spec\n"
        "w = spec.workload('new_cfg.new_mix')\n"
        "assert spec.config(w['config'])['settings'] == 'A.yaml'\n"
        "assert spec.traffic(w['traffic'])['frames_per_call'] == 8\n"
        "assert spec.limits('new_cfg.new_mix') == {'feat_diff': 0}\n"
        "names = [m['name'] for m in spec.per_layer('new_cfg.new_mix')]\n"
        "assert names == ['new_metric'], names\n"
        "assert spec.metric_reader('new_metric')({}) == 42.0\n"
        "print('found')\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr
    after = _digest(root / "slambench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_mix_key_nothing_reads_is_refused():
    from slambench.harness.traffic import check_mix

    mix = spec.traffic("stream4")
    assert check_mix(dict(mix)) == mix
    with pytest.raises(ValueError, match="nothing reads"):
        check_mix({**mix, "speed": 2})

