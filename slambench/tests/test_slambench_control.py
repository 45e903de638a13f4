"""The control (the reference in the program's place, stored in
bfloat16) is refused by each cell's limits: on the CPU at a small size,
and on the card at the cell's own size on three seeds."""

from __future__ import annotations

import pytest

from slambench import control
from slambench.harness import spec
from slambench.tests import toy

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["late", "bf16"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused_at_a_small_size(cell, kind):
    config = spec.workload(cell)["config"]
    out = control.control(cell, 5, "cpu", {"config": {"changed": toy.changed(config)},
                                            "cycle_frames": 40, "start": 0}, kind=kind)
    assert out["correct"] is False, out
    if kind == "late":   # one frame late fails every pose number and the features
        failed = {n for n, c in out["checks"].items() if c["value"] > c["limit"]}
        assert failed >= {"ate_mm", "ate_r_deg", "kf_t_mm", "kf_r_deg", "feat_diff"}, failed


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused_at_the_cells_size(card, cell):
    for seed in (101, 102, 103):
        out = control.control(cell, seed, card)
        assert out["correct"] is False, out
