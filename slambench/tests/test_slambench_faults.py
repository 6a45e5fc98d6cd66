"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (the harness's look for a card is
skipped: ``run_cell`` is called with the device), once sound and once
for each fault the cell can have: a step that returns its state
unchanged (the local mapper's published pose stays at its first), half
of the work left out (every second sweep never answered), an answer
altered where it is produced (N(0, 0.5 m) on each published position).
The exchange between chips does not exist in this one-card cell.

On the CPU the orbit is shrunk to 1.2 m and 4 s a lap, the sweeps to
16 × 500, and the window is the 25 sweeps after 50 of set-up, so that
keyed poses a lap apart and their judging fit a test run.  On a card (marked ``cuda``,
skipped without one) the unchanged state and the half work are read at
the cell's own size.
"""

import time

import numpy as np
import pytest
import torch
from conftest import MAPPING, bench

from slambench import run as R


def _small(conf, traffic, limits):
    conf["sensor"]["lidar"]["n_azimuth"] = 500
    traffic["trajectory"].update(period_s=4.0, p_amp=[1.2, 0.6, 0.2])
    traffic["warm"] = {"min_sweeps": 50, "max_sweeps": 50}
    traffic["stream_s"] = 7.5
    traffic["judge"].update(pairs=2, loop_pairs=2, loop_max_dist_m=5.0,
                            deskew_sweeps=3)


def _patch_output(monkeypatch, fault):
    """Break the local mapper where it publishes a pose: its
    `_after_step(t, hp, ...)`, the pose at hp[0:7]."""
    from mvil_fusion_torch.mapping.local_mapping import LocalMapper
    orig = LocalMapper._after_step
    first = {}
    rng = np.random.default_rng(5)

    def broken(self, t, hp, *a):
        hp = np.array(hp, copy=True)
        if fault == "unchanged":
            first.setdefault("pose", hp[0:7].copy())
            hp[0:7] = first["pose"]
        else:
            hp[0:3] += rng.normal(scale=0.5, size=3)
        return orig(self, t, hp, *a)
    monkeypatch.setattr(LocalMapper, "_after_step", broken)


def _patch_half(monkeypatch):
    from mvil_fusion_torch.mapping.local_mapping import LocalMapper
    orig = LocalMapper.process_full
    calls = [0]

    def half(self, *a, **k):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return None
        return orig(self, *a, **k)
    monkeypatch.setattr(LocalMapper, "process_full", half)


def _break(monkeypatch, fault):
    if fault in ("unchanged", "altered"):
        _patch_output(monkeypatch, fault)
    elif fault == "half":
        _patch_half(monkeypatch)


@pytest.mark.parametrize("fault", ["none", "unchanged", "half", "altered"])
def test_fault_makes_the_run_not_correct(monkeypatch, fault):
    _break(monkeypatch, fault)
    torch.set_num_threads(2)
    line, _ = R.run_cell(bench(), MAPPING, 20261018, 1e6, 0,
                         torch.device("cpu"), time.perf_counter(), _small)
    assert line["correct"] is (fault == "none"), line["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_fault_at_the_cells_size(monkeypatch, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fault is read at the cell's "
                    "own size")
    _break(monkeypatch, fault)
    line, _ = R.run_cell(bench(), MAPPING, 20261024, 20.0, 0,
                         torch.device("cuda"), time.perf_counter())
    print(fault, line["compared"])
    assert line["correct"] is False, line["compared"]
