"""One short run of the mapping cell on the CPU through the harness: the
last line's keys, the judge reached, the report lines."""

import math
import time

import torch
from conftest import MAPPING, bench

from slambench import run as R


def _tiny(conf, traffic, limits):
    traffic["warm"] = {"min_sweeps": 4, "max_sweeps": 4}
    traffic["judge"].update(pairs=2, loop_pairs=0)


def test_mapping_feed_runs_and_judges():
    torch.set_num_threads(4)
    line, out = R.run_cell(bench(), MAPPING, 20261023, 0.1, 0,
                           torch.device("cpu"), time.perf_counter(), _tiny)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["metrics"]) == {"sensor_s_per_s", "setup_s"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["compared"]["missing_answers"]["value"] == 0
    assert line["compared"]["nonfinite_poses"]["value"] == 0
    # the window's one sweep, deskewed as the reference deskews it
    assert out["info"]["deskew_judged"] == [out["info"]["warm_sweeps"]]
    assert line["compared"]["deskew_gap_max_m"]["value"] < 1e-4
    # no keyed pair a lap apart in so short a run: the loop number is
    # infinite, the run not correct
    assert math.isinf(line["compared"]["loop_gap_max_m"]["value"])
    assert line["correct"] is False
    gaps = out["info"]["sweep_b1_rms_m"]
    assert 1 <= len(gaps) <= 2 and max(gaps) < 0.05
