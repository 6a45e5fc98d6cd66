"""The port's offline runner (``mvil_fusion_torch/run.py``) on the CPU:
`run.main([..., "--device", "cpu"])` on a fixture bag too short to
initialize (0.5 s, 160 × 120 images), synchronous and threaded, against
the JAX runner on the same bag and configuration: the result JSON has the
reference's keys, its message counts are the bag's own, the mapping and
solver entries are equal, and the result files and the map are written.
The end-to-end runs that initialize and track are `slow`, as the
reference's tests/test_offline_runner.py is: the port's runner, sync and
threaded, on that file's bag, with the message counts of the JAX runner's
synchronous run and the reference's gates on ATE.
"""

import json
import os

import numpy as np
import pytest

from mvil_fusion_torch import run as trun
from mvil_fusion_torch.config import CameraConfig, TrackerConfig
from mvil_fusion_torch.io import rosbag as rb
from mvil_fusion_torch.io.fixture import (IMAGE_TOPIC, IMU_TOPIC,
                                          LIDAR_TOPIC, fixture_config,
                                          record_fixture_bag)
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

SMALL = dict(width=160, height=120, fx=115.0, fy=115.0, cx=80.0, cy=60.0)


@pytest.fixture(scope="module")
def short_bag(tmp_path_factory):
    d = tmp_path_factory.mktemp("bag")
    bag, gt, cfgp = (str(d / "short.bag"), str(d / "gt.txt"),
                     str(d / "cfg.json"))
    record_fixture_bag(bag, duration=0.5, n_azimuth=90, compression="lz4",
                       gt_path=gt, **SMALL)
    base = fixture_config(SMALL["fx"], SMALL["fy"], SMALL["cx"], SMALL["cy"])
    cfg = base.replace(
        camera=CameraConfig(width=160, height=120, fx=115.0, fy=115.0,
                            cx=80.0, cy=60.0, k1=0.0, k2=0.0, p1=0.0,
                            p2=0.0),
        tracker=TrackerConfig(max_cnt=60, min_dist=10, max_features_pad=64))
    with open(cfgp, "w") as f:
        json.dump(cfg.to_dict(), f)
    return bag, gt, cfgp


def bag_counts(bag):
    kinds = {IMU_TOPIC: "imu", IMAGE_TOPIC: "image", LIDAR_TOPIC: "lidar"}
    counts = {"imu": 0, "image": 0, "lidar": 0}
    for msg in rb.BagReader(bag).messages():
        counts[kinds[msg.topic]] += 1
    return counts


@pytest.fixture(scope="module")
def reference_result(short_bag, tmp_path_factory):
    from mvil_fusion_tpu import run as jrun
    bag, gt, cfgp = short_bag
    out = str(tmp_path_factory.mktemp("jax")) + "/"
    return jrun.main(["--bag", bag, "--config", cfgp, "--out", out,
                      "--golden", gt, "--save-map", "--platform", "cpu"])


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["sync", "threaded"])
def test_runner_on_short_bag(short_bag, reference_result, tmp_path,
                             threaded, capsys):
    bag, gt, cfgp = short_bag
    out = str(tmp_path) + "/run_"
    argv = ["--bag", bag, "--config", cfgp, "--out", out, "--golden", gt,
            "--save-map", "--device", "cpu"]
    result = trun.main(argv + (["--threaded"] if threaded else []))
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == result
    ref = reference_result
    assert result.keys() == ref.keys()
    counts = bag_counts(bag)
    assert counts == {"imu": 101, "image": 9, "lidar": 2}
    msgs = dict(result["msgs"])
    if threaded:
        assert msgs.pop("shed") == {"frontend": 0, "estimator": 0,
                                    "mapping": 0}
    assert msgs == counts == {k: ref["msgs"][k] for k in counts}
    for key in ("frontend_poses", "midend_poses", "backend_poses",
                "failures", "mapping", "lidar_modes", "solver",
                "map_points"):
        assert result[key] == ref[key], key
    assert result["frontend_poses"] == 0 and result["map_points"] == 0
    for name in ("Frontend.txt", "Midend.txt", "Backend.txt",
                 "ex_results.txt", "Map.pcd", "Map.npz"):
        assert os.path.exists(out + name), name
    assert np.load(out + "Map.npz")["points"].shape == (0, 3)
    assert "POINTS 0" in open(out + "Map.pcd").read()


def test_runner_needs_a_card_by_default(short_bag):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        trun.main(["--bag", short_bag[0]])


def test_parser_matches_reference():
    from mvil_fusion_tpu import run as jrun

    def options(parser):
        return {a.dest: (a.default, a.required)
                for a in parser._actions if a.dest != "help"}
    ref = options(jrun.build_parser())
    ours = options(trun.build_parser())
    assert ref.pop("platform") == (None, False)
    assert ours.pop("device") == (None, False)
    assert ours == ref


# ---------------------------------------------------------------------------
# tests/test_offline_runner.py on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_bag(tmp_path_factory):
    """tests/test_offline_runner.py's bag and configuration."""
    from test_offline_runner import small_cfg
    d = tmp_path_factory.mktemp("e2e")
    bag, gt, cfgp = (str(d / "fixture.bag"), str(d / "gt_tum.txt"),
                     str(d / "cfg.json"))
    record_fixture_bag(bag, duration=6.0, image_hz=20.0, lidar_hz=5.0,
                       n_azimuth=360, compression="lz4", gt_path=gt)
    with open(cfgp, "w") as f:
        json.dump(small_cfg().to_dict(), f)
    return bag, gt, cfgp


@pytest.fixture(scope="module")
def reference_e2e(small_bag, tmp_path_factory):
    """The JAX runner's synchronous run of that bag.  (Its threaded run
    died of a segmentation fault inside XLA:CPU's compiler, called from a
    stage thread, in this sandbox; the message counts are the bag's in
    either mode.)"""
    from mvil_fusion_tpu import run as jrun
    bag, gt, cfgp = small_bag
    out = str(tmp_path_factory.mktemp("jax_e2e")) + "/"
    return jrun.main(["--bag", bag, "--config", cfgp, "--out", out,
                      "--golden", gt, "--save-map", "--platform", "cpu"])


@pytest.mark.slow
@pytest.mark.parametrize("threaded", [False, True],
                         ids=["sync", "threaded"])
def test_runner_end_to_end_against_reference(small_bag, reference_e2e,
                                             tmp_path, threaded):
    from test_offline_runner import _check
    bag, gt, cfgp = small_bag
    extra = ["--threaded"] if threaded else ["--save-map"]
    out = str(tmp_path) + "/torch_"
    ours = trun.main(["--bag", bag, "--config", cfgp, "--out", out,
                      "--golden", gt, "--device", "cpu"] + extra)
    _check(ours, out, ate_gate=0.7 if threaded else 0.3)
    for k in ("imu", "image", "lidar"):
        assert ours["msgs"][k] == reference_e2e["msgs"][k] \
            == bag_counts(bag)[k]
    if not threaded:
        assert ours["map_points"] > 100
