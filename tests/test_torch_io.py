"""The port's I/O, evaluation and configuration against the JAX package's:
lz4 frames and xxHash32 byte for byte, rosbags written by the two
BagWriters byte for byte (none, bz2 and lz4 chunks) and read across,
fixture bags (the regular and the hard one) recorded byte for byte with
their ground truth, ATE/RPE within 1e-12, a configuration JSON written by
the reference's `to_dict` loading field for field (a left-out field only
at the reference's default), and the plots of `utils/viz.py`.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.io import fixture as jfixture
from mvil_fusion_tpu.io import lz4 as jlz4
from mvil_fusion_tpu.io import rosbag as jrb
from mvil_fusion_tpu.utils import evaluation as jev
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.io import fixture as tfixture
from mvil_fusion_torch.io import lz4 as tlz4
from mvil_fusion_torch.io import rosbag as trb
from mvil_fusion_torch.io.synthetic import SyntheticTrajectory
from mvil_fusion_torch.io.synthetic_lidar import BoxWorld, simulate_sweep
from mvil_fusion_torch.utils import evaluation as tev
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


def lz4_inputs():
    rng = np.random.default_rng(0)
    img = np.zeros((120, 160), np.uint8)
    img[rng.integers(0, 120, 300), rng.integers(0, 160, 300)] = 200
    return [b"", b"a", b"abcd" * 3, bytes(1000),
            bytes(rng.integers(0, 4, 5000, dtype=np.uint8)),
            bytes(rng.integers(0, 256, 3000, dtype=np.uint8)),
            b"xyz" * 700 + bytes(rng.integers(0, 2, 900, dtype=np.uint8))
            + bytes(70000) + b"q" * 40,
            img.tobytes() * 3]


@pytest.mark.parametrize("block_size", [1 << 20, 1 << 12])
def test_lz4_matches_reference(block_size):
    for data in lz4_inputs():
        ours = tlz4.compress(data, block_size)
        assert ours == jlz4.compress(data, block_size), len(data)
        assert tlz4.decompress(ours) == data == jlz4.decompress(ours)
        assert tlz4.compress_block(data) == jlz4.compress_block(data)
        for seed in (0, 7):
            assert tlz4.xxh32(data, seed) == jlz4.xxh32(data, seed)


def write_bag(rb, path, compression):
    """One bag of IMU, images and a sweep with intensity through the given
    package's writer and encoders."""
    traj = SyntheticTrajectory(duration=2.0)
    rng = np.random.default_rng(1)
    w = rb.BagWriter(path, compression=compression)
    w.add_connection("/imu", "sensor_msgs/Imu")
    w.add_connection("/image", "sensor_msgs/Image")
    w.add_connection("/points", "sensor_msgs/PointCloud2")
    acc, gyr, _, ts = traj.imu_sequence(0.5, 1.0, 200.0)
    for k in range(len(ts)):
        w.write("/imu", ts[k], rb.encode_imu(ts[k], acc[k], gyr[k]))
    for t in np.arange(0.5, 1.0, 0.1):
        img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
        w.write("/image", t, rb.encode_image(t, img))
    s = simulate_sweep(BoxWorld(), traj, 0.7, n_azimuth=90)
    w.write("/points", 0.7, rb.encode_pointcloud2(
        0.7, s["pts"], s["ring"].astype(np.float32) + s["rel_time"]))
    w.close()


def messages(rb, path):
    out = []
    for kind, t, payload in rb.play(path, "/imu", "/image", "/points"):
        if kind == "lidar":
            payload = tuple(sorted((k, v.tobytes())
                                   for k, v in payload[0].items()))
        else:
            payload = tuple(np.asarray(v).tobytes() for v in payload)
        out.append((kind, t, payload))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bags_match_reference(tmp_path, compression):
    paths = {}
    for name, rb in (("jax", jrb), ("torch", trb)):
        paths[name] = str(tmp_path / f"{name}.bag")
        write_bag(rb, paths[name], compression)
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    seen = [messages(rb, paths[other]) for rb, other in
            ((jrb, "torch"), (trb, "jax"), (trb, "torch"))]
    assert seen[0] == seen[1] == seen[2]
    kinds = [m[0] for m in seen[0]]
    assert (kinds.count("imu"), kinds.count("image"),
            kinds.count("lidar")) == (101, 5, 1)


def test_fixture_bags_match_reference(tmp_path):
    for rec in ("record_fixture_bag", "record_hard_fixture_bag"):
        files = []
        for name, mod in (("jax", jfixture), ("torch", tfixture)):
            bag = str(tmp_path / f"{name}_{rec}.bag")
            gt = str(tmp_path / f"{name}_{rec}.txt")
            kw = dict(duration=0.6, n_azimuth=90, compression="lz4",
                      gt_path=gt)
            if rec == "record_fixture_bag":
                kw.update(width=160, height=120, fx=115.0, fy=115.0,
                          cx=80.0, cy=60.0)
            getattr(mod, rec)(bag, **kw)
            files.append((open(bag, "rb").read(), open(gt, "rb").read()))
        assert files[0] == files[1], rec
    assert tconfig.SystemConfig.from_dict(
        jfixture.fixture_config().to_dict()) == tfixture.fixture_config()
    assert (tfixture.IMU_TOPIC, tfixture.IMAGE_TOPIC, tfixture.LIDAR_TOPIC) \
        == (jfixture.IMU_TOPIC, jfixture.IMAGE_TOPIC, jfixture.LIDAR_TOPIC)
    pw = np.random.default_rng(2).normal(size=(50, 3))
    np.testing.assert_array_equal(tfixture.surface_reflectivity(pw),
                                  jfixture.surface_reflectivity(pw))


@pytest.mark.parametrize("mode", ["4dof", "se3", "sim3"])
def test_evaluation_matches_reference(tmp_path, mode):
    rng = np.random.default_rng(3)
    t_gt = np.arange(0.0, 8.0, 0.02)
    p_gt = np.cumsum(rng.normal(scale=0.05, size=(len(t_gt), 3)), axis=0)
    t_est = t_gt[5::5] + rng.uniform(-0.01, 0.01, len(t_gt[5::5]))
    p_est = p_gt[5::5] @ np.asarray([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]]) \
        + rng.normal(scale=0.02, size=(len(t_est), 3)) + 0.3
    a = tev.ate_rmse(t_est, p_est, t_gt, p_gt, mode=mode)
    b = jev.ate_rmse(t_est, p_est, t_gt, p_gt, mode=mode)
    assert np.isfinite(a) and abs(a - b) <= 1e-12
    for delta in (0.5, 1.0):
        a = tev.rpe_rmse(t_est, p_est, t_gt, p_gt, delta=delta)
        b = jev.rpe_rmse(t_est, p_est, t_gt, p_gt, delta=delta)
        assert np.isfinite(a) and abs(a - b) <= 1e-12
    for x, y in zip(tev.associate(t_est, t_gt), jev.associate(t_est, t_gt)):
        np.testing.assert_array_equal(x, y)
    q = rng.normal(size=(len(t_est), 4))
    rows = list(zip(t_est, p_est, q / np.linalg.norm(q, axis=1)[:, None]))
    tev.save_tum(str(tmp_path / "t.txt"), rows)
    jev.save_tum(str(tmp_path / "j.txt"), rows)
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()
    for x, y in zip(tev.load_tum(str(tmp_path / "t.txt")),
                    jev.load_tum(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(x, y)


def offline_runner_config():
    from test_offline_runner import small_cfg
    return small_cfg()


@pytest.mark.parametrize("which", ["default", "fixture", "offline_runner"])
def test_reference_config_json_loads(tmp_path, which):
    ref = {"default": jconfig.SystemConfig,
           "fixture": jfixture.fixture_config,
           "offline_runner": offline_runner_config}[which]()
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump(ref.to_dict(), f)
    ours = tconfig.SystemConfig.from_json(path)
    for section in dataclasses.fields(ours):
        a, b = getattr(ours, section.name), getattr(ref, section.name)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), \
                (section.name, f.name)
    assert tconfig.SystemConfig.from_dict(ours.to_dict()) == ours
    # and the reference reads the port's JSON back to the same values
    back = jconfig.SystemConfig.from_dict(ours.to_dict())
    for section, fields in ours.to_dict().items():
        for name, value in fields.items():
            assert getattr(getattr(back, section), name) == value \
                or list(getattr(getattr(back, section), name)) == value


def test_left_out_fields_hold_the_reference_defaults():
    ref = jconfig.SystemConfig()
    left = dict(tconfig.LEFT_OUT)
    parallel = left.pop("SystemConfig")
    assert set(parallel) == {"parallel"}
    assert parallel["parallel"] == dataclasses.asdict(ref.parallel)
    for f in dataclasses.fields(ref):
        if f.name == "parallel":
            continue
        ref_sec = getattr(ref, f.name)
        ours = {x.name for x in dataclasses.fields(
            getattr(tconfig.SystemConfig(), f.name))}
        missing = {x.name: getattr(ref_sec, x.name)
                   for x in dataclasses.fields(ref_sec)
                   if x.name not in ours}
        assert missing == left.pop(type(ref_sec).__name__, {}), f.name
    assert not left


@pytest.mark.parametrize("path,value", [
    (("estimator", "solver_dtype"), "float64"),
    (("parallel", "mesh_shape"), [4]),
    (("tracker", "upload_workers"), 0),
    (("local_mapping", "knn_surf"), 5),
    (("lidar", "max_points"), 65536)])
def test_non_default_left_out_field_raises(path, value):
    d = jconfig.SystemConfig().to_dict()
    d[path[0]][path[1]] = value
    with pytest.raises(KeyError, match=path[1]):
        tconfig.SystemConfig.from_dict(d)


def test_unknown_config_key_raises():
    d = tconfig.SystemConfig().to_dict()
    d["estimator"]["no_such_field"] = 1
    with pytest.raises(KeyError, match="EstimatorConfig.no_such_field"):
        tconfig.SystemConfig.from_dict(d)
    with pytest.raises(KeyError, match="no_such_section"):
        tconfig.SystemConfig.from_dict({"no_such_section": {}})
    d = tconfig.SystemConfig().to_dict()
    d["parallel"] = {"mesh_shape": [1], "no_such_key": 1}
    with pytest.raises(KeyError, match="parallel.no_such_key"):
        tconfig.SystemConfig.from_dict(d)


def test_viz_plots_without_importing_matplotlib_at_import(tmp_path):
    code = ("import sys, mvil_fusion_torch.utils.viz, "
            "mvil_fusion_torch.run; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
    from mvil_fusion_torch.utils import viz
    rng = np.random.default_rng(4)
    rows = [(0.1 * k, rng.normal(size=3), np.asarray([1.0, 0, 0, 0]))
            for k in range(20)]
    viz.plot_trajectories(str(tmp_path / "traj.png"), {"frontend": rows},
                          gt=rows, modes=[(0.0, 0.0, 2), (1.0, 1.0, 3)])
    viz.plot_map(str(tmp_path / "map.png"), rng.normal(size=(500, 3)),
                 traj=rows)
    for name in ("traj.png", "map.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
