"""The port's own configuration and synthetic data against the JAX
package's: every field of ``mvil_fusion_torch.config`` holds the
reference's default, and the port's trajectory and sweep generators give
bit-identical output for the same arguments.  Also checks that
``chip_smoke.py`` imports nothing of JAX or of the JAX package."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

from mvil_fusion_tpu import config as jconfig
from mvil_fusion_tpu.io import synthetic as jsyn
from mvil_fusion_tpu.io import synthetic_lidar as jsl
from mvil_fusion_torch import config as tconfig
from mvil_fusion_torch.io import synthetic as tsyn
from mvil_fusion_torch.io import synthetic_lidar as tsl

TRAJ_ARGS = dict(duration=8.0, w_amp=(0.2, 0.15, 0.4),
                 w_freq=(0.2, 0.15, 0.25), p_amp=(1.5, 1.2, 0.3),
                 p_freq=(0.2, 0.25, 0.15), lin_vel=(0.5, 0.25, 0.0))


@pytest.fixture(scope="module")
def trajs():
    return jsyn.SyntheticTrajectory(**TRAJ_ARGS), \
        tsyn.SyntheticTrajectory(**TRAJ_ARGS)


@pytest.mark.parametrize("section", [f.name for f in
                                     dataclasses.fields(tconfig.SystemConfig)])
def test_config_defaults_match_reference(section):
    ours = getattr(tconfig.SystemConfig(), section)
    ref = getattr(jconfig.SystemConfig(), section)
    assert type(ours).__name__ == type(ref).__name__
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_trajectory_matches_reference(trajs):
    tj, tt = trajs
    for name in ("times", "p", "q", "w"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(tj, name))
    for t in (0.0, 0.8, 1.23, 4.9):
        for a, b in zip(tt.pose_at(t), tj.pose_at(t)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t0,n_azimuth", [(0.8, 480), (2.7, 900)])
def test_sweep_matches_reference(trajs, t0, n_azimuth):
    tj, tt = trajs
    sj = jsl.simulate_sweep(jsl.BoxWorld(), tj, t0, n_azimuth=n_azimuth)
    st = tsl.simulate_sweep(tsl.BoxWorld(), tt, t0, n_azimuth=n_azimuth)
    assert st.keys() == sj.keys()
    for key in sj:
        np.testing.assert_array_equal(st[key], sj[key], err_msg=key)
    assert st["mask"].sum() > 0.9 * st["mask"].size


def test_chip_smoke_imports_only_the_port():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "mvil_fusion_torch" in roots
    assert not roots & {"jax", "jaxlib", "mvil_fusion_tpu"}, roots
