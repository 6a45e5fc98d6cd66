"""Mono VIO of the port end to end on the CPU: ``tests/test_vio_e2e.py`` on
the port's ``VIOEstimator`` (initialization from scratch, sliding-window
tracking, ATE after a 4-DoF alignment), fed by ``chip_smoke.vio_sequence``,
the same stream as ``tests/test_vio_e2e.py::run_sequence``, and the
deferred readback held to the synchronous one.  The gates are those of
``tests/test_vio_e2e.py``; deferred mode must give the synchronous run's
results exactly (on the CPU both run the same operations in the same
order).
"""

import warnings

import numpy as np
import pytest

import chip_smoke
from mvil_fusion_torch.estimator.vio import VIOEstimator
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401

CFG = chip_smoke.sequence_config(max_features=128)


def run_sequence(t_end, defer=False, bias=True):
    """The port's estimator on the CPU over tests/test_vio_e2e.py's
    stream up to t_end: (estimator, frames)."""
    frames = chip_smoke.vio_sequence(
        chip_smoke.sequence_world(), CFG, t_end=t_end,
        **({} if bias else dict(ba=(0.0, 0.0, 0.0), bg=(0.0, 0.0, 0.0))))
    est = VIOEstimator(CFG, device="cpu")
    est.defer_readback = defer
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # a repeated stamp
        for f in frames:
            chip_smoke.feed(est, f)
    est.flush()
    return est, frames


@pytest.mark.slow
def test_vio_e2e_initializes_and_tracks():
    est, frames = run_sequence(5.0, bias=False)
    assert est.status == VIOEstimator.NON_LINEAR, "failed to initialize"
    assert est.failures == 0
    assert len(est.trajectory) > 30
    ate = chip_smoke.ate_4dof(est.trajectory, frames)
    assert ate < 0.3, f"ATE {ate:.3f} m"


def test_vio_e2e_with_bias():
    est, frames = run_sequence(4.5)
    assert est.status == VIOEstimator.NON_LINEAR
    ate = chip_smoke.ate_4dof(est.trajectory, frames)
    assert ate < 0.35, f"ATE {ate:.3f} m"
    # gyro bias should be roughly recovered by the window estimator
    np.testing.assert_allclose(est.state.bg[-1].numpy(), chip_smoke.SEQ_BG,
                               atol=0.015)


def test_deferred_readback_equals_sync():
    """Ten frames: initialization at the 7th, then four solves; deferred
    mode harvests each pack at the next frame (the last at flush)."""
    sync, _ = run_sequence(1.45)
    dfr, _ = run_sequence(1.45, defer=True)
    assert sync.status == dfr.status == VIOEstimator.NON_LINEAR
    assert len(sync.trajectory) == len(dfr.trajectory) == 4
    for a, b in zip(sync.trajectory, dfr.trajectory):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(sync.ex_results, dfr.ex_results):
        np.testing.assert_array_equal(a[1], b[1])
        assert a[5] == b[5]
    assert sync.slots == dfr.slots
    assert {f: t.inv_depth for f, t in sync.tracks.items()} == \
        {f: t.inv_depth for f, t in dfr.tracks.items()}
    assert sync.td_host == dfr.td_host
    np.testing.assert_array_equal(sync.bg_host, dfr.bg_host)
    for x, y in zip(sync.state, dfr.state):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert dfr.solve_info["harvests"] == 4
    assert dfr.solve_info["harvests_ready"] == 4     # nothing to wait for
