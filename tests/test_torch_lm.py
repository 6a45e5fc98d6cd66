"""The port's projected LM (``mvil_fusion_torch/ops/lm.py``) against the
JAX package's ``ops/lm.py::lm_solve`` on the same numpy inputs.

Tolerances: x within 1e-5 and the same number of accepted steps on a
bounded and an unbounded curve fit; cost0 and cost within 1e-5 relative.
On a system whose damped normal matrix is not positive definite both
packages reject every step and leave x where it started (JAX through the
NaN of its failed factor, the port through ``cholesky_ex``'s info).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvil_fusion_tpu.ops import lm as jlm
from mvil_fusion_torch.ops import lm as tlm
from torch_threads import one_thread_and_warm_sqrt  # noqa: F401


def _curve(rng, n=40):
    t = np.linspace(0.0, 2.0, n).astype(np.float32)
    y = (1.5 * np.exp(-0.8 * t) + 0.3 * t
         + rng.normal(scale=0.01, size=n)).astype(np.float32)
    return t, y


def _fit(xp, exp, t, y):
    t, y = xp.asarray(t), xp.asarray(y)

    def residual(x):
        return x[0] * exp(-x[1] * t) + x[2] * t - y
    return residual


@pytest.mark.parametrize("bounded", [False, True])
def test_lm_solve_matches_reference(bounded):
    rng = np.random.default_rng(0)
    t, y = _curve(rng)
    # from far off, so that every accepted step lowers the cost well above
    # fp32's rounding (near the minimum, acceptance is a coin toss)
    x0 = np.array([1.0, 0.5, 0.1] if bounded else [0.5, 2.5, 0.0],
                  np.float32)
    lo = np.array([0.0, 0.0, 0.0], np.float32)
    hi = np.array([1.25, 2.0, 1.0], np.float32)   # caps x[0] below 1.5
    kw_j = dict(lower=jnp.asarray(lo), upper=jnp.asarray(hi)) \
        if bounded else {}
    kw_t = dict(lower=torch.as_tensor(lo), upper=torch.as_tensor(hi)) \
        if bounded else {}
    rj = jlm.lm_solve(_fit(jnp, jnp.exp, t, y), jnp.asarray(x0),
                      iters=12, **kw_j)
    rt = tlm.lm_solve(_fit(torch, torch.exp, *map(
        torch.as_tensor, (t, y))), torch.as_tensor(x0), iters=12, **kw_t)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-5)
    assert int(rt.n_accepted) == int(rj.n_accepted) > 3
    for a, b in ((rt.cost0, rj.cost0), (rt.cost, rj.cost)):
        assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    if bounded:
        assert float(rt.x[0]) == float(np.float32(1.25))
    else:
        assert float(rt.cost) < 1e-2 * float(rt.cost0)


def test_lm_rejects_a_step_whose_system_is_not_positive_definite():
    """A negative jitter makes the damped normal matrix indefinite: JAX's
    factor is NaN, the port's a finite partial factor whose step would
    lower the cost; both must keep x."""
    x0 = np.zeros(2, np.float32)

    def res(xp):
        c = xp.asarray(np.array([1.0, 2.0], np.float32))
        s = xp.asarray(np.array([1.0, 0.1], np.float32))
        return lambda x: s * (x - c)
    rj = jlm.lm_solve(res(jnp), jnp.asarray(x0), iters=3, jitter=-0.05)
    rt = tlm.lm_solve(res(torch), torch.as_tensor(x0), iters=3,
                      jitter=-0.05)
    assert int(rj.n_accepted) == 0 and int(rt.n_accepted) == 0
    np.testing.assert_array_equal(np.asarray(rj.x), x0)
    np.testing.assert_array_equal(rt.x.numpy(), x0)
    assert float(rt.cost) == float(rt.cost0) == float(rj.cost)
