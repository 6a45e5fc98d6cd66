"""Generic fixed-iteration Levenberg-Marquardt for small dense problems.

Counterpart of ``mvil_fusion_tpu/ops/lm.py``: the reference leans on Ceres
AutoDiff for its small solves (VI initialization stages, SfM BA); here a
residual function, its forward-AD Jacobian (``torch.func.jacfwd``) and
damped normal equations, a fixed trip count, and optional box bounds by
projected steps (the functional analog of Ceres'
SetParameterLowerBound/UpperBound in the reference's bounded init,
initial_aligment.cpp:221-484).

The loop is a Python loop whose accept flag, damping and accepted count
stay on the device: nothing in it waits for the device.  A Cholesky factor
that fails is NaN in JAX but a finite partial factor in PyTorch, so the
factor's `info` is part of the accept flag.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from mvil_fusion_torch.utils.precision import full_precision


class LMResult(NamedTuple):
    x: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor
    n_accepted: torch.Tensor


@full_precision
def lm_solve(residual_fn: Callable[[torch.Tensor], torch.Tensor],
             x0: torch.Tensor, iters: int = 20, mu0: float = 1e-3,
             lower: Optional[torch.Tensor] = None,
             upper: Optional[torch.Tensor] = None,
             jitter: float = 1e-9) -> LMResult:
    """Minimize ½‖r(x)‖² over flat vector x with optional box bounds.

    `residual_fn` must be traceable by ``torch.func.jacfwd`` (no in-place
    writes to its input, no ``.item()``).  `cost0` is the cost at the
    first iteration's start."""
    dtype, dev = x0.dtype, x0.device
    n = x0.shape[0]
    eye = torch.eye(n, dtype=dtype, device=dev)

    def clip(x):
        if lower is not None:
            x = torch.maximum(x, lower)
        if upper is not None:
            x = torch.minimum(x, upper)
        return x

    def cost_of(x):
        r = residual_fn(x)
        return 0.5 * torch.sum(r * r)

    def with_value(x):
        r = residual_fn(x)
        return r, r

    jac = torch.func.jacfwd(with_value, has_aux=True)
    x = clip(x0)
    mu = torch.full((), mu0, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=torch.int32, device=dev)
    cost0 = None
    for _ in range(iters):
        J, r = jac(x)
        H = J.T @ J
        g = -J.T @ r
        Hd = H + torch.diag(mu * torch.diagonal(H) + jitter)
        L, info = torch.linalg.cholesky_ex(Hd + jitter * eye)
        dx = torch.cholesky_solve(g[:, None], L)[:, 0]
        x_try = clip(x + dx)
        c0 = 0.5 * torch.sum(r * r)
        c1 = cost_of(x_try)
        ok = (info == 0) & torch.isfinite(c1) & (c1 < c0)
        x = torch.where(ok, x_try, x)
        mu = torch.where(ok, (mu * 0.4).clamp_min(1e-8),
                         (mu * 5.0).clamp_max(1e6))
        n_acc = n_acc + ok.to(torch.int32)
        if cost0 is None:
            cost0 = c0
    return LMResult(x=x, cost0=cost0, cost=cost_of(x), n_accepted=n_acc)
