"""Batched pose-graph optimization.

Counterpart of ``mvil_fusion_tpu/mapping/pose_graph.py``, which replaces
the reference's GTSAM iSAM2 incremental smoother (reference:
lidar_mapping/src/globalMappingIkdTree.cpp:111-114, update calls :259-271)
with a full batched re-solve: SLAM pose graphs here are 10²-10³ nodes.

Factors: SE(3) between factors, z-altitude priors (the reference's
GPSFactor on z for floor handling, :216-228), and an anchor on node 0.
All tables are static-capacity with masks.

The edge↔node incidence is applied as gathers (``p[e_i]``) and
``index_add_``; the per-edge Jacobian is analytic.  Everything runs in
fp32 (``utils/precision.set_fp32_policy``: no TF32).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from mvil_fusion_torch.utils import lie
from mvil_fusion_torch.utils.device import resolve_device


class PoseGraph(NamedTuple):
    """Static-capacity graph storage."""

    p: torch.Tensor          # (N,3) node positions
    q: torch.Tensor          # (N,4) node orientations
    node_mask: torch.Tensor  # (N,)
    # between factors: T_i⁻¹ T_j ≈ (dp, dq)
    e_i: torch.Tensor        # (E,) int64
    e_j: torch.Tensor        # (E,)
    e_dp: torch.Tensor       # (E,3)
    e_dq: torch.Tensor       # (E,4)
    e_w: torch.Tensor        # (E,) sqrt-info scalar (isotropic)
    e_mask: torch.Tensor     # (E,)
    # z priors (GPS-z / floor factors)
    z_node: torch.Tensor     # (Z,) int64
    z_val: torch.Tensor      # (Z,)
    z_w: torch.Tensor        # (Z,)
    z_mask: torch.Tensor     # (Z,)


_INDEX_FIELDS = ("e_i", "e_j", "z_node")
_MASK_FIELDS = ("node_mask", "e_mask", "z_mask")


def empty_graph(n: int, e: int, z: int, dtype=torch.float32,
                device: torch.device | str | None = None) -> PoseGraph:
    """An empty graph of capacities (n, e, z) on `device`: None is the
    current CUDA device (a RuntimeError where there is no card)."""
    dev = resolve_device(device)
    ident = lie.quat_identity(dtype, dev)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return PoseGraph(
        p=zeros((n, 3)), q=ident.repeat(n, 1),
        node_mask=zeros((n,), torch.bool),
        e_i=zeros((e,), torch.int64), e_j=zeros((e,), torch.int64),
        e_dp=zeros((e, 3)), e_dq=ident.repeat(e, 1),
        e_w=zeros((e,)), e_mask=zeros((e,), torch.bool),
        z_node=zeros((z,), torch.int64), z_val=zeros((z,)),
        z_w=zeros((z,)), z_mask=zeros((z,), torch.bool))


def graph_from_numpy(arrays: Mapping[str, np.ndarray],
                     dtype=torch.float32,
                     device: torch.device | str | None = None) -> PoseGraph:
    """A PoseGraph from its 13 arrays given as numpy (e.g. the JAX
    package's graph), copied onto `device` (None: the current CUDA
    device)."""
    dev = resolve_device(device)
    out = {}
    for name in PoseGraph._fields:
        dt = (torch.int64 if name in _INDEX_FIELDS else
              torch.bool if name in _MASK_FIELDS else dtype)
        a = np.array(arrays[name], copy=True)
        out[name] = torch.as_tensor(a).to(device=dev, dtype=dt)
    return PoseGraph(**out)


def graph_to_numpy(g: PoseGraph) -> dict:
    """The graph's 13 arrays as numpy (index arrays as int32)."""
    return {name: (t.to(torch.int32) if name in _INDEX_FIELDS else t)
            .cpu().numpy() for name, t in zip(PoseGraph._fields, g)}


def _between_residual(p_i, q_i, p_j, q_j, dp, dq):
    """6-dim residual of T_i⁻¹ T_j vs the measured (dp, dq)."""
    dp_est, dq_est = lie.pose_between(p_i, q_i, p_j, q_j)
    r_p = dp_est - dp
    r_q = lie.quat_boxminus(dq_est, dq)
    return torch.cat([r_p, r_q], dim=-1)


def _so3_right_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """J_r⁻¹(φ) of SO(3): log(exp(φ) exp(ε)) ≈ φ + J_r⁻¹(φ) ε.
    I + ½[φ]× + c [φ]×², c = 1/θ² − cot(θ/2)/(2θ), by its series below
    θ = 0.05 where the closed form cancels."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    small = theta2 < 2.5e-3
    th = torch.sqrt(torch.where(small, 1.0, theta2))
    half = 0.5 * th
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / (th * th)
                    - torch.cos(half) / (2.0 * th * torch.sin(half)))
    K = lie.skew(phi)
    return (torch.eye(3, dtype=phi.dtype, device=phi.device)
            + 0.5 * K + c * (K @ K))


def edge_system(g: PoseGraph, p: torch.Tensor, q: torch.Tensor):
    """Masked, weighted per-edge residual (E,6) and its Jacobian (E,6,12)
    with respect to right perturbations [δp_i, δθ_i, δp_j, δθ_j] of the two
    end poses (p ← p + δp, q ← q ⊗ exp(δθ)), at zero."""
    p_i, q_i, p_j, q_j = p[g.e_i], q[g.e_i], p[g.e_j], q[g.e_j]
    r = _between_residual(p_i, q_i, p_j, q_j, g.e_dp, g.e_dq)
    u = r[:, 0:3] + g.e_dp                       # R_iᵀ (p_j − p_i)
    RiT = lie.quat_to_mat(q_i).transpose(-1, -2)
    q_ij = lie.quat_normalize(lie.quat_mul(lie.quat_conj(q_i), q_j))
    Jr_inv = _so3_right_jacobian_inv(r[:, 3:6])
    J = r.new_zeros((r.shape[0], 6, 12))
    J[:, 0:3, 0:3] = -RiT
    J[:, 0:3, 3:6] = lie.skew(u)
    J[:, 0:3, 6:9] = RiT
    J[:, 3:6, 3:6] = -(Jr_inv @ lie.quat_to_mat(q_ij).transpose(-1, -2))
    J[:, 3:6, 9:12] = Jr_inv
    wm = g.e_w * g.e_mask.to(r.dtype)
    return r * wm[:, None], J * wm[:, None, None]


def _z_residual(g: PoseGraph, p: torch.Tensor, zw: torch.Tensor):
    return (p[g.z_node, 2] - g.z_val) * zw


def _cost(r_e: torch.Tensor, r_z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.sum(r_e * r_e) + torch.sum(r_z * r_z))


def _lm_accept(mu, c0, c1):
    """LM bookkeeping of one step: whether the trial cost c1 fell below
    c0, and the damping for the next step."""
    ok = torch.isfinite(c1) & (c1 < c0)
    return ok, torch.where(ok, (mu * 0.3).clamp_min(1e-8),
                           (mu * 8.0).clamp_max(1e4))


def solve(g: PoseGraph, iters: int = 10, anchor_weight: float = 1e4,
          mu0: float = 1e-6, jitter: float = 1e-6) -> PoseGraph:
    """Levenberg-Marquardt over all (masked) nodes with a dense (6N,6N)
    Hessian and a Cholesky solve; returns the updated graph.  The 6×6
    blocks of JᵀJ are added straight into H.  No host sync."""
    N = g.p.shape[0]
    dtype, dev = g.p.dtype, g.p.device
    D = 6 * N
    zw = g.z_w * g.z_mask.to(dtype)
    a6 = torch.arange(6, device=dev)
    rows_i = 6 * g.e_i[:, None] + a6                # (E,6) rows of node i
    rows_j = 6 * g.e_j[:, None] + a6
    zsel = 6 * g.z_node + 2
    diag_extra = torch.repeat_interleave((~g.node_mask).to(dtype) * 1e6, 6)
    diag_extra[:6] += anchor_weight
    eye = torch.eye(D, dtype=dtype, device=dev)

    def add_blocks(H, rows_a, rows_b, Ja, Jb):
        flat = rows_a[:, :, None] * D + rows_b[:, None, :]       # (E,6,6)
        H.view(-1).index_add_(0, flat.reshape(-1),
                              (Ja.transpose(-1, -2) @ Jb).reshape(-1))

    def cost_of(p, q):
        return _cost(edge_system(g, p, q)[0], _z_residual(g, p, zw))

    p, q = g.p, g.q
    mu = torch.full((), mu0, dtype=dtype, device=dev)
    for _ in range(iters):
        r_e, J_e = edge_system(g, p, q)
        Ji, Jj = J_e[:, :, 0:6], J_e[:, :, 6:12]
        r_z = _z_residual(g, p, zw)
        H = torch.zeros((D, D), dtype=dtype, device=dev)
        add_blocks(H, rows_i, rows_i, Ji, Ji)
        add_blocks(H, rows_i, rows_j, Ji, Jj)
        add_blocks(H, rows_j, rows_i, Jj, Ji)
        add_blocks(H, rows_j, rows_j, Jj, Jj)
        b = torch.zeros((D,), dtype=dtype, device=dev)
        b.index_add_(0, rows_i.reshape(-1),
                     -(r_e[:, None, :] @ Ji).reshape(-1))
        b.index_add_(0, rows_j.reshape(-1),
                     -(r_e[:, None, :] @ Jj).reshape(-1))
        # z priors: r_z is weighted; its jacobian row is wz at the node's z
        hd = torch.zeros((D,), dtype=dtype, device=dev)
        hd.index_add_(0, zsel, zw * zw)
        b.index_add_(0, zsel, -(zw * r_z))
        H.diagonal().add_(hd + diag_extra)
        c0 = _cost(r_e, r_z)
        Hd = H + torch.diag(mu * H.diagonal() + jitter) + jitter * eye
        L, info = torch.linalg.cholesky_ex(Hd)
        dx = torch.cholesky_solve(b[:, None], L)[:, 0].reshape(N, 6)
        p_try = p + dx[:, 0:3]
        q_try = lie.quat_boxplus(q, dx[:, 3:6])
        # a failed factorization rejects the step (the trial is garbage)
        c1 = torch.where(info == 0, cost_of(p_try, q_try), torch.inf)
        ok, mu = _lm_accept(mu, c0, c1)
        p = torch.where(ok, p_try, p)
        q = torch.where(ok, q_try, q)
    return g._replace(p=p, q=lie.quat_normalize(q))


def solve_cg(g: PoseGraph, iters: int = 10, cg_iters: int = 64,
             anchor_weight: float = 1e4, mu0: float = 1e-6,
             jitter: float = 1e-6, cg_tol: float = 1e-12,
             xtol: float = 1e-8, check_every: int = 16,
             stats: Optional[dict] = None) -> PoseGraph:
    """Scalable LM: matrix-free block-Jacobi-preconditioned CG.

    H is never materialized: H·x is two gathers, one (E,6,12)·(E,12)
    contraction and two segment sums (``index_add_``), so memory is
    O(E·72 + N·36), linear in capacity, and the per-LM-step solve is up to
    `cg_iters` sparse matvecs preconditioned by the inverted per-node 6×6
    diagonal blocks (``torch.linalg.inv_ex``: no host-side check).

    Both loops stop early, as the reference's do: PCG once
    rz ≤ cg_tol·rz₀ (relative), LM once an accepted step moved no
    component by xtol.  The stopping rule is applied on the device: once a
    loop's condition fails its carry is frozen (masked updates), so the
    result is the early-stopped iterate however long the host goes on
    queueing iterations.  The host reads the two flags back once every
    `check_every` CG iterations, in one fetch, and leaves the loops when
    it sees them down; `check_every=0` never reads and queues all
    iters × cg_iters iterations.  So a solve makes at most
    iters × ⌈cg_iters / check_every⌉ host syncs and the result does not
    depend on `check_every`.

    `stats`, if given, receives the host's counts for this solve: "syncs"
    (those reads) and "lm_queued", "cg_queued" (iterations queued; with
    `check_every=1` these are the iterations that changed the carry).
    """
    N = g.p.shape[0]
    dtype, dev = g.p.dtype, g.p.device
    zw = g.z_w * g.z_mask.to(dtype)
    zw2 = zw * zw
    diag_extra = ((~g.node_mask).to(dtype) * 1e6)[:, None]   # (N,1)
    diag_extra[0] += anchor_weight
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    syncs = lm_queued = cg_queued = 0

    def segment_sum(vi, vj):
        """Per-edge (E, ...) values of each endpoint summed per node."""
        out = vi.new_zeros((N,) + vi.shape[1:])
        return out.index_add_(0, g.e_i, vi).index_add_(0, g.e_j, vj)

    def add_z(y, vz):
        """Add per-prior values (Z,) into the z component of (N,6) y."""
        y[:, 2] += vz.new_zeros((N,)).index_add_(0, g.z_node, vz)
        return y

    def cost_of(p, q):
        return _cost(edge_system(g, p, q)[0], _z_residual(g, p, zw))

    p, q = g.p, g.q
    mu = torch.full((), mu0, dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    stop = False
    for _ in range(iters):
        r_e, J_e = edge_system(g, p, q)
        Ji, Jj = J_e[:, :, 0:6], J_e[:, :, 6:12]
        JT = J_e.transpose(-1, -2)                           # (E,12,6)
        r_z = _z_residual(g, p, zw)

        # rhs b = −Jᵀr, summed per node (N,6)
        Jtr = (JT @ r_e[:, :, None])[:, :, 0]                # (E,12)
        b = add_z(-segment_sum(Jtr[:, 0:6], Jtr[:, 6:12]), -(zw * r_z))

        # block diagonal of H (N,6,6) for damping + preconditioner
        Dblk = segment_sum(Ji.transpose(-1, -2) @ Ji,
                           Jj.transpose(-1, -2) @ Jj)
        Dblk[:, 2, 2] += zw.new_zeros((N,)).index_add_(0, g.z_node, zw2)
        dh = torch.diagonal(Dblk, dim1=-2, dim2=-1)          # diag of H
        damp = mu * dh + jitter + diag_extra                 # (N,6)
        Minv = torch.linalg.inv_ex(
            Dblk + torch.diag_embed(damp) + 1e-8 * eye6).inverse

        def matvec(x):                                       # x (N,6)
            xe = torch.cat([x[g.e_i], x[g.e_j]], dim=-1)     # (E,12)
            t = J_e @ xe[:, :, None]                         # (E,6,1)
            y12 = (JT @ t)[:, :, 0]                          # (E,12)
            y = segment_sum(y12[:, 0:6], y12[:, 6:12])
            return add_z(y, zw2 * x[g.z_node, 2]) + damp * x

        def pc(v):
            return (Minv @ v[:, :, None])[:, :, 0]

        # preconditioned CG from x = 0, so r₀ = b
        x = torch.zeros((N, 6), dtype=dtype, device=dev)
        r = b
        z_ = pc(r)
        pdir = z_
        rz0 = torch.sum(r * z_)
        rz = rz0
        rz_stop = cg_tol * rz0
        live = ~conv
        for k in range(cg_iters):
            active = (rz > rz_stop) & live
            if check_every and k % check_every == 0:
                syncs += 1
                cg_on, lm_done = torch.stack([active, conv]).tolist()
                if lm_done:
                    stop = True
                if not cg_on:
                    break
            Ap = matvec(pdir)
            alpha = rz / torch.sum(pdir * Ap).clamp_min(1e-30)
            x = torch.where(active, x + alpha * pdir, x)
            r = r - alpha * Ap
            z_ = pc(r)
            rz_new = torch.sum(r * z_)
            pdir = z_ + (rz_new / rz.clamp_min(1e-30)) * pdir
            rz = torch.where(active, rz_new, rz)
            cg_queued += 1
        if stop:
            break
        lm_queued += 1

        c0 = _cost(r_e, r_z)
        p_try = p + x[:, 0:3]
        q_try = lie.quat_boxplus(q, x[:, 3:6])
        ok, mu_new = _lm_accept(mu, c0, cost_of(p_try, q_try))
        p = torch.where(ok & live, p_try, p)
        q = torch.where(ok & live, q_try, q)
        mu = torch.where(live, mu_new, mu)
        # LM convergence: an accepted step that barely moved the state
        conv = conv | (ok & (x.abs().max() < xtol))
    if stats is not None:
        stats.update(syncs=syncs, lm_queued=lm_queued, cg_queued=cg_queued)
    return g._replace(p=p, q=lie.quat_normalize(q))
