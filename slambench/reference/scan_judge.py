"""The plain reference that judges published LiDAR-frame poses.

Plain PyTorch (float64 by default), written from the published
algorithms and from nothing of the program: the deskew of a rolling sweep
to its end by the slerp of its start and end poses (LOAM), a voxel-centroid
filter, plane normals by PCA over the ring grid's neighbourhoods, and
point-to-plane ICP
(Chen and Medioni; the plane rows of A-LOAM and GICP) solved by
Gauss-Newton with Huber weights to convergence.

A claimed pose pair is judged so: both sweeps are deskewed with the
claimed poses, the source sweep is aligned to the target sweep by ICP from
the claimed relative pose, and the gap is the RMS distance by which the
converged alignment moves the source points away from where the claimed
relative pose puts them.  A sound estimate moves them by the ICP's own
noise; a wrong one by its error.

Poses are (p (3,), q (4,) as w, x, y, z) of the LiDAR frame in the world.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------- SO(3)

def quat_to_mat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def quat_slerp(q0, q1, s):
    """Slerp from q0 (4,) to q1 (4,) at fractions s (N,) → (N,4)."""
    d = torch.dot(q0, q1)
    q1 = torch.where(d < 0, -q1, q1)
    d = d.abs().clamp(max=1.0)
    theta = torch.acos(d)
    s = s[:, None]
    if float(theta) < 1e-8:
        q = q0 * (1 - s) + q1 * s
    else:
        q = (torch.sin((1 - s) * theta) * q0
             + torch.sin(s * theta) * q1) / torch.sin(theta)
    return q / q.norm(dim=-1, keepdim=True)


def so3_exp(w):
    th = w.norm()
    K = torch.zeros((3, 3), dtype=w.dtype, device=w.device)
    K[0, 1], K[0, 2], K[1, 2] = -w[2], w[1], -w[0]
    K[1, 0], K[2, 0], K[2, 1] = w[2], -w[1], w[0]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + K
    return (eye + torch.sin(th) / th * K
            + (1 - torch.cos(th)) / (th * th) * (K @ K))


def relative(pa, qa, pb, qb):
    """(R, t) of frame a in frame b: x_b = R x_a + t."""
    Ra, Rb = quat_to_mat(qa), quat_to_mat(qb)
    return Rb.T @ Ra, Rb.T @ (pa - pb)


# ---------------------------------------------------------------- clouds

def deskew(pts, rel_time, period, p0, q0, p1, q1):
    """Points captured along a sweep (sensor frame at each capture time)
    into the sensor frame at the sweep's end: the pose at each point's
    time is the slerp / lerp of the start and end poses."""
    s = (rel_time / period).clamp(0.0, 1.0)
    q = quat_slerp(q0, q1, s)
    p = p0[None, :] * (1 - s[:, None]) + p1[None, :] * s[:, None]
    pw = torch.einsum("nij,nj->ni", quat_to_mat(q), pts) + p
    return (pw - p1[None, :]) @ quat_to_mat(q1)


def voxel_filter(pts, leaf):
    """Centroid of the points of each occupied voxel."""
    key = torch.floor(pts / leaf).to(torch.int64)
    _, inv = torch.unique(key, dim=0, return_inverse=True)
    n = int(inv.max()) + 1
    acc = torch.zeros((n, 3), dtype=pts.dtype, device=pts.device)
    acc.index_add_(0, inv, pts)
    cnt = torch.zeros((n,), dtype=pts.dtype, device=pts.device)
    cnt.index_add_(0, inv, torch.ones_like(pts[:, 0]))
    return acc / cnt[:, None]


def knn(query, ref, k, chunk=512):
    """(d2 (Nq,k), idx (Nq,k)) of the k nearest refs, exhaustively."""
    d2s, ids = [], []
    for i in range(0, query.shape[0], chunk):
        q = query[i:i + chunk]
        d2 = ((q[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
        v, j = torch.topk(d2, k, dim=1, largest=False)
        d2s.append(v)
        ids.append(j)
    return torch.cat(d2s), torch.cat(ids)


def grid_normals(grid, valid, rings=1, cols=2, flatness=0.05,
                 jump=0.5, plane_tol=0.05):
    """Normals of an organized sweep (R, A, 3): PCA of each point's
    (2·rings+1) × (2·cols+1) neighbourhood of rings and azimuth columns
    (LOAM's organized neighbourhood, across rings so that a ring's line of
    points does not hide its surface).  A point keeps its normal where the
    whole neighbourhood is valid, no neighbour's range differs from its
    own by more than `jump` of it, the smallest eigenvalue is below
    `flatness` of the middle one and no neighbour lies farther than
    `plane_tol` m from the fitted plane.  Returns the neighbourhoods'
    centroids (R,A,3) and normals (R,A,3), and ok (R,A)."""
    R, A, _ = grid.shape
    nb, ok = [], valid.clone()
    rng_ = grid.norm(dim=-1)
    for dr in range(-rings, rings + 1):
        for dc in range(-cols, cols + 1):
            g = torch.roll(grid, shifts=(dr, dc), dims=(0, 1))
            v = torch.roll(valid, shifts=(dr, dc), dims=(0, 1))
            r = torch.roll(rng_, shifts=(dr, dc), dims=(0, 1))
            ok &= v & ((r - rng_).abs() <= jump * rng_)
            nb.append(g)
    ok[:rings], ok[R - rings:] = False, False       # no wrap across rings
    nb = torch.stack(nb, 2)                          # (R, A, K, 3)
    mean = nb.mean(2)
    c = nb - mean[:, :, None, :]
    cov = c.transpose(2, 3) @ c / nb.shape[2]
    # batched 3x3 eigh on the host: cuSOLVER refuses batches this large
    ev, vec = torch.linalg.eigh(cov.to("cpu", torch.float64))
    ev, vec = ev.to(grid.device), vec.to(grid.device)
    n = vec[..., 0].to(grid.dtype)
    ok &= (ev[..., 0] < flatness * ev[..., 1].clamp_min(1e-12))
    ok &= (c * n[:, :, None, :]).sum(-1).abs().amax(-1) <= plane_tol
    return mean, n, ok


def icp(src, dst, dst_n, R, t, iters=30, max_dist=0.5, huber=0.05,
        tol=1e-7, min_eig=100.0):
    """Point-to-plane ICP of `src` onto (`dst`, `dst_n`) from (R, t):
    nearest neighbours within `max_dist`, one Gauss-Newton step with
    Huber weights per association, until the step is below `tol`.  A
    direction that the pairs do not determine (an eigenvalue of the
    normal matrix under `min_eig`, LOAM's degeneracy test) is not moved.
    Returns the converged (R, t) and the number of pairs it used."""
    dt = src.dtype
    n_pairs = 0
    for _ in range(iters):
        x = src @ R.T + t
        d2, j = knn(x, dst, 1)
        ok = d2[:, 0] < max_dist * max_dist
        x, y, n = x[ok], dst[j[ok, 0]], dst_n[j[ok, 0]]
        n_pairs = int(ok.sum())
        if n_pairs < 6:
            break
        r = ((x - y) * n).sum(-1)
        w = torch.where(r.abs() <= huber, torch.ones_like(r),
                        huber / r.abs().clamp_min(1e-12))
        J = torch.cat([torch.cross(x, n, dim=-1), n], dim=1)   # (M,6)
        H = (J * w[:, None]).T @ J
        g = (J * w[:, None]).T @ r
        ev, V = torch.linalg.eigh(H.to("cpu", torch.float64))
        inv = torch.where(ev >= min_eig, 1.0 / ev.clamp_min(1e-30), 0.0)
        delta = -(V @ (inv * (V.T @ g.to("cpu", torch.float64))))
        delta = delta.to(src.device, dt)
        dR = so3_exp(delta[:3])
        R, t = dR @ R, dR @ t + delta[3:]
        if float(delta.abs().max()) < tol:
            break
    return R, t, n_pairs


# ------------------------------------------------------------------ judge

class Judge:
    """Deskews, filters and aligns sweeps in one precision (float64 for
    the reference; a lower one for the control).  `sweep_fn(i)` gives
    sweep i as (pts (N,3), rel_time (N,), valid (N,)) numpy arrays in
    ring-major order of `n_rings` rings; `period` is the sweep's length
    in seconds.  The source of an alignment is voxel-filtered; the target
    keeps its ring grid for its normals."""

    def __init__(self, sweep_fn, period, n_rings, device,
                 dtype=torch.float64, leaf=0.25, min_overlap=0.3,
                 reaches=(3.0, 1.5, 0.5)):
        self.sweep_fn, self.period, self.n_rings = sweep_fn, period, n_rings
        self.device, self.dtype, self.leaf = device, dtype, leaf
        self.min_overlap, self.reaches = min_overlap, reaches

    def _t(self, x):
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    def deskewed(self, i, start, end):
        """Sweep i deskewed to its end with the poses (p, q) at its start
        and end: (points (N,3), valid (N,))."""
        pts, rel, valid = self.sweep_fn(i)
        d = deskew(self._t(pts), self._t(rel), self.period,
                   self._t(start[0]), self._t(start[1]), self._t(end[0]),
                   self._t(end[1]))
        return d, torch.as_tensor(valid, device=self.device)

    def source(self, i, start, end):
        d, v = self.deskewed(i, start, end)
        return voxel_filter(d[v], self.leaf)

    def target(self, i, start, end):
        """The planes of the target: the centroids and normals of the
        neighbourhoods that are flat."""
        d, v = self.deskewed(i, start, end)
        R = self.n_rings
        # a neighbourhood about as wide as the rings lie apart
        cols = max(2, d.shape[0] // R // 360)
        c, n, ok = grid_normals(d.reshape(R, -1, 3), v.reshape(R, -1),
                                cols=cols)
        return c[ok], n[ok]

    def gap(self, a, a_start, a_end, b, b_start, b_end):
        """The gap of the claimed relative pose of sweep a's end in sweep
        b's end, sweeps a and b deskewed with their claimed start and end
        poses: a dict of the RMS distance (m) by which the alignment
        moves sweep a's points, the angle (degrees) and the length (m) of
        its correction, and the share of sweep a's points it paired.  A
        claim under which fewer than `min_overlap` of them find a plane
        cannot be aligned from: its gap is infinite."""
        src = self.source(a, a_start, a_end)
        dst, dst_n = self.target(b, b_start, b_end)
        R0, t0 = relative(self._t(a_end[0]), self._t(a_end[1]),
                          self._t(b_end[0]), self._t(b_end[1]))
        R, t = R0, t0
        # coarse to fine, so that a claim a metre or two off is pulled
        # back by the planes across its error, not held by those along it
        for reach in self.reaches:
            R, t, n_pairs = icp(src, dst, dst_n, R, t, max_dist=reach)
        moved = src @ (R - R0).T + (t - t0)
        dR = (R @ R0.T).double()
        cos = ((dR.trace() - 1) / 2).clamp(-1.0, 1.0)
        overlap = n_pairs / len(src)
        inf = float("inf")
        return dict(rms_m=float(torch.sqrt((moved.double() ** 2).sum(-1)
                                           .mean()))
                    if overlap >= self.min_overlap else inf,
                    rot_deg=float(torch.rad2deg(torch.acos(cos))),
                    trans_m=float((t - t0).double().norm()),
                    overlap=overlap)

    def error(self, a, a_start, a_end, b_end, true_a, true_b):
        """How far the claimed relative pose of sweep a's end in sweep
        b's end puts sweep a's points from where the true relative pose
        puts them (RMS, m): the claim's error against the stream's truth,
        for the report."""
        src = self.source(a, a_start, a_end)
        R0, t0 = relative(self._t(a_end[0]), self._t(a_end[1]),
                          self._t(b_end[0]), self._t(b_end[1]))
        R1, t1 = relative(self._t(true_a[0]), self._t(true_a[1]),
                          self._t(true_b[0]), self._t(true_b[1]))
        moved = src @ (R1 - R0).T + (t1 - t0)
        return float(torch.sqrt((moved.double() ** 2).sum(-1).mean()))
