"""LOAM scan-to-map registration: edge (point-to-line) and plane
(point-to-plane) correspondences + Gauss-Newton on SE(3).

Counterpart of ``mvil_fusion_tpu/ops/loam_icp.py``.  k-NN runs through
``ops/knn_topk.py`` (the CUDA kernel on the card); line fits are closed-form
sym3 eigen decompositions, plane fits a closed-form 3×3 adjugate solve; the
outer (re-associate) × inner (Gauss-Newton) iterations are Python loops.
Nothing here reads a tensor back to the host, so a sweep's work queues on
the device without a sync.  ``ScanToMapGraphs`` replays a card's call as
CUDA graphs between its k-NN calls, which stay eager.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from mvil_fusion_torch.ops.knn_topk import knn_topk
from mvil_fusion_torch.ops.voxel import sym3_eigvals, sym3_eigvec
from mvil_fusion_torch.utils import lie

# neighbours of an edge's line fit, of a plane fit, and found for the
# reflectivity-similar choice of a plane's neighbours
K_EDGE, K_SURF, K_SURF_KNN = 5, 5, 10


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3×3 solve via the adjugate (closed form; the plane gates
    downstream are sensitive to the solve's rounding, so this keeps the
    reference's exact arithmetic)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = (A[..., 0, 0] * c00 + A[..., 0, 1] * c10 + A[..., 0, 2] * c20)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, float("inf"), det)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def knn(query: torch.Tensor, ref: torch.Tensor, ref_mask: torch.Tensor,
        k: int):
    """Brute-force k-NN: (Nq,3) vs (Nr,3) → (idx (Nq,k), d2 (Nq,k)).  The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    return knn_topk(query.contiguous(), ref.contiguous(),
                    ref_mask.contiguous(), k)


class Correspondences(NamedTuple):
    """Precomputed geometric targets for one GN stage."""

    edge_pt: torch.Tensor      # (Ne,3) source corner points (sensor frame)
    edge_a: torch.Tensor       # (Ne,3) line point A (world)
    edge_b: torch.Tensor       # (Ne,3) line point B (world)
    edge_ok: torch.Tensor      # (Ne,)
    plane_pt: torch.Tensor     # (Np,3)
    plane_n: torch.Tensor      # (Np,3) unit normal (world)
    plane_d: torch.Tensor      # (Np,) plane offset: n·x + d = 0
    plane_ok: torch.Tensor     # (Np,)


def _move(src, p, q):
    """Points of the sensor frame at pose (p, q), in the world frame."""
    return lie.quat_rotate(q[None, :], src) + p[None, :]


def _knn_pair(cw, sw, corner_map, corner_map_mask, surf_map, surf_map_mask,
              k_edge: int, k_plane: int):
    """An association's two k-NN calls, edges first, each looked up as
    this module's ``knn`` when it is made."""
    return (knn(cw, corner_map, corner_map_mask, k_edge),
            knn(sw, surf_map, surf_map_mask, k_plane))


def _fit(corner_src, corner_mask, surf_src, surf_mask, corner_map, surf_map,
         edge_nn, plane_nn, max_corr_dist: float, k_edge: int, k_surf: int,
         surf_i=None, surf_map_i=None) -> Correspondences:
    """The lines and planes fitted to the k-NN's answers: `edge_nn` and
    `plane_nn` are (idx, d2) of the moved corner and surf points."""
    dtype = corner_src.dtype
    gate = max_corr_dist * max_corr_dist
    # device constants come from kernels, never from a host list: copying
    # one to a card would wait for the stream
    eye = torch.eye(3, dtype=dtype, device=corner_src.device)

    # ---- edges
    eidx, ed2 = edge_nn
    near_ok = ed2[:, -1] < gate
    nbr = corner_map[eidx.long()]                            # (Ne,k,3)
    ctr = torch.mean(nbr, dim=1, keepdim=True)
    dc = nbr - ctr
    cov = torch.einsum("nki,nkj->nij", dc, dc) / k_edge
    lam0, lam1, lam2 = sym3_eigvals(cov)                 # closed form
    dir_ = sym3_eigvec(cov, lam0, lam1, eye[0])    # main axis, else x
    line_like = lam2 > 3.0 * lam1
    a = ctr[:, 0, :] + 0.1 * dir_
    b = ctr[:, 0, :] - 0.1 * dir_
    edge_ok = corner_mask & near_ok & line_like & torch.isfinite(ed2[:, -1])

    # ---- planes
    if surf_i is not None and surf_map_i is not None:
        sidx10, sd2_10 = plane_nn
        sidx10 = sidx10.long()
        # distance gate on the k_surf-th nearest, then keep the k_surf most
        # intensity-similar neighbors for the fit
        snear = sd2_10[:, k_surf - 1] < gate
        di = torch.abs(surf_map_i[sidx10] - surf_i[:, None])     # (Np,10)
        di = torch.where(torch.isfinite(sd2_10), di, float("inf"))
        _, sel = torch.topk(-di, k_surf, dim=1)                  # (Np,k)
        sidx = torch.take_along_dim(sidx10, sel, dim=1)
        sd2 = torch.take_along_dim(sd2_10, sel, dim=1)
    else:
        sidx, sd2 = plane_nn
        sidx = sidx.long()
        snear = sd2[:, -1] < gate
    snbr = surf_map[sidx]                                    # (Np,k,3)
    # LSQ plane: N·x = -1 (A-LOAM formulation), trace-relative ridge for
    # f32 robustness on near-collinear clusters
    # Aᵀb with b = −1 is minus the neighbours' sum, and n·x below is summed
    # per row: elementwise forms, so that a query's fit does not depend on
    # how many others share its batch (the card's batched matrix-vector
    # product rounds by batch size: a shard of the queries then fitted
    # other planes than the whole did)
    AtA = torch.einsum("nki,nkj->nij", snbr, snbr)
    Atb = -torch.sum(snbr, dim=1)
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    ridge = (1e-5 * tr + 1e-6) * eye
    n_raw = _solve3x3(AtA + ridge, Atb)
    finite_n = torch.isfinite(n_raw).all(dim=-1)
    n_raw = torch.where(finite_n[:, None], n_raw, 1.0)
    norm = torch.linalg.vector_norm(n_raw, dim=-1, keepdim=True)
    n_unit = n_raw / norm.clamp_min(1e-9)
    d_plane = 1.0 / norm[..., 0].clamp_min(1e-9)
    d_plane = torch.where(torch.isfinite(d_plane), d_plane, 0.0)
    # fit validity: all neighbors within 0.2 of the plane AND the cluster is
    # genuinely planar, not a single scan-line
    dist_nb = torch.abs(torch.sum(snbr * n_unit[:, None, :], dim=-1)
                        + d_plane[:, None])
    plane_fit_ok = torch.all(dist_nb < 0.2, dim=1)
    sctr = torch.mean(snbr, dim=1, keepdim=True)
    sdc = snbr - sctr
    scov = torch.einsum("nki,nkj->nij", sdc, sdc) / k_surf
    slam0, slam1, _ = sym3_eigvals(scov)                 # closed form
    planar = slam1 > torch.clamp_min(10.0 * slam0, 1e-4)
    plane_ok = (surf_mask & snear & plane_fit_ok & planar & finite_n
                & torch.isfinite(sd2[:, -1]))

    return Correspondences(edge_pt=corner_src, edge_a=a, edge_b=b,
                           edge_ok=edge_ok, plane_pt=surf_src,
                           plane_n=n_unit, plane_d=d_plane,
                           plane_ok=plane_ok)


def find_correspondences(corner_src, corner_mask, surf_src, surf_mask,
                         corner_map, corner_map_mask, surf_map,
                         surf_map_mask, p, q,
                         max_corr_dist: float = 1.0,
                         k_edge: int = K_EDGE, k_surf: int = K_SURF,
                         surf_i=None, surf_map_i=None,
                         k_surf_knn: int = K_SURF_KNN
                         ) -> Correspondences:
    """Associate transformed source features with map lines/planes.

    Edges need the 5-NN cluster to be line-like (λ2 > 3λ1); planes need a
    consistent LSQ plane fit.  When surf intensities are given, the plane
    fit uses the `k_surf` most reflectivity-similar of the `k_surf_knn`
    nearest map points.
    """
    use_i = surf_i is not None and surf_map_i is not None
    edge_nn, plane_nn = _knn_pair(
        _move(corner_src, p, q), _move(surf_src, p, q), corner_map,
        corner_map_mask, surf_map, surf_map_mask, k_edge,
        k_surf_knn if use_i else k_surf)
    return _fit(corner_src, corner_mask, surf_src, surf_mask, corner_map,
                surf_map, edge_nn, plane_nn, max_corr_dist, k_edge, k_surf,
                surf_i, surf_map_i)


def _huber_w(a: torch.Tensor, huber_delta: float) -> torch.Tensor:
    return torch.where(a <= huber_delta, 1.0,
                       torch.sqrt(huber_delta / a.clamp_min(1e-12)))


def _residuals(corr: Correspondences, p, q, huber_delta: float = 0.1):
    """Per-correspondence residuals + Huber weights at pose (p,q).

    Edge residual is A-LOAM's smooth 3-vector cross/‖ab‖; plane residual is
    n·x + d.  Huber weights are IRLS weights: constants of the
    linearisation.
    """
    pe = lie.quat_rotate(q[None, :], corr.edge_pt) + p[None, :]
    ab = corr.edge_b - corr.edge_a
    pa = pe - corr.edge_a
    cross = torch.linalg.cross(pa, ab, dim=-1)
    r_edge3 = cross / torch.linalg.vector_norm(
        ab, dim=-1, keepdim=True).clamp_min(1e-9)            # (Ne,3)
    ps = lie.quat_rotate(q[None, :], corr.plane_pt) + p[None, :]
    r_plane = torch.einsum("ni,ni->n", ps, corr.plane_n) + corr.plane_d

    e_norm = torch.sqrt(torch.sum(r_edge3 * r_edge3, dim=-1) + 1e-12)
    we = _huber_w(e_norm, huber_delta) * corr.edge_ok.to(p.dtype)
    wp = _huber_w(torch.abs(r_plane), huber_delta) * \
        corr.plane_ok.to(p.dtype)
    return r_edge3, we, r_plane, wp


def _gn_system(corr: Correspondences, p, q):
    """Weighted residual r and its analytic jacobian J (rows: 3 per edge,
    then 1 per plane; columns: δθ then δp) at δ = 0 of the right
    perturbation (p + δp, q ⊗ exp(δθ)).

    d/dδθ R(q ⊗ exp(δθ)) x = −R [x]×, so a world point's jacobian is
    [−R[x]×, I]; the edge residual is (x_w − a) × ab / ‖ab‖, whose
    derivative in x_w is −[ab]× / ‖ab‖; the plane residual n·x_w + d has
    derivative nᵀ.  The Huber weights scale rows and are held constant."""
    re3, we, rp, wp = _residuals(corr, p, q)
    R = lie.quat_to_mat(q)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)

    def point_jac(x):                                 # (N,3,6)
        rot = -R[None] @ lie.skew(x)
        return torch.cat([rot, eye.expand(x.shape[0], 3, 3)], dim=-1)

    ab = corr.edge_b - corr.edge_a
    inv_ab = 1.0 / torch.linalg.vector_norm(ab, dim=-1).clamp_min(1e-9)
    dres = -lie.skew(ab) * inv_ab[:, None, None]      # (Ne,3,3)
    Je = (dres @ point_jac(corr.edge_pt)) * we[:, None, None]
    Jp = (corr.plane_n[:, None, :] @ point_jac(corr.plane_pt))[:, 0, :] \
        * wp[:, None]
    r = torch.cat([(re3 * we[:, None]).reshape(-1), rp * wp])
    J = torch.cat([Je.reshape(-1, 6), Jp], dim=0)
    return r, J


def _first(parts):
    """The reduction of one block: its own part."""
    return parts[0]


def _gn_step(corrs, p, q, reduce, eye6):
    """One Gauss-Newton step from (p, q) over every block's
    correspondences: their JᵀJ and −Jᵀr summed by `reduce`, one 6×6 solve
    on (p, q)'s device; returns the new (p, q)."""
    systems = []
    for corr in corrs:
        dev = corr.edge_pt.device
        systems.append(_gn_system(corr, p.to(dev), q.to(dev)))
    H = reduce([J.T @ J for _, J in systems]) + 1e-6 * eye6
    g = reduce([-J.T @ r for r, J in systems])
    # solve_ex: no error check, hence no host sync
    dx = torch.linalg.solve_ex(H, g)[0]
    q = lie.quat_boxplus(q, dx[0:3])
    p = p + dx[3:6]
    return p, q


def _diagnostics(assoc, reduce):
    """(n_edge, n_plane, mean_res) of the final association: `assoc` holds
    each block's (correspondences, p, q)."""
    n_edge, n_plane, res = [], [], []
    for corr, pb, qb in assoc:
        re3, we, rp, wp = _residuals(corr, pb, qb)
        n_edge.append(torch.sum(corr.edge_ok))
        n_plane.append(torch.sum(corr.plane_ok))
        res.append(torch.sum(torch.linalg.vector_norm(re3, dim=-1)
                             * corr.edge_ok)
                   + torch.sum(torch.abs(rp) * corr.plane_ok))
    n_edge, n_plane = reduce(n_edge), reduce(n_plane)
    mean_res = reduce(res) / torch.clamp_min(n_edge + n_plane, 1)
    return n_edge, n_plane, mean_res


def scan_to_map(corner_src, corner_mask, surf_src, surf_mask,
                corner_map, corner_map_mask, surf_map, surf_map_mask,
                p0, q0, outer_iters: int = 2, gn_iters: int = 4,
                max_corr_dist: float = 1.0,
                surf_i=None, surf_map_i=None):
    """Full LOAM scan-to-map alignment (outer: re-associate; inner: GN).

    Runs in fp32 (call utils.precision.set_fp32_policy on a CUDA card).
    Returns device tensors (p, q, n_edge, n_plane, mean_res); nothing is
    read back to the host.
    """
    block = (corner_src, corner_mask, surf_src, surf_mask, corner_map,
             corner_map_mask, surf_map, surf_map_mask, surf_i, surf_map_i)
    return scan_to_map_blocks([block], p0, q0, _first, outer_iters,
                              gn_iters, max_corr_dist)


def scan_to_map_blocks(blocks: Sequence[tuple], p0, q0,
                       reduce: Callable[[list], torch.Tensor],
                       outer_iters: int = 2, gn_iters: int = 4,
                       max_corr_dist: float = 1.0):
    """`scan_to_map` with the source features split into `blocks`, each a
    tuple of `scan_to_map`'s arguments before p0 — (corner_src,
    corner_mask, surf_src, surf_mask, corner_map, corner_map_mask,
    surf_map, surf_map_mask) — and then surf_i, surf_map_i (or None), on
    its own device, the maps whole in every block.  Each block associates
    and linearizes its own queries; its JᵀJ and −Jᵀr, and its counts and
    residual sums at the end, go through ``reduce(parts)``, which returns
    their sum on (p0, q0)'s device; the 6×6 solve runs once, there.  One
    block with ``reduce = parts[0]`` is `scan_to_map`;
    `parallel/sharded_loam.py` gives one block per shard and the mesh's
    sum."""
    dtype = blocks[0][0].dtype
    eye6 = torch.eye(6, dtype=dtype, device=p0.device)

    def associate(p, q):
        """Every block's correspondences at (p, q), and (p, q) on the
        block's device."""
        out = []
        for b in blocks:
            pb, qb = p.to(b[0].device), q.to(b[0].device)
            out.append((find_correspondences(
                *b[:8], pb, qb, max_corr_dist, surf_i=b[8],
                surf_map_i=b[9]), pb, qb))
        return out

    p, q = p0, q0
    for _ in range(outer_iters):
        corrs = [c for c, _, _ in associate(p, q)]
        for _ in range(gn_iters):
            p, q = _gn_step(corrs, p, q, reduce, eye6)
    return (p, q, *_diagnostics(associate(p, q), reduce))


def graphs_engage(n_blocks: int, on_cuda: bool, capturing: bool) -> bool:
    """Whether a scan-to-map call replays as CUDA graphs: one block of
    CUDA tensors on a stream that is not capturing already.  Several
    blocks (``parallel/sharded_loam.py``) sum across devices between
    launches and stay eager, as CPU tensors do; inside a caller's capture
    (``profile_slice.py`` captures a whole sweep) the launches go into the
    caller's graph."""
    return n_blocks == 1 and on_cuda and not capturing


def _eager(tensors, outer_iters, gn_iters, max_corr_dist, finish):
    """`ScanToMapGraphs`'s call without graphs."""
    block, (p0, q0), extra = tensors[:10], tensors[10:12], tensors[12:]
    out = scan_to_map_blocks([block], p0, q0, _first, outer_iters,
                             gn_iters, max_corr_dist)
    return finish(p0, q0, *out, *extra)


class _Segments:
    """One shape's static buffers and the bodies of its three graphs.

    (a) `start` moves the sources to the start pose; (b) `solve` fits the
    association, runs the Gauss-Newton iterations and moves the sources to
    the new pose; (c) `finish` fits the final association, reads the
    diagnostics and runs the caller's finish.  Between them `associate`
    makes the two k-NN calls eagerly and copies their answers in, so that
    ``knn`` is looked up, and the hand-written kernel launched, as in an
    eager call.  The bodies run the eager call's arithmetic in its order;
    `run` calls them, or their graphs' replays, in the call's order."""

    def __init__(self, tensors, outer_iters, gn_iters, max_corr_dist,
                 finish):
        self.inputs = [None if t is None else torch.empty_like(t)
                       for t in tensors]
        self.block = self.inputs[:10]
        self.p0, self.q0 = self.inputs[10:12]
        self.extra = self.inputs[12:]
        self.outer_iters, self.gn_iters = outer_iters, gn_iters
        self.max_corr_dist, self.finish_fn = max_corr_dist, finish
        cs, ss, si, smi = (self.block[i] for i in (0, 2, 8, 9))
        self.p, self.q = torch.empty_like(self.p0), torch.empty_like(self.q0)
        self.cw, self.sw = torch.empty_like(cs), torch.empty_like(ss)
        self.k_plane = K_SURF_KNN if si is not None and smi is not None \
            else K_SURF

        def answers(n, k):
            return (torch.empty((n, k), dtype=torch.int32, device=cs.device),
                    torch.empty((n, k), dtype=torch.float32,
                                device=cs.device))
        self.edge_nn = answers(cs.shape[0], K_EDGE)
        self.plane_nn = answers(ss.shape[0], self.k_plane)
        self.graphs: list = []
        self.out: tuple = ()

    def load(self, tensors) -> None:
        for dst, src in zip(self.inputs, tensors):
            if dst is not None:
                dst.copy_(src)

    def _move_sources(self) -> None:
        self.cw.copy_(_move(self.block[0], self.p, self.q))
        self.sw.copy_(_move(self.block[2], self.p, self.q))

    def _corr(self) -> Correspondences:
        b = self.block
        return _fit(b[0], b[1], b[2], b[3], b[4], b[6], self.edge_nn,
                    self.plane_nn, self.max_corr_dist, K_EDGE, K_SURF,
                    b[8], b[9])

    def start(self) -> None:
        self.p.copy_(self.p0)
        self.q.copy_(self.q0)
        self._move_sources()

    def associate(self) -> None:
        b = self.block
        edge_nn, plane_nn = _knn_pair(self.cw, self.sw, b[4], b[5], b[6],
                                      b[7], K_EDGE, self.k_plane)
        for dst, src in zip((*self.edge_nn, *self.plane_nn),
                            (*edge_nn, *plane_nn)):
            dst.copy_(src)

    def solve(self) -> None:
        corr = self._corr()
        eye6 = torch.eye(6, dtype=self.block[0].dtype, device=self.p.device)
        p, q = self.p, self.q
        for _ in range(self.gn_iters):
            p, q = _gn_step([corr], p, q, _first, eye6)
        self.p.copy_(p)
        self.q.copy_(q)
        self._move_sources()

    def finish(self) -> tuple:
        n_edge, n_plane, mean_res = _diagnostics(
            [(self._corr(), self.p, self.q)], _first)
        return self.finish_fn(self.p0, self.q0, self.p, self.q, n_edge,
                              n_plane, mean_res, *self.extra)

    def run(self, start, solve, finish):
        """(a), then each outer iteration's k-NN and (b), then the final
        k-NN and (c); returns what (c) returns."""
        start()
        for _ in range(self.outer_iters):
            self.associate()
            solve()
        self.associate()
        return finish()

    def capture(self) -> None:
        """Capture (a), (b) and (c) into a graph each, on a side stream of
        the current device; nothing runs."""
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            for body in (self.start, self.solve, self.finish):
                graph = torch.cuda.CUDAGraph()
                # thread_local: the pipeline's other stages go on launching
                # from their own threads meanwhile
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
                self.graphs.append(graph)
        self.out = out

    def replay(self, tensors) -> tuple:
        self.load(tensors)
        self.run(*(g.replay for g in self.graphs))
        return tuple(t.clone() for t in self.out)


class ScanToMapGraphs:
    """`scan_to_map` of one block, replayed as CUDA graphs between its six
    k-NN calls.

    A call that `graphs_engage` takes runs by its shape (the tensors'
    shapes, dtypes and device, the iteration counts, the gate, `finish`).
    A shape's first call runs eagerly, which sets up every library handle
    and workspace its launches need, and then captures the shape's three
    graphs (`_Segments`); its later calls copy their tensors into the
    shape's static buffers and replay, with the k-NN calls made eagerly in
    between.  Every other call runs eagerly, as do the calls of shapes
    beyond the first MAX_SHAPES.  A call returns the tensors of
    ``finish(p0, q0, p, q, n_edge, n_plane, mean_res, *finish_args)``, run
    on `scan_to_map`'s result (inside the last graph): its own tensors,
    never a graph's buffers."""

    MAX_SHAPES = 4

    def __init__(self):
        self.captures = 0   # calls that ran eagerly, then captured graphs
        self.replays = 0    # calls replayed from their shape's graphs
        self.eager = 0      # calls run eagerly alone
        self._segments: dict = {}
        self._stream = None     # the stream of the last replay

    def __call__(self, corner_src, corner_mask, surf_src, surf_mask,
                 corner_map, corner_map_mask, surf_map, surf_map_mask,
                 p0, q0, *, finish: Callable[..., tuple],
                 finish_args: tuple = (), outer_iters: int = 2,
                 gn_iters: int = 4, max_corr_dist: float = 1.0,
                 surf_i=None, surf_map_i=None) -> tuple:
        tensors = (corner_src, corner_mask, surf_src, surf_mask, corner_map,
                   corner_map_mask, surf_map, surf_map_mask, surf_i,
                   surf_map_i, p0, q0, *finish_args)
        args = (outer_iters, gn_iters, max_corr_dist, finish)
        on_cuda = corner_src.is_cuda
        capturing = on_cuda and torch.cuda.is_current_stream_capturing()
        if not graphs_engage(1, on_cuda, capturing):
            self.eager += 1
            return _eager(tensors, *args)
        key = (*args, *(None if t is None else (t.shape, t.dtype, t.device)
                        for t in tensors))
        seg = self._segments.get(key)
        if seg is None and len(self._segments) >= self.MAX_SHAPES:
            self.eager += 1
            return _eager(tensors, *args)
        with torch.cuda.device(corner_src.device):
            if seg is None:
                out = _eager(tensors, *args)
                seg = _Segments(tensors, *args)
                seg.capture()
                self._segments[key] = seg
                self.captures += 1
                return out
            stream = torch.cuda.current_stream()
            if self._stream is not None and self._stream != stream:
                # the last replay's stream may still read the buffers
                stream.wait_stream(self._stream)
            self._stream = stream
            out = seg.replay(tensors)
        self.replays += 1
        return out
