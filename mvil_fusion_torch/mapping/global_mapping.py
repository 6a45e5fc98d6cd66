"""Global mapping back end: keyed submaps, pose graph, loop closure.

Counterpart of ``mvil_fusion_tpu/mapping/global_mapping.py`` (the
reference's `global_ikdtree` node, lidar_mapping/src/
globalMappingIkdTree.cpp): incremental localization by odometry-delta
composition (:179-182), scan-to-map registration against a reference cloud
of nearby keyed scans (:241-271, here a Gaussian-voxel map + VGICP), GPS-z
floor priors (:216-228), radius loop closure (:300-312, 434-510) and
ScanContext loop proposals (:338-394) verified by registration, all fused
by a batched pose-graph re-solve (mapping/pose_graph.py).  Keyed scans +
corrected poses are the persistent map (the reference's Backend.txt /
Map.pcd).

Where the state lives.  The graph, the ScanContext store and the keyed
scans live on the mapper's ``device``; a host mirror of the node poses
serves everything the host bookkeeping reads (prediction chaining, radius
loops, ``trajectory()``) without waiting for the device.  Host values go
up without blocking, and the host reads back once per decision: one
registration result (``add_submap`` from the second submap on and each
loop verification), one set of ScanContext candidates, and all node poses
after a re-solve.  ``solve_cg`` reads its stopping flags besides (see
there).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from mvil_fusion_torch.config import SystemConfig
from mvil_fusion_torch.mapping import pose_graph as pg
from mvil_fusion_torch.mapping.local_mapping import Submap
from mvil_fusion_torch.ops import scancontext as sc, vgicp, voxel
from mvil_fusion_torch.utils import nplie
from mvil_fusion_torch.utils.device import resolve_device
from mvil_fusion_torch.utils.precision import set_fp32_policy

N_MAX = 512
E_MAX = 2048
Z_MAX = 512
SCAN_CAP = 8192          # per keyed scan point capacity (padded)

# hash sizes: they decide collisions, and so results
REF_TABLE = 1 << 17      # reference map of up to 5 keyed scans
SCAN_TABLE = 1 << 15     # source map and downsample of one keyed scan
REG_POINTS = 4096        # registration points after the downsample

# state that load_reference_state takes besides the 13 PoseGraph arrays:
# arrays, host lists, host counters
STATE_ARRAYS = ("scans", "scan_masks", "sc_desc", "sc_keys", "p_host",
                "q_host")
STATE_LISTS = ("times", "floor_ids", "loop_pairs", "last_odom")
STATE_COUNTERS = ("n_nodes", "n_edges", "n_z", "loops_closed",
                  "_since_last_close", "evictions", "map_refreshes")

_IDENT = np.asarray([1, 0, 0, 0], np.float32)


class GlobalMapper:
    def __init__(self, cfg: SystemConfig,
                 device: torch.device | str | None = None):
        """`device` None is the current CUDA device (a RuntimeError where
        there is no card); a CPU caller passes ``device="cpu"``."""
        set_fp32_policy()
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        g = cfg.global_mapping
        # capacities: config fields override the module defaults (the CG
        # pose-graph solver is linear in capacity, so these are budget
        # knobs, not architectural walls)
        self.n_max = g.pg_n_max or N_MAX
        self.e_max = g.pg_e_max or E_MAX
        self.z_max = g.pg_z_max or Z_MAX
        self.graph = pg.empty_graph(self.n_max, self.e_max, self.z_max,
                                    device=dev)
        self.n_nodes = 0
        self.n_edges = 0
        self.n_z = 0
        f32 = torch.float32
        # body-frame keyed scans, padded to SCAN_CAP
        self.scans = torch.zeros((self.n_max, SCAN_CAP, 3), dtype=f32,
                                 device=dev)
        self.scan_masks = torch.zeros((self.n_max, SCAN_CAP),
                                      dtype=torch.bool, device=dev)
        self.times: list[float] = []
        self.floor_ids: list[int] = []
        self.last_odom: Optional[tuple] = None  # (p, q) at previous submap
        self.loops_closed = 0
        self.loop_pairs: list[tuple] = []
        self.sc_desc = torch.zeros(
            (self.n_max, g.sc_num_ring, g.sc_num_sector), dtype=f32,
            device=dev)
        self.sc_keys = torch.zeros((self.n_max, g.sc_num_ring), dtype=f32,
                                   device=dev)
        # host mirror of node poses, refreshed from the device graph only
        # after a solve
        self.p_host = np.zeros((self.n_max, 3), np.float32)
        self.q_host = np.tile(_IDENT, (self.n_max, 1))
        self._since_last_close = 10**9
        self.evictions = 0       # capacity evictions (each drops n_max//4)
        self.map_refreshes = 0   # z-jump-triggered re-solves (reference
        #                          globalMappingIkdTree.cpp:290-298)
        self.readbacks = 0       # device→host fetches made so far
        # the latest registration: dict(node, fitness, n_corr)
        self.last_registration: Optional[dict] = None

    # ------------------------------------------------------------- helpers

    def _up(self, x, dtype=torch.float32) -> torch.Tensor:
        """A host value onto the device without waiting for the stream."""
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=self.device, dtype=dtype, non_blocking=True)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One blocking device→host readback."""
        self.readbacks += 1
        return t.cpu().numpy()

    def load_reference_state(self, state: Mapping) -> None:
        """Take over a mapper state given as numpy arrays and host values
        (e.g. the JAX mapper's): the 13 PoseGraph arrays; the arrays of
        STATE_ARRAYS, `scans` (n_nodes, SCAN_CAP, 3) and `scan_masks`
        (n_nodes, SCAN_CAP) for the nodes in use, the others at capacity;
        the host lists of STATE_LISTS and the counters of STATE_COUNTERS."""
        n = int(state["n_nodes"])
        want = {name: tuple(t.shape)
                for name, t in zip(pg.PoseGraph._fields, self.graph)}
        want.update(scans=(n, SCAN_CAP, 3), scan_masks=(n, SCAN_CAP),
                    sc_desc=tuple(self.sc_desc.shape),
                    sc_keys=tuple(self.sc_keys.shape),
                    p_host=self.p_host.shape, q_host=self.q_host.shape)
        if not 0 <= n <= self.n_max:
            raise ValueError(f"n_nodes: {n}, capacity {self.n_max}")
        arrays = {}
        for name, shape in want.items():
            a = np.array(state[name], copy=True)
            if a.shape != shape:
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{shape}")
            arrays[name] = a
        self.graph = pg.graph_from_numpy(arrays, device=self.device)
        self.scans.zero_()
        self.scan_masks.zero_()
        self.scans[:n] = self._up(arrays["scans"])
        self.scan_masks[:n] = self._up(arrays["scan_masks"], torch.bool)
        self.sc_desc = self._up(arrays["sc_desc"])
        self.sc_keys = self._up(arrays["sc_keys"])
        self.p_host = arrays["p_host"].astype(np.float32)
        self.q_host = arrays["q_host"].astype(np.float32)
        self.times = [float(t) for t in state["times"]]
        self.floor_ids = [int(f) for f in state["floor_ids"]]
        odom = state["last_odom"]
        self.last_odom = None if odom is None else tuple(
            np.array(v, copy=True) for v in odom)
        self.loop_pairs = [(int(a), int(b)) for a, b in state["loop_pairs"]]
        for name in STATE_COUNTERS:
            setattr(self, name, int(state[name]))

    def _node_pose(self, i: int):
        return (self.p_host[i], self.q_host[i])

    def _refresh_host_poses(self):
        """One packed fetch of all node poses after a graph re-solve."""
        pq = self._fetch(torch.cat([self.graph.p, self.graph.q], dim=1))
        self.p_host = pq[:, :3].copy()
        self.q_host = pq[:, 3:7].copy()

    def _floor_id(self, z: float) -> int:
        fh = self.cfg.global_mapping.floor_height
        return int(np.floor((z + 0.5 * fh) / fh))

    def _store_scan(self, i: int, pts: np.ndarray) -> None:
        """Keyed scan i onto the device, cut or padded to SCAN_CAP."""
        n = min(len(pts), SCAN_CAP)
        self.scans[i, :n] = self._up(pts[:n])       # the slot holds zeros
        self.scan_masks[i] = torch.arange(SCAN_CAP, device=self.device) < n

    def _world_scans(self, nodes) -> tuple[torch.Tensor, torch.Tensor]:
        """The keyed scans of `nodes` (host ints) in the world frame, at
        the host mirror's poses: (len, SCAN_CAP, 3) points and their masks.
        The rotation matrices are formed on the host, as the trajectory's
        are."""
        Rp = np.stack([np.concatenate([
            nplie.quat_to_mat(self.q_host[i]).astype(np.float32).reshape(-1),
            self.p_host[i]]) for i in nodes])
        Rp = self._up(Rp)
        idx = self._up(np.asarray(nodes, np.int64), torch.int64)
        R = Rp[:, :9].reshape(-1, 3, 3)
        pts = self.scans[idx] @ R.transpose(1, 2) + Rp[:, None, 9:12]
        return pts, self.scan_masks[idx]

    def _build_reference(self, nodes) -> voxel.GaussianVoxelMap:
        pts, mask = self._world_scans(nodes)
        return voxel.build_gaussian_voxel_map(
            pts.reshape(-1, 3), mask.reshape(-1),
            self.cfg.lidar.vgicp_resolution, table_size=REF_TABLE)

    def _reference_map(self, center: np.ndarray):
        """Gaussian voxel map from the 5 nearest keyed scans (world frame,
        corrected poses) — the ikd-tree reference cloud analog."""
        n = self.n_nodes
        d = np.linalg.norm(self.p_host[:n] - center[None, :], axis=1)
        return self._build_reference(np.argsort(d)[: min(5, n)])

    def _register(self, i: int, ref_map, p0, q0):
        """Keyed scan i against the reference map from (p0, q0), with the
        result in one fetch: (p (3,), q (4,), fitness, n_corr)."""
        scan, scan_mask = self.scans[i], self.scan_masks[i]
        leaf = self.cfg.lidar.vgicp_resolution
        src_map = voxel.build_gaussian_voxel_map(scan, scan_mask, leaf,
                                                 table_size=SCAN_TABLE)
        reg = voxel.voxel_downsample(scan, scan_mask, leaf, REG_POINTS,
                                     table_size=SCAN_TABLE)
        res = vgicp.vgicp_align(
            reg.pts, reg.mask, ref_map, src_map, self._up(p0), self._up(q0),
            iters=self.cfg.lidar.vgicp_iters,
            max_corr_dist=self.cfg.lidar.max_corr_dist)
        # the count rides in the float pack as its int32 bits
        f32 = torch.float32
        hp = self._fetch(torch.cat([
            res.p.to(f32), res.q.to(f32), res.fitness.to(f32)[None],
            res.n_corr.to(torch.int32)[None].view(f32)]))
        fitness, n_corr = float(hp[7]), int(hp[8:9].view(np.int32)[0])
        self.last_registration = dict(node=i, fitness=fitness, n_corr=n_corr)
        return hp[0:3], hp[3:7], fitness, n_corr

    def _add_edge(self, i, j, dp, dq, w):
        e = self.n_edges
        if e >= self.e_max:
            return
        # (`t[e] = <number>` would wait for the device: the number goes
        # through a host tensor; `fill_` takes it as a kernel argument)
        g = self.graph
        g.e_i[e].fill_(i)
        g.e_j[e].fill_(j)
        g.e_dp[e] = self._up(dp)
        g.e_dq[e] = self._up(dq)
        g.e_w[e].fill_(float(w))
        g.e_mask[e].fill_(True)
        self.n_edges += 1

    def _evict_oldest(self, k: int):
        """Drop the k oldest keyed scans when the graph hits capacity
        (the reference's unbounded iSAM grows forever; here the bounded
        store evicts instead of asserting).  Node indices shift by -k;
        edges/priors touching evicted nodes are dropped.  Rare, so the
        graph makes a round trip through the host."""
        k = min(k, self.n_nodes)
        n = self.n_nodes
        self.evictions += 1
        self.readbacks += 1
        a = pg.graph_to_numpy(self.graph)
        for name, fill in (("p", 0.0), ("q", _IDENT), ("node_mask", False)):
            a[name][: n - k] = a[name][k:n].copy()
            a[name][n - k:] = fill

        keep = np.nonzero((a["e_i"] >= k) & (a["e_j"] >= k) & a["e_mask"])[0]
        ne = len(keep)
        a["e_i"][:ne], a["e_j"][:ne] = a["e_i"][keep] - k, a["e_j"][keep] - k
        for name in ("e_dp", "e_dq", "e_w"):
            a[name][:ne] = a[name][keep]
        a["e_mask"][:] = False
        a["e_mask"][:ne] = True

        zkeep = np.nonzero((a["z_node"] >= k) & a["z_mask"])[0]
        nz = len(zkeep)
        a["z_node"][:nz] = a["z_node"][zkeep] - k
        for name in ("z_val", "z_w"):
            a[name][:nz] = a[name][zkeep]
        a["z_mask"][:] = False
        a["z_mask"][:nz] = True

        self.graph = pg.graph_from_numpy(a, device=self.device)
        self.n_nodes, self.n_edges, self.n_z = n - k, ne, nz
        del self.times[:k], self.floor_ids[:k]
        # device stores + host pose mirror shift
        for store in (self.scans, self.scan_masks, self.sc_desc,
                      self.sc_keys):
            store[: n - k] = store[k:n].clone()
            store[n - k:] = 0
        self.p_host[: n - k] = self.p_host[k:n].copy()
        self.p_host[n - k:] = 0.0
        self.q_host[: n - k] = self.q_host[k:n].copy()
        self.q_host[n - k:] = _IDENT
        self.loop_pairs = [(a_ - k, b_ - k) for a_, b_ in self.loop_pairs
                           if a_ >= k and b_ >= k]

    def _solve(self):
        g = self.cfg.global_mapping
        stats = {}
        self.graph = pg.solve_cg(self.graph, iters=g.pg_iters,
                                 cg_iters=g.pg_cg_iters, stats=stats)
        self.readbacks += stats["syncs"]
        self._refresh_host_poses()

    # ------------------------------------------------------------- main API

    def add_submap(self, sm: Submap) -> dict:
        """Process one keyed submap; returns localization info (the
        /laser_localizer feedback for the estimator's LPS)."""
        g = self.cfg.global_mapping
        if self.n_nodes >= self.n_max:
            self._evict_oldest(self.n_max // 4)
        i = self.n_nodes
        self._store_scan(i, sm.pts)

        if i == 0:
            p_new = sm.p_w.astype(np.float32)
            q_new = sm.q_w.astype(np.float32)
        else:
            # predicted pose: previous corrected node ∘ incremental delta.
            # The delta MUST come from one consistent stream: the local
            # mapper's refined (map-frame) poses — the reference composes
            # /local_odom deltas the same way (globalMappingIkdTree.cpp
            # :179-182).  (Mixing the previous ODOMETRY pose with the
            # current MAP pose injects the full map-correction translation
            # into every edge once the VIO drifts.)
            p_prev, q_prev = self._node_pose(i - 1)
            dp, dq = nplie.pose_between(self.last_odom[0], self.last_odom[1],
                                        sm.p_w, sm.q_w)
            p_new, q_new = nplie.pose_compose(p_prev, q_prev, dp, dq)
            # refine against the reference map
            p_reg, q_reg, fitness, n_corr = self._register(
                i, self._reference_map(p_new), p_new, q_new)
            if fitness < g.max_tolerable_fitness and n_corr > 100:
                p_new, q_new = p_reg, q_reg

        # ---- add node (device graph + host mirror)
        self.graph.p[i] = self._up(p_new)
        self.graph.q[i] = self._up(q_new)
        self.graph.node_mask[i].fill_(True)
        self.p_host[i] = p_new
        self.q_host[i] = q_new
        self.times.append(sm.t)
        fid = self._floor_id(float(p_new[2]))
        self.floor_ids.append(fid)
        self.last_odom = (np.asarray(sm.p_w).copy(),
                          np.asarray(sm.q_w).copy())
        self.n_nodes += 1
        self._since_last_close += 1

        # ScanContext descriptor for every keyed scan (the reference's
        # makeAndSaveScancontextAndKeys on submap arrival :279-288) —
        # computed and stored on device, no fetch
        self._store_descriptor(i)

        # between factor to previous node (host mirror math)
        if i > 0:
            p_prev, q_prev = self._node_pose(i - 1)
            dp, dq = nplie.pose_between(p_prev, q_prev, p_new, q_new)
            self._add_edge(i - 1, i, dp, dq, 10.0)

        # GPS-z floor prior (variance 50 when near the floor plane, huge
        # otherwise — globalMappingIkdTree.cpp:216-228)
        fh = g.floor_height
        z_floor = fid * fh
        near_floor = abs(float(p_new[2]) - z_floor) < 0.25 * fh
        if self.n_z < self.z_max:
            gr, k = self.graph, self.n_z
            gr.z_node[k].fill_(i)
            gr.z_val[k].fill_(float(z_floor))
            gr.z_w[k].fill_((1.0 / np.sqrt(50.0)) if near_floor else 1e-3)
            gr.z_mask[k].fill_(True)
            self.n_z += 1

        # ---- loop closures
        closed = False
        if g.check_loop_closure and self._since_last_close >= \
                g.poses_before_reclosing:
            closed = self._try_radius_loop(i) or self._try_sc_loop(i)
        if closed:
            self.loops_closed += 1
            self._since_last_close = 0
            self._solve()
        elif i > 0 and abs(float(p_new[2])
                           - float(self.p_host[i - 1, 2])) \
                > g.z_refresh_jump:
            # z-jump (floor transition / drift): re-solve so the floor
            # priors engage and subsequent reference maps use corrected
            # poses — the analog of the reference's ikd-tree rebuild from
            # maximum-likelihood points (globalMappingIkdTree.cpp:290-298;
            # the reference map here is rebuilt from graph poses per
            # query, so re-solving *is* the map refresh)
            self._solve()
            self.map_refreshes += 1

        p_fin, q_fin = self._node_pose(i)
        return dict(node=i, p=p_fin, q=q_fin, t=sm.t, floor=fid,
                    closed_loop=closed)

    # ---------------------------------------------------------------- loops

    def _verify_loop(self, i: int, j: int) -> bool:
        """Register scan i against a map around node j; add edge on
        success."""
        g = self.cfg.global_mapping
        p_i, q_i = self._node_pose(i)
        p_j, q_j = self._node_pose(j)
        around = [k for k in (j - 1, j, j + 1)
                  if 0 <= k < self.n_nodes and k != i]
        if not around:
            return False
        ref = self._build_reference(around)
        p_new, q_new, fitness, n_corr = self._register(i, ref, p_i, q_i)
        if fitness > g.max_tolerable_fitness or n_corr < 100:
            return False
        # measured relative pose j→i from the registration result
        dp, dq = nplie.pose_between(p_j, q_j, p_new, q_new)
        self._add_edge(j, i, dp, dq, 20.0)
        self.loop_pairs.append((j, i))
        return True

    def _try_radius_loop(self, i: int) -> bool:
        """Proximity loop closure (same floor, skip recent)."""
        g = self.cfg.global_mapping
        lim = self.n_nodes - g.skip_recent_poses
        if lim <= 0:
            return False
        p_i = self.p_host[i]
        d = np.linalg.norm(self.p_host[:lim] - p_i[None, :], axis=1)
        same_floor = np.asarray(self.floor_ids[:lim]) == self.floor_ids[i]
        cand = np.nonzero((d < g.proximity_threshold) & same_floor)[0]
        if len(cand) == 0:
            return False
        j = int(cand[np.argmin(d[cand])])
        return self._verify_loop(i, j)

    def _try_sc_loop(self, i: int) -> bool:
        """ScanContext loop proposal (reference SC thread :338-394)."""
        g = self.cfg.global_mapping
        lim = self.n_nodes - g.sc_num_exclude_recent
        if lim <= 0:
            return False
        db_mask = np.zeros(self.n_max, bool)
        db_mask[:lim] = np.asarray(self.floor_ids[:lim]) == self.floor_ids[i]
        if not db_mask.any():
            return False
        # descriptors stay on device; ONE (2,K) fetch of (idx, dist)
        cands = sc.detect_loop(
            self.sc_desc[i], self.sc_keys[i], self.sc_desc, self.sc_keys,
            self._up(db_mask, torch.bool),
            n_candidates=g.sc_num_candidates)
        cand = self._fetch(torch.stack([cands.idx.to(torch.float32),
                                        cands.dist.to(torch.float32)]))
        dists = cand[1]
        best = int(np.argmin(dists))
        if not np.isfinite(dists[best]) or dists[best] > g.sc_dist_threshold:
            return False
        return self._verify_loop(i, int(cand[0, best]))

    # --------------------------------------------------------------- output

    def _store_descriptor(self, i: int) -> None:
        g = self.cfg.global_mapping
        desc = sc.make_descriptor(
            self.scans[i], self.scan_masks[i], n_ring=g.sc_num_ring,
            n_sector=g.sc_num_sector, max_radius=g.sc_max_radius)
        self.sc_desc[i] = desc
        self.sc_keys[i] = sc.ring_key(desc)

    def ensure_descriptor(self, i: int):
        """Recompute a missing descriptor (checkpoint-restore path)."""
        self.readbacks += 1
        if not bool(torch.any(self.sc_keys[i] != 0)):
            self._store_descriptor(i)

    def trajectory(self):
        """Corrected keyed poses — the Backend.txt content."""
        return [(self.times[i], self.p_host[i], self.q_host[i])
                for i in range(self.n_nodes)]

    def save_trajectory(self, path: str):
        """TUM-format trajectory (reference SerialPath2File)."""
        with open(path, "w") as f:
            for t, p, q in self.trajectory():
                f.write(f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    def global_map(self, leaf: float | None = None) -> np.ndarray:
        """Aggregated world-frame map cloud (the Map.pcd equivalent): the
        first 4·2¹⁷ points of the keyed scans, in node order, downsampled
        into at most 2¹⁷ voxel centroids."""
        if self.n_nodes == 0:
            return np.zeros((0, 3), np.float32)
        leaf = leaf or self.cfg.global_mapping.map_voxel_size
        cap = 1 << 17
        pts, mask = self._world_scans(range(self.n_nodes))
        pts, mask = pts.reshape(-1, 3), mask.reshape(-1)
        mask = mask & (torch.cumsum(mask, 0) <= 4 * cap)
        ds = voxel.voxel_downsample(pts, mask, leaf, cap)
        packed = self._fetch(torch.cat([ds.pts, ds.mask[:, None].to(
            ds.pts.dtype)], dim=1))
        return packed[packed[:, 3] > 0.5, :3]

    def mapping_stats(self) -> dict:
        """Mapping-health counters for the runner's JSON result (the
        reference surfaces these as RViz text markers,
        globalMappingIkdTree.cpp:860-884)."""
        return {
            "nodes": int(self.n_nodes),
            "edges": int(self.n_edges),
            "loops_closed": int(self.loops_closed),
            "map_refreshes": int(self.map_refreshes),
            "evictions": int(self.evictions),
        }
