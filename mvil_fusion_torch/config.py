"""Configuration of the port's stages.

Counterpart of ``mvil_fusion_tpu/config.py``: the same frozen dataclasses,
sections and defaults (the reference's ``config/mynteye_leishen_indoor.yaml``),
holding only the sections and fields that the ported stages read.  A later
slice adds the fields it reads, with the reference's defaults; a test holds
every field here to the reference's value.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class LidarConfig:
    """LiDAR front end and VGICP registration (reference yaml:120-140,
    lidar_compensator)."""

    scan_period: float = 0.1
    # infer sweep-start azimuth from scan history instead of assuming 0
    # (reference lidar_compensator infer_start_ori_ param)
    infer_start_ori: bool = False
    min_distance: float = 0.5
    max_distance: float = 70.0
    vgicp_resolution: float = 0.5
    max_corr_dist: float = 0.8
    vgicp_iters: int = 12


@dataclass(frozen=True)
class LocalMappingConfig:
    """LOAM scan-to-map local mapping (reference: lidar_mapping/src/
    localMapping.cpp, scanRegistration.cpp)."""

    corner_leaf: float = 0.2
    surf_leaf: float = 0.4
    outer_iters: int = 2
    gn_iters: int = 4
    submap_trigger_dist: float = 2.0
    submap_trigger_frames: int = 30
    # carry per-point reflectivity: diff_i feature mask + intensity-similar
    # surf selection (reference scanRegistration.cpp:575-614,
    # localMapping.cpp:697-709)
    use_intensity: bool = False
    # spatial-hash size for rolling-map re-voxelization (up to ~64k pts
    # through the surf insert; 2^17 keeps the load factor ≤0.5)
    downsample_table_size: int = 1 << 17
    map_crop_radius: float = 60.0


@dataclass(frozen=True)
class GlobalMappingConfig:
    """Pose-graph + loop closure back end (reference: lidar_mapping/src/
    globalMappingIkdTree.cpp, include/global_mapping/util.h:74-88,
    scancontext/Scancontext.h:82-97)."""

    check_loop_closure: bool = True
    translation_threshold: float = 1.0
    poses_before_reclosing: int = 10
    max_tolerable_fitness: float = 1.0
    proximity_threshold: float = 5.0
    skip_recent_poses: int = 10
    floor_height: float = 3.0
    # ScanContext
    sc_num_ring: int = 20
    sc_num_sector: int = 60
    sc_max_radius: float = 80.0
    sc_dist_threshold: float = 0.3
    sc_num_candidates: int = 10
    sc_num_exclude_recent: int = 30
    # pose-graph solver
    pg_max_poses: int = 1024
    pg_iters: int = 20
    map_voxel_size: float = 0.4
    map_capacity: int = 1 << 20
    # graph capacities (None -> module defaults 512/2048/512); the CG
    # solver (pose_graph.solve_cg) is linear in these, so they are budget
    # knobs rather than memory walls
    pg_n_max: Optional[int] = None
    pg_e_max: Optional[int] = None
    pg_z_max: Optional[int] = None
    # per-LM-step CG iterations of the matrix-free solve
    pg_cg_iters: int = 64
    # consecutive-node z change that triggers a graph re-solve (the
    # reference's ikd-tree rebuild on floor transitions,
    # globalMappingIkdTree.cpp:290-298)
    z_refresh_jump: float = 0.5


@dataclass(frozen=True)
class SystemConfig:
    lidar: LidarConfig = field(default_factory=LidarConfig)
    local_mapping: LocalMappingConfig = field(
        default_factory=LocalMappingConfig)
    global_mapping: GlobalMappingConfig = field(
        default_factory=GlobalMappingConfig)
