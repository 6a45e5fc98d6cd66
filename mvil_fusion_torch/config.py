"""Configuration of the port's stages.

Counterpart of ``mvil_fusion_tpu/config.py``: the same frozen dataclasses,
sections and defaults (the reference's ``config/mynteye_leishen_indoor.yaml``),
holding only the sections and fields that the ported stages read.  A later
slice adds the fields it reads, with the reference's defaults; a test holds
every field here to the reference's value.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CameraConfig:
    """Camera intrinsics (reference: camera_model CameraFactory.cc; pinhole
    defaults reproduce config/mynteye_leishen_indoor.yaml:8-22).

    `model` selects pinhole (radtan: k1,k2,p1,p2), mei (adds xi),
    equidistant (Kannala-Brandt: k2..k5), or scaramuzza (poly + affine
    c,d,e): all four camodocal models the reference vendors."""

    model: str = "pinhole"
    width: int = 640
    height: int = 480
    fx: float = 356.37000498
    fy: float = 354.92225534
    cx: float = 326.87903275
    cy: float = 250.93806883
    k1: float = -0.29326213
    k2: float = 0.07505211
    p1: float = 0.0002761
    p2: float = -0.00026777
    fisheye: bool = False
    # MEI (CataCamera) mirror parameter
    xi: float = 1.0
    # equidistant (Kannala-Brandt) higher-order terms (k2 shared above)
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    # Scaramuzza polynomial z = Σ poly[k]·ρ^k and affine [c d; e 1]
    poly: Tuple[float, ...] = (-200.0, 0.0, 0.001)
    aff_c: float = 1.0
    aff_d: float = 0.0
    aff_e: float = 0.0

    @property
    def intrinsics(self) -> Tuple[float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy)

    @property
    def distortion(self) -> Tuple[float, float, float, float]:
        return (self.k1, self.k2, self.p1, self.p2)


@dataclass(frozen=True)
class TrackerConfig:
    """KLT feature-tracker front end (reference: feature_tracker_/src/
    parameters.h:60-92, yaml:67-73)."""

    max_cnt: int = 150           # max tracked features
    min_dist: int = 30           # min pixel distance between features
    freq: int = 10               # publish rate Hz (0 = image rate)
    f_threshold: float = 1.0     # fundamental RANSAC threshold (px)
    equalize: bool = True        # CLAHE on input image
    window_size: int = 21        # LK patch size
    pyramid_levels: int = 3      # LK pyramid levels
    max_iters: int = 10          # LK iterations per level
    min_eig_threshold: float = 1e-4
    ransac_iters: int = 256      # fundamental-matrix hypotheses (batched)
    # static padded capacity for feature slots on device (>= max_cnt)
    max_features_pad: int = 256


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise model (reference yaml:80-87)."""

    acc_n: float = 0.02065
    gyr_n: float = 0.00519
    acc_w: float = 0.00667
    gyr_w: float = 0.00088056
    g_norm: float = 9.795
    rate_hz: float = 200.0
    # static padded capacity of IMU samples per image interval
    max_imu_per_frame: int = 64


@dataclass(frozen=True)
class EstimatorConfig:
    """Sliding-window VIO core (reference: vils_estimator/src/parameters.h:12-15,
    yaml:24-45,75-77,89-118).  The JAX package's `angle_vi`,
    `max_obs_per_feature`, `keyframe_parallax_px`, `dtype` and
    `solver_dtype` are left out: neither package reads them, and the port
    solves in fp32 throughout."""

    window_size: int = 6          # +1 = frames in window (reference WINDOW_SIZE)
    focal_length: float = 460.0   # virtual focal for info weighting
    min_parallax: float = 10.0    # keyframe threshold px (/focal at use site)
    max_solver_iters: int = 8     # LM iterations per solve
    # per-frame solver wall-clock budget (reference: ceres
    # max_solver_time_in_seconds = 0.05, estimator.cpp:1400-1414); a solve
    # that overruns it runs the next frame at min_solver_iters.  <=0
    # disables adaptation.
    solver_time_budget_s: float = 0.05
    min_solver_iters: int = 4
    estimate_extrinsic: int = 1   # 0 fixed / 1 refine / 2 calibrate
    estimate_td: bool = True
    td_init: float = 0.00003
    # camera-IMU extrinsic initial guess (row-major R, t) — imu^T_cam
    ric: Tuple[float, ...] = (
        0.99999072, -0.00209387, -0.00376471,
        -0.00208308, -0.99999371, 0.0028693,
        -0.0037707, -0.00286143, -0.9999888,
    )
    tic: Tuple[float, ...] = (-0.04571386, 0.01268073, -0.01535602)
    # initialization bounds (reference yaml:90-101 PBC_* box)
    pbc_upper: Tuple[float, ...] = (-0.04, 0.01, 0.01)
    pbc_lower: Tuple[float, ...] = (-0.06, -0.01, -0.01)
    # feature capacity inside the window (static shape)
    max_features: int = 256       # padded landmark slots (ref NUM_OF_F=1000)
    # failure detection thresholds (reference estimator.cpp:1076-1122)
    fail_ba_norm: float = 2.5
    fail_bg_norm: float = 1.0
    fail_trans_jump: float = 10.0
    fail_z_jump: float = 1.0


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
    camera: CameraConfig = field(default_factory=CameraConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)
    lidar: LidarConfig = field(default_factory=LidarConfig)
    local_mapping: LocalMappingConfig = field(
        default_factory=LocalMappingConfig)
    global_mapping: GlobalMappingConfig = field(
        default_factory=GlobalMappingConfig)
