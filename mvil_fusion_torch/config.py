"""Configuration of the port's stages.

Counterpart of ``mvil_fusion_tpu/config.py``: the same frozen dataclasses,
sections and defaults (the reference's ``config/mynteye_leishen_indoor.yaml``),
holding only the sections and fields that the ported stages read.  A later
slice adds the fields it reads, with the reference's defaults; a test holds
every field here to the reference's value.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LidarConfig:
    """LiDAR front end (reference yaml:120-140, lidar_compensator)."""

    scan_period: float = 0.1
    # infer sweep-start azimuth from scan history instead of assuming 0
    # (reference lidar_compensator infer_start_ori_ param)
    infer_start_ori: bool = False
    min_distance: float = 0.5
    max_distance: float = 70.0


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
class SystemConfig:
    lidar: LidarConfig = field(default_factory=LidarConfig)
    local_mapping: LocalMappingConfig = field(
        default_factory=LocalMappingConfig)
