"""mvil_fusion_torch — the PyTorch/CUDA port of mvil_fusion_tpu.

Each module sits at the same relative path as its counterpart in
``mvil_fusion_tpu`` and is held to it by a parity test.  The package
imports neither JAX nor any module of ``mvil_fusion_tpu``: ``config`` and
the synthetic data generators in ``io`` are its own copies of the parts
it needs.
"""

__version__ = "0.1.0"

from mvil_fusion_torch.config import (  # noqa: F401,E402
    DEFAULT_CONFIG,
    CameraConfig,
    EstimatorConfig,
    GlobalMappingConfig,
    ImuConfig,
    LidarConfig,
    LocalMappingConfig,
    ParallelConfig,
    SystemConfig,
    TrackerConfig,
)
