"""gridmap_slam_tpu — a JAX 2D LiDAR SLAM engine for GPUs.

A JAX/XLA implementation of the capabilities of
`antbern/gridmap-slam-robot` (Rao-Blackwellized particle-filter SLAM over
log-odds occupancy grids), redesigned for data-parallel accelerators:
particles vmapped per device and sharded over device meshes, dense
gather-based map updates, correlative scan matching, and collective-based
resampling.  See SURVEY.md for the reference analysis and README.md for the
architecture.
"""

from .config import (MapConfig, MatcherConfig, MotionConfig, RobotConfig,
                     SensorConfig, SlamConfig, chip_config, pr1_config,
                     reference_parity_config)
from .types import Frame, Odom, Scan, SlamState, StepInfo
from .models.rbpf import RBPF

__version__ = "0.1.0"

__all__ = [
    "SlamConfig", "MapConfig", "MatcherConfig", "MotionConfig", "RobotConfig",
    "SensorConfig", "chip_config", "pr1_config", "reference_parity_config",
    "Frame", "Odom", "Scan", "SlamState", "StepInfo", "RBPF",
]
