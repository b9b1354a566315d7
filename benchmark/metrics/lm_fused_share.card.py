"""`lm_fused_share` in the cells where it moves `device_ms_per_frame`."""

from benchmark.metrics.lm_fused_share import UNIT, read  # noqa: F401
