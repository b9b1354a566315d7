"""`odometry_roofline` in the cells where it moves `device_ms_per_frame`."""

from benchmark.metrics.odometry_roofline import UNIT, read  # noqa: F401
