"""`prefilter_ms_per_frame` in the cells where it moves `device_ms_per_frame`."""

from benchmark.metrics.prefilter_ms_per_frame import UNIT, read  # noqa: F401
