"""Per-layer metric readers, one file each, found by the metric's name.

A reader module has `UNIT` and `read(rec)`, which returns the metric's
value or None when the run holds nothing for it to read. `rec` carries:

- `frames`: frames the window completed (summed over robots);
- `window_s`: the window's length in seconds;
- `ticks`: the window's `TickStats` (ticks that had work);
- `wall_s`: the window's host wall seconds per layer span (`prefilter`,
  `odometry`, `ingest`, `tick`), read without the profiler;
- `gn_iterations`: the window's Gauss-Newton iterations of the odometry,
  summed over frames (and robots);
- `trace_frames`: frames of the episodes traced after the window;
- `odometry_bound_s`: the least time of the traced episodes' odometry
  work on the card's published peaks (`peaks.odometry_frame_s`, summed);
- `trace`: `trace.reduce_kineto`'s dict of the traced episodes, or None:
  `window_s`, `busy_s`, `layer_device_s` (device seconds under each layer
  span), ...
"""
