"""The odometry's share of its roofline: the least time of its work
(`peaks.odometry_frame_s`: radius moments of each frame's valid lanes,
one 1-NN of the valid sources against the valid keyframe lanes per
Gauss-Newton iteration, on the published H100 SXM peaks) over the device
time under the odometry spans."""

UNIT = "%"


def read(rec):
    t = (rec.trace or {}).get("layer_device_s", {}).get("odometry")
    if not t or not rec.odometry_bound_s:
        return None
    return 100.0 * rec.odometry_bound_s / t
