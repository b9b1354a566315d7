"""Published peaks of one NVIDIA H100 SXM and the least time of the work.

67 TFLOP/s float32 outside the tensor cores and 3.35 TB/s of HBM3, the
data sheet's dense rates at the full 700 W; a card set to a lower power
limit runs below them (each run prints its limit). `bound_s` is the
port's smoke-run arithmetic (`bound()`): the larger of operations over
the FLOP rate and bytes over the byte rate.
"""

from __future__ import annotations

PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
NN_OPS_PER_PAIR = 9        # 3 differences, 3 squares, 2 adds, 1 compare
MOMENTS_OPS_PER_PAIR = 9   # the distance and its compare; the 10 sums of
# the pairs inside the radius are left out (they depend on the data)


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def odometry_frame_s(n_src: int, n_tgt: int, iterations: int) -> float:
    """Least time of one frame's odometry on the card: the source
    covariances (radius moments over the frame's valid lanes: read the
    points, write 10 moments a lane) and one 1-NN search of the valid
    sources against the valid keyframe lanes a Gauss-Newton iteration
    (read both clouds, write a distance and an index a source)."""
    t = bound_s(MOMENTS_OPS_PER_PAIR * n_src * n_src,
                n_src * 12 + n_src * 40)
    if n_tgt:
        t += iterations * bound_s(NN_OPS_PER_PAIR * n_src * n_tgt,
                                  (n_src + n_tgt) * 12 + n_src * 12)
    return t
