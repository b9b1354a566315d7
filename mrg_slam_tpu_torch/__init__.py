"""mrg_slam_tpu_torch — the PyTorch/CUDA port of mrg_slam_tpu.

The port runs on an NVIDIA Hopper card. Its plain tensor code is PyTorch,
and every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel written by hand for sm_90a (`csrc/`, built at first use by
`ops/native.py`). Each kernel has a plain PyTorch version beside it, which
only CPU tensors (the tests) use.

Package layout mirrors the JAX package:
- `ops/`      clouds, voxel grid, prefilter, NN and radius kernels,
              covariances, GICP registration
- `models/`   fused scan-matching odometry
- `utils/`    SE(3) math, trajectory metrics
- `io/`       the synthetic LiDAR world
- `config.py`, `runtime.py` (device, numerics), `convert.py` (state from
  the JAX package)

The package imports nothing of JAX or of mrg_slam_tpu.
"""

__version__ = "0.1.0"
