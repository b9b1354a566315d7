"""mrg_slam_tpu_torch — the PyTorch/CUDA port of mrg_slam_tpu.

The port runs on an NVIDIA Hopper card. Its plain tensor code is PyTorch,
and every kernel the JAX package wrote in Pallas for the TPU is a CUDA C++
kernel written by hand for sm_90a (`csrc/`, built at first use by
`ops/native.py`). Each kernel has a plain PyTorch version beside it, which
only CPU tensors (the tests) use.

Package layout mirrors the JAX package:
- `ops/`      clouds, voxel grid, prefilter, NN and radius kernels,
              covariances, GICP registration, RANSAC, ground fill
- `graph/`    pose-graph edges and the dense, cg and chain LM solvers
- `models/`   odometry (fused and per frame), the SLAM back end, its
              store, loop detection, the exchange, floor detection and
              sensor processors, persistence and markers
- `pipeline/` replay (one robot, a fleet, a fleet from a bag), the
              acceptance rows
- `parallel/` the exchange's messages
- `utils/`    SE(3) math, trajectory metrics, TUM, geodesy, NMEA
- `io/`       the synthetic LiDAR world, PCD, rosbag, KITTI
- `config.py`, `runtime.py` (device, numerics), `convert.py` (state from
  the JAX package), `launch.py` (the command line:
  `python -m mrg_slam_tpu_torch.launch`)

The package imports nothing of JAX or of mrg_slam_tpu.
"""

__version__ = "0.1.0"
