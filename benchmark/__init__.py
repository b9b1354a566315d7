"""Benchmark of mrg_slam_tpu_torch, the PyTorch/CUDA port, on one card.

`python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one JSON
line. Everything a cell needs is found by name: `configs/<config>.json`
(the deployment), `traffic/<traffic>.json` (the mix, read by
`traffic.py`), `metrics/<metric>.py` (one reader per per-layer metric)
and `reference/` (the plain reference that decides `correct`).
"""
