#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels of `mrg_slam_tpu_torch/csrc/` for sm_90a,
holds each one against its plain PyTorch version on the card at the shapes
and on the inputs of the front end's main path (with and without the rows'
masks, ragged rows included; count also on rows in one cell, pairs at
the radius across cell faces and rows of the default capacity), then
drives two paths at full width on bench.py's production world:

- the front end (prefilter -> fused GICP odometry), FRAMES frames, its
  ATE checked against the JAX package's on the same frames;
- full SLAM (bench.py:200-223): front end, `MrgSlam.process_scan` per
  frame and `MrgSlam.optimization_tick` per block (keyframes -> batched
  pair program -> dense LM), SLAM_FRAMES frames, once to warm up and once
  timed. It prints frames/s, keyframes, loops, ATE after SLAM and of
  odometry alone, and per tick the loop-closure and optimize ms, LM
  iterations, pair rows, GN iterations per bucket and nn launches, and a
  torch.profiler breakdown of the last tick. It fails without a loop,
  with ATE, keyframes or loops outside their bounds around the JAX
  package's numbers on the same frames, or if the timed pass's keyframe
  poses differ by a bit from the warm pass's, or if any LM iteration of
  the timed pass did not run the dense LM's three kernels
  (csrc/lm_dense.cu) once each. nn is then held, bit for bit, to its
  plain version at the pair program's shape (64 rows of the run's
  keyframe pairs, ragged masks, frozen rows, stride-2 coarse rows) and
  timed there; the LM kernels are held to the op path of graph/solve.py
  at the run's two store shapes (128 nodes / 512 edge rows and 256 /
  1024, 3/4 live, every robust kernel id; R = 1 and 4) within
  tests/test_torch_lm_kernel.py's tolerances and timed there, with their
  launches in the timed pass at each shape;
- multi-robot co-hosting (bench.py:277-475) at bench's multi-robot width
  (32768 raw -> 4096 filtered points): a fixed 240-scan survey of one lap
  split among R = 2, 3, 4 robots, per block one prefilter over the R*B
  scans, one `run_batch_multi` (one R-row Gauss-Newton sweep a frame),
  `SharedGraphSlam.process_scan` per robot and frame and one
  `optimization_tick` for the fleet; a warm run and a timed one per R.
  It prints aggregate and per-robot scans/s, per-robot keyframes and
  ATE, inter-robot loops and per tick the loop-closure and optimize ms,
  pair rows and nn launches. It fails without an inter-robot loop, with
  the worst ATE, keyframes or inter-robot loops outside their bounds
  around the JAX package's numbers (`tools/shared_graph_reference.py`),
  if a block's odometry launched nn other than once per sweep of its
  slowest robot, or if the timed run's keyframe poses differ by a bit
  from the warm run's. Every kernel is then held to its plain version
  and timed at this path's shapes (nn at 4 x 4096 odometry rows and at
  the run's largest pair bucket, count and moments on 48 x 4096);
- the large-graph solvers (bench.py:478-564, `run_solvers`) at bench's
  width: bench's ring with n/128 Huber chords solved with 64 LM iterations by the dense and chain
  backends at 1024 nodes and by the chain backend at 8192 (chi2 held to
  the JAX package's on the CPU, `tools/solver_reference.py`, and dense
  against chain), a profiled 1024-node chain solve, chain marginals at
  1024 held to the dense inverse and at 8192 to the exact reference
  blocks, each timed as bench.py does (median of 3 reps on perturbed
  poses after a warm call); then the full-SLAM run's final graph in a
  store of the default capacities with the default OptimizerConfig
  (dense LM at D = 12288, cg marginals: ROADMAP fault 3.1), held to the
  same graph at its run's capacity and to a float64 inverse.
  The dense solves here (SE3 edges only, one card) run the dense LM's
  kernels of csrc/lm_dense.cu around the library's Cholesky; the chain
  backend and the marginals are plain torch ops, as the JAX package's
  are XLA code;
- acceptance rows 1, 2 and 7 at their own width (8192 raw -> 1024
  filtered points, the JAX package's baseline_runs._base_cfg()), through
  the port's `pipeline.baseline_runs`: row 1 per frame
  (`ScanMatchingOdometry`) and fused, row 2 through `replay` and
  `replay_fused`, row 7 (moving occluders) through `replay`, and row 1
  with kNN covariances and STATISTICAL removal. Per row it prints ATE,
  RPE, loops, keyframes, frames/s, odometry GN iterations and host reads
  a frame (with the code lines that make the most), and the kernels'
  launches. It fails on an ATE above
  max(ref + 0.05 m, 1.2 ref), keyframes more than 2 from ref's, a SLAM
  row without a loop or more than max(2, 0.2 ref) loops from ref's (ref:
  the JAX package on the same frames on the CPU,
  `tools/replay_reference.py`), a fused row more than 0.02 m ATE or 2
  keyframes from its per-frame row, or row 2 run again giving keyframe
  poses that differ by a bit. nn (bitwise) and moments are then held to
  their plain versions and timed at this path's shape, one frame of 1024
  lanes;
- acceptance row 3 (`3_floor_augmented`) at its own width through
  `baseline_runs.config3_floor_augmented`: floor detection (normals, plane
  RANSAC on the card, triplets from a torch.Generator there) on every
  filtered scan and the floor processor's plane edges. It prints ATE,
  loops, keyframes, plane edges, frames/s, floor detection ms a call,
  detections accepted, host reads a frame and a floor detection call, and
  the kernels' launches, and fails on an ATE above max(ref + 0.05 m,
  1.2 ref), keyframes more than 2 or loops more than 2 from ref's, no
  loop, plane edges more than max(3, 0.1 ref) from ref's (ref: the JAX
  package on the CPU, `tools/floor_reference.py`), or a floor detection
  call that reads the card other than once; then
  `family_graph_spec(256)`, every prior and plane family on one ring,
  solved by the dense, cg and chain backends (40 LM iterations, chi2
  held to the JAX package's and dense against chain within 1e-3, each
  timed), and its marginals with the plane pool held to the float64
  inverse of each path's own system;
- acceptance rows 4 and 6 at their width, two robots exchanging delta
  graphs through `replay_multirobot` with SharedTick (the exchange
  phase): per robot ATE, loops, inter-robot loops, keyframes, merged
  keyframes and graph bytes held to `tools/exchange_reference.py`; row 6
  rerun bitwise and with serial ticks; `optimize_many` on its final
  graphs; nn and moments at the merged pair buckets and prefetches;
- the launch path (the launch phase): session 1 through `python -m
  mrg_slam_tpu_torch.launch --dataset rosbag`, in process, from a bag of
  the first LAUNCH_FRAMES frames of the full-SLAM world at bench's
  production width, with bench's configs as a YAML in the reference's
  layout and LAUNCH_OVERRIDES as `param:=value` tokens, per frame; it
  checks every output file (map.pcd holds summary["map_points"] points)
  and prints frames/s, keyframes, loops, the keyframe ATE, map points,
  bag-decode ms and host reads a frame. Its graph directory is then
  loaded, flushed without optimizing and saved again on the card, and
  `keyframes/` and `edges/` must be byte-identical. Session 2, a fresh
  `Robot` with its init pose at frame LAUNCH_FRAMES's true pose, loads
  that directory and replays the frames up to SLAM_FRAMES: merged
  keyframes, loops to loaded keyframes, ATE. Then the two-topic fleet bag
  of tests/test_rosbag_and_launch.py through `run_fleet_from_bag` (per
  robot keyframes, loops, inter-robot loops, ATE), the CLI's --robots on
  it (its output contract) and the CLI on tests/data/kitti_mini. Each
  number is held to `tools/launch_reference.py`'s (REF_LAUNCH); count at
  one frame of 8192 lanes, moments there and at the loaded keyframes'
  covariance pass, and nn at session 2's largest pair bucket are held to
  their plain versions and timed. A few frames of session 1 also run
  under the port's `utils.profiling.trace`, for the device-busy share of
  the per-frame path;
- robots as separate processes (the processes phase):
  `pipeline.multiprocess.run_multiprocess` on the card at the JAX
  package's width (`_default_cfg()`, world seed 11, PROC_FRAMES frames,
  a tick every PROC_TICK) with R = 2 and R = 4 robot processes, each with
  its own CUDA context on the one card and delta graphs over TCP. Per
  robot it prints frames/s, keyframes, merged remote keyframes, loops,
  inter-robot loops, ATE, graph bytes, the publish_graph calls (ms, host
  reads each), host reads a frame, kernel launches and peak card memory;
  per R the aggregate robot-frames/s beside row 4 in one process and the
  card's used memory. Every robot is held to the JAX package's CPU run of
  the same arguments (`tools/multiprocess_reference.py`, REF_PROC) in the
  multi-robot bands, with one host read a publish_graph. Then two
  processes of this script (`--kernel-worker`) launch nn and moments at
  the workers' shapes at the same time, nn bitwise and moments within the
  summation bound of its plain version on every launch; nn and moments
  are then timed at one worker frame;
- the distributed solve (the distributed phase): acceptance row 5
  through `baseline_runs.config5_distributed`, `build_ring_graph(256)`
  by the cg LM (40 iterations) on one device and over DIST_RANKS ranks,
  processes sharing the card in one gloo group; both chi2 held to
  1.96797 within 1e-3, the poses to the one-device solve within
  DIST_POSE_ATOL, every rank bitwise equal. It prints the solve walls,
  the reductions an LM iteration and their ms, and each rank's peak
  memory. Then `parallel.dryrun.dryrun_multichip` over the same ranks
  (256 nodes with every family by dense LM, 2048 nodes by the chain
  backend's split panels) under the JAX dry run's asserts. No hand
  kernel runs here;
- acceptance row 2 with the voxel family (the voxel phase): row 2 at
  its width through `baseline_runs.config2_full_slam(registration_method
  =...)` with FAST_VGICP and with NDT, per frame, held to the JAX
  package's runs (`tools/voxel_reference.py`, REF_VOXEL): loops, and
  where the reference keeps the track ATE and keyframes (NDT loses it
  in both packages, ROADMAP §3 B12); both methods recovering a known
  pose on tests/test_registration.py's structured scene; nn bitwise
  and timed at the largest voxel pair bucket (`nn_pairs_voxel`).

Any failed check raises. The last line of standard output is {"ok": true,
"device": {...}}; the line before it lists every kernel with its
launches, error and times: "ms", "plain_ms" and "library_ms" are one call
between CUDA events (the wrapper's host time included, whenever the card
waits for it), and "device_ms" is the kernel's device time per launch in
a CUDA graph.

Needs a CUDA card; without one it exits non-zero and prints no result.
Imports nothing of JAX and nothing of the JAX package.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# production scale of bench.py (RAW, FILTERED, BLOCK) and its world
# (bench.py:166-168); depth is cut from 640 frames to FRAMES (front end)
# and SLAM_FRAMES (full SLAM: 1.51 laps, past the first revisit) so the
# run fits its time limit
RAW, FILTERED, BLOCK, TRAJ_FRAMES, FRAMES = 131072, 8192, 32, 640, 96
SLAM_FRAMES = 320
# the JAX package's odometry ATE on the same world, configs and FRAMES
# frames, on the CPU: `python tools/front_end_reference.py --frames 96`
REF_ATE_M = 0.2813718731443308
# the JAX package's full SLAM on the same world, configs and SLAM_FRAMES
# frames, on the CPU: `python tools/slam_reference.py --frames 320`
REF_SLAM = dict(ate_m=0.2663814268413071, ate_odom_m=0.49454696107988355,
                keyframes=152, loops=32)
PAIR_ROWS = 64  # the pair program's bucket cap at 8192 points
# acceptance rows 1, 2 and 7 (BASELINE_SYNTH.json; the JAX package's
# pipeline/baseline_runs.py) at their own width, not cut: 8192 raw -> 1024
# filtered points, `_base_cfg()`, 120 / 120 / 110 frames; and row 1 with
# kNN covariances (k = 10) and STATISTICAL removal (mean_k 30, stddev
# 1.2). The JAX package's ATE, RPE, loops and keyframes on the same frames,
# on the CPU (`python tools/replay_reference.py`, 113 s on the CPU)
REF_REPLAY = {
    "1_odometry_only": dict(ate_m=0.09507580262005157,
                            rpe_m=0.01687155200439788, keyframes=40),
    "1_odometry_only_fused": dict(ate_m=0.0950781604706768,
                                  rpe_m=0.016871222866379987, keyframes=40),
    "2_full_graph_slam": dict(ate_m=0.13288754944407308,
                              rpe_m=0.018699824062730613, loops=7,
                              keyframes=40),
    "2_full_graph_slam_fused": dict(ate_m=0.1330455984638998,
                                    rpe_m=0.0187545811226256, loops=7,
                                    keyframes=40),
    "7_dynamic_objects": dict(ate_m=0.1499832820451191,
                              rpe_m=0.016892958604078728, loops=3,
                              keyframes=37),
    "1_odometry_only_knn_statistical": dict(ate_m=0.038195636673024086,
                                            rpe_m=0.019746068085211396,
                                            keyframes=40)}
# acceptance row 3 (`3_floor_augmented`) at its own width, not cut:
# `_base_cfg()` with floor detection and the floor processor, the
# flat-ground world of seed 21, 100 frames, a tick every 20. The JAX
# package's run of the same frames on the CPU (`python
# tools/floor_reference.py`, 95 s with the family solves below); its
# triplets come from jax.random, the port's from a torch.Generator
REF_FLOOR = dict(ate_m=0.23544667759555968, rpe_m=0.040798407275734,
                 loops=3, keyframes=34, plane_edges=34, detections=100)
# the prior and plane families on one ring, family_graph_spec(256, seed 0),
# 40 LM iterations: the JAX package's chi2 after the dense, cg and chain
# solves on the CPU (`python tools/floor_reference.py`)
FAMILY_NODES, FAMILY_ITERS = 256, 40
REF_FAMILY = dict(dense=425.98223876953125, cg=425.9820556640625,
                  chain=425.9826354980469)
# acceptance rows 4 (`4_two_robot_exchange`, 100 frames, 30 % overlap) and
# 6 (`6_reversed_encounter`, 120 frames, 35 % overlap, bestla backwards)
# at their width, not cut: `_base_cfg()` (8192 raw -> 1024 filtered
# points) with the rows' exchange cadence, two robots in one process, a
# SharedTick every 8 rounds. The JAX package's runs of the same frames on
# the CPU (`python tools/exchange_reference.py`, 168 s on the CPU)
REF_EXCHANGE = {
    "4_two_robot_exchange": dict(
        ate_m={"atlas": 0.39940590069644566, "bestla": 0.38915287500449264},
        keyframes={"atlas": 19, "bestla": 19},
        loops={"atlas": 5, "bestla": 5},
        inter_robot_loops={"atlas": 0, "bestla": 0},
        remote_keyframes={"atlas": 19, "bestla": 19},
        sent_bytes={"atlas": 259076, "bestla": 259296},
        received_bytes={"atlas": 259296, "bestla": 259076}),
    "6_reversed_encounter": dict(
        ate_m={"atlas": 0.04498500589468842, "bestla": 0.04452661159589868},
        keyframes={"atlas": 24, "bestla": 24},
        loops={"atlas": 31, "bestla": 31},
        inter_robot_loops={"atlas": 21, "bestla": 21},
        remote_keyframes={"atlas": 22, "bestla": 22},
        sent_bytes={"atlas": 302588, "bestla": 302808},
        received_bytes={"atlas": 302808, "bestla": 302588})}
# moments against its plain version at the merged keyframes' prefetch
# shape: the bar PERF.md's kernel table states for the per-frame shapes
MOMENTS_EXCHANGE_TOL = 2.4e-4
# at the launch path's 8192-lane shapes the real points reach X ~ 35 m,
# and cov = M2/n - mean mean^T cancels down from X^2, so two summation
# orders part by a few float32 steps of X^2 (4 of them, 4.9e-4, at
# X = 34.9 m on one frame, PERF.md §6): those rows are held to
# MOMENTS_ULPS steps of X^2 besides the summation bound of check_moments
MOMENTS_ULPS = 8
# the launch phase: session 1 through the CLI (`python -m
# mrg_slam_tpu_torch.launch --dataset rosbag`) from a bag of the first
# LAUNCH_FRAMES frames of the full-SLAM world, with bench's configs as a
# YAML in the reference's layout and LAUNCH_OVERRIDES on the command line;
# session 2, a fresh stack that loads session 1's graph and replays
# frames LAUNCH_FRAMES..SLAM_FRAMES-1; then the fleet bag of
# tests/test_rosbag_and_launch.py (row 4's width, frames 0-47 for atlas
# and 32-79 for bestla) through `run_fleet_from_bag`
LAUNCH_FRAMES, LAUNCH_TICK, LAUNCH_TOPIC = 200, 32, "/velodyne_points"
LAUNCH_OVERRIDES = ("keyframe_delta_trans:=1.1", "capacity_keyframes:=128",
                    "capacity_edges:=512")
SESSION2 = "session2"
FLEET_FRAMES, FLEET_START_B, FLEET_WINDOW, FLEET_TICK = 80, 32, 48, 8
FLEET_NAMES = ("atlas", "bestla")
# the JAX package's runs of the same three on the CPU (`python
# tools/launch_reference.py`: session 1 676 s, session 2 728 s, the fleet
# 73 s on the CPU); ATEs of the own keyframes' optimized poses
# (keyframe_ate), session 1's per-frame TUM trajectory's too
REF_LAUNCH = {
    "session1": dict(ate_m=0.30511539322832265,
                     ate_frames_m=0.3630872050883842, keyframes=94,
                     loops=17, map_points=301344),
    "session2": dict(ate_m=0.2791342696841915, keyframes=58,
                     merged_keyframes=94, loops=55, loaded_loops=34),
    "fleet": {
        "atlas": dict(ate_m=0.04239760999720859, keyframes=24, loops=27,
                      inter_robot_loops=15, remote_keyframes=24),
        "bestla": dict(ate_m=0.04177116757378762, keyframes=24, loops=27,
                       inter_robot_loops=15, remote_keyframes=24)}}
# robots as separate processes (the processes phase): the JAX package's
# pipeline/multiprocess.run_multiprocess at its width, not cut:
# `_default_cfg()` (8192 raw -> 1024 filtered points, no outlier removal),
# world seed 11, PROC_FRAMES frames of a 12 m circle split into
# overlapping windows, a tick every PROC_TICK frames, one OS process a
# robot, delta graphs over TCP in the wire form
PROC_FRAMES, PROC_TICK, PROC_SEED, PROC_ROBOTS = 80, 15, 11, (2, 4)
# the JAX package's run of the same arguments on the CPU, per robot
# (`python tools/multiprocess_reference.py --robots 2 4 --frames 80
# --tick-every 15`: 129 s and 246 s on the CPU)
REF_PROC = {
    2: {"alpha": dict(keyframes=27, remote_keyframes=22, loops=11,
                      ate_m=0.13352108415226033),
        "bravo": dict(keyframes=25, remote_keyframes=23, loops=12,
                      ate_m=0.08085045212650759)},
    4: {"alpha": dict(keyframes=16, remote_keyframes=44, loops=25,
                      ate_m=0.08155884054429492),
        "bravo": dict(keyframes=16, remote_keyframes=44, loops=29,
                      ate_m=0.07628133110120672),
        "charlie": dict(keyframes=16, remote_keyframes=44, loops=29,
                        ate_m=0.09857026381461234),
        "delta": dict(keyframes=15, remote_keyframes=45, loops=24,
                      ate_m=0.06480625419160234)}}
# bytes a keyframe on the wire (tests/test_multiprocess.py:76-78)
PROC_BYTES_PER_KF = 9000
# the distributed phase: row 5's distributed half (build_ring_graph(256),
# cg, 40 LM iterations) over DIST_RANKS ranks, processes sharing the card
# by gloo; chi2 held to ROW5_CHI2 within 1e-3 and the poses to the
# one-device solve within DIST_POSE_ATOL (tests/test_distributed.py's
# atol for this graph; the JAX run's divergence was 0.0027 m,
# BASELINE_SYNTH.json)
DIST_RANKS = 8
DIST_POSE_ATOL = 0.02
# acceptance row 2 at its width with the voxel family (the default
# resolution 1.0 and DIRECT7), the JAX package's `replay` of the same
# frames on the CPU (`python tools/voxel_reference.py`, 68 s). NDT
# diverges there: at 1.0 m a 1024-point scan of this world leaves a few
# cells of 4 points, so the odometry loses the track (ROADMAP §3 B12)
REF_VOXEL = {
    "FAST_VGICP": dict(ate_m=0.2342230331475984, rpe_m=0.10171133244299076,
                       loops=7, keyframes=40),
    "NDT": dict(ate_m=14.363736541480275, rpe_m=6.597846854124117,
                loops=0, keyframes=14)}
# a reference run with an ATE above this has lost the track: its ATE
# bounds nothing (B12), and its keyframes and loops are held instead
DIVERGED_ATE_M = 1.0
# row 4 with both robots in one process, robot-frames/s on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md §6), beside which the processes are printed
ROW4_ONE_PROCESS_FPS = 9.49
# the concurrent kernel check: two processes launch nn and moments at the
# workers' shapes (one 1024-lane frame, a merged pair bucket of
# PROC_BUCKET rows) for PROC_KERNEL_S seconds each, at the same time
PROC_BUCKET, PROC_KERNEL_S = 16, 8.0
# bench.py's multi-robot section (run_multirobot_scaling, bench.py:277-475)
# at its own width: build_world_and_scans(n_frames=160, laps=1.0)
# (bench.py:71-81; 32768 raw points a scan, 4096 filtered), a fixed
# 240-scan survey split among R robots, B frames a block per robot
MR_RAW, MR_FILTERED, MR_FRAMES, MR_SURVEY = 32768, 4096, 160, 240
MR_BLOCKS = {2: 24, 3: 16, 4: 12}
MR_NAMES = ("alpha", "bravo", "charlie", "delta")
# the JAX package's same drive on the CPU, per fleet size: worst keyframe
# ATE, keyframes per robot, inter-robot loops
# (`python tools/shared_graph_reference.py`)
REF_MR = {
    2: dict(worst_ate_m=0.18536934397664148, keyframes=[31, 31],
            inter_loops=26),
    3: dict(worst_ate_m=0.4947618352346885, keyframes=[21, 21, 21],
            inter_loops=21),
    4: dict(worst_ate_m=0.5681725353232716, keyframes=[15, 16, 16, 16],
            inter_loops=17)}
# the deployment's run-to-run spread of the worst ATE (README.md:228)
MR_ATE_SPREAD = 0.3
# bench.py's solver section (run_solvers, bench.py:478-564) at its own
# width: build_ring_graph(n, seed 0) with n/128 Huber chords, 64 LM
# iterations, dense and chain at 1024 nodes, chain at 8192, the exact chain
# marginals of the unsolved 8192-node graph; and acceptance row 5's
# single-device half, cg with 40 iterations on build_ring_graph(256)
SOLVER_ITERS, SOLVER_REPS, MARGINAL_STRIDE = 64, 3, 512
# the JAX package's chi2 after each solve, on the CPU
# (`python tools/solver_reference.py`); row 5's is also BASELINE_SYNTH.json's
REF_SOLVERS = dict(dense_1024=367.29644775390625,
                   chain_1024=367.2234802246094,
                   chain_8192=206.4286651611328, cg_256=1.9679656028747559)
# BASELINE_SYNTH.json results, 5_distributed_mesh_solve, chi2_single
ROW5_CHI2 = 1.9679656028747559
SOLVER_CHI2_RTOL = 1e-3  # the ROADMAP's solver gate
# the exact 6x6 blocks of the chain marginals (H + 1e-6 I on the free
# dofs, inverted in float64) of nodes 512, 1024, ..., 7680 of the unsolved
# 8192-node graph, from the JAX package's linearization
# (`tools/solver_reference.py`; its own float32 chain marginals are NaN
# there, ROADMAP.md §3 B5)
REF_MARGINALS_8192 = np.array([
    3.857378, -1.556678, 2.108308, -0.003666816, 0.2015355, 0.1454665,
    -1.556678, 4.895099, -1.524194, -0.065248, -0.180414, -0.2738139,
    2.108308, -1.524194, 7.363212, 0.0211258, 0.6043594, 0.1089257,
    -0.003666816, -0.065248, 0.0211258, 0.1247725, 0.06927111, 0.01846031,
    0.2015355, -0.180414, 0.6043594, 0.06927111, 0.1155869, 0.0227202,
    0.1454665, -0.2738139, 0.1089257, 0.01846031, 0.0227202, 0.03978447,
    18.76079, 3.089887, -1.285607, -0.04686898, -0.1280907, -0.9228611,
    3.089887, 5.48287, -0.08589838, 0.08195095, -0.1425381, -0.1958763,
    -1.285607, -0.08589838, 36.43116, 1.979642, -0.2613704, 0.1664123,
    -0.04686898, 0.08195095, 1.979642, 0.172422, -0.1151424, 0.03132379,
    -0.1280907, -0.1425381, -0.2613704, -0.1151424, 0.244554, -0.04032877,
    -0.9228611, -0.1958763, 0.1664123, 0.03132379, -0.04032877, 0.07257003,
    18.08217, -9.19846, -14.27466, -0.3315293, 0.5333393, -0.7443083,
    -9.19846, 26.5773, -5.575876, 0.06200333, 0.4946819, 1.239194,
    -14.27466, -5.575876, 42.15918, 0.7508142, -1.597898, 0.0617117,
    -0.3315293, 0.06200333, 0.7508142, 0.1735751, 0.1111617, 0.07281311,
    0.5333393, 0.4946819, -1.597898, 0.1111617, 0.2173884, 0.06799803,
    -0.7443083, 1.239194, 0.0617117, 0.07281311, 0.06799803, 0.1027505,
    15.41981, 3.600199, -13.91236, -0.357941, 0.8456803, -0.1672538,
    3.600199, 22.66614, -6.323613, -0.4472899, 0.3364584, 0.8569737,
    -13.91236, -6.323613, 27.34825, 0.6773575, -1.245213, 0.2587782,
    -0.357941, -0.4472899, 0.6773575, 0.1444101, 0.009288056, 0.1128907,
    0.8456803, 0.3364584, -1.245213, 0.009288056, 0.0998949, 0.04056112,
    -0.1672538, 0.8569737, 0.2587782, 0.1128907, 0.04056112, 0.1963649,
    16.96644, -2.68621, -8.079307, -0.3641686, 0.1133116, -0.7853157,
    -2.68621, 6.271786, 1.851825, 0.1115724, -0.01260437, 0.1866577,
    -8.079307, 1.851825, 31.91749, 1.282698, -0.7091651, 0.4825025,
    -0.3641686, 0.1115724, 1.282698, 0.06924395, -0.03426785, 0.02175155,
    0.1133116, -0.01260437, -0.7091651, -0.03426785, 0.2942844,
    0.0001953946, -0.7853157, 0.1866577, 0.4825025, 0.02175155,
    0.0001953946, 0.05372885, 16.46032, -5.2991, -5.737166, -0.07489389,
    0.4524201, -0.7155566, -5.2991, 6.926848, 5.377327, 0.1355291,
    -0.3130423, 0.3257441, -5.737166, 5.377327, 29.2753, 0.7027957,
    -1.219133, 0.444886, -0.07489389, 0.1355291, 0.7027957, 0.0487998,
    0.05063583, -0.001457517, 0.4524201, -0.3130423, -1.219133, 0.05063583,
    0.3319976, -0.06203297, -0.7155566, 0.3257441, 0.444886, -0.001457517,
    -0.06203297, 0.04594295, 5.639416, -1.832486, 1.450014, -0.06899701,
    -0.2613167, -0.2119446, -1.832486, 3.497847, -0.1001845, 0.05361741,
    0.07901514, 0.129723, 1.450014, -0.1001845, 9.889258, -0.006015847,
    -0.8734226, 0.01969646, -0.06899701, 0.05361741, -0.006015847,
    0.06546055, 0.1090077, -0.005553664, -0.2613167, 0.07901514,
    -0.8734226, 0.1090077, 0.2841975, -0.01244127, -0.2119446, 0.129723,
    0.01969646, -0.005553664, -0.01244127, 0.01765237, 0.0388819,
    -0.0003611624, -0.0001318236, -2.854988e-06, -3.302572e-05,
    -0.0001031821, -0.0003611624, 0.03919887, 0.0004608616, 4.963162e-05,
    6.30941e-05, 0.0001960955, -0.0001318236, 0.0004608616, 0.03940684,
    0.0001296994, -0.0001700793, -5.645423e-05, -2.854988e-06,
    4.963162e-05, 0.0001296994, 0.009148571, 7.913369e-05, 1.766058e-05,
    -3.302572e-05, 6.30941e-05, -0.0001700793, 7.913369e-05, 0.009065246,
    -8.646119e-05, -0.0001031821, 0.0001960955, -5.645423e-05,
    1.766058e-05, -8.646119e-05, 0.009022972, 4.102635, -0.219056,
    0.1249628, 0.02045709, -0.1195447, -0.1693159, -0.219056, 4.760223,
    0.8140824, 0.3059533, 0.01058804, -0.206227, 0.1249628, 0.8140824,
    3.168629, 0.1780818, 0.06438315, -0.106007, 0.02045709, 0.3059533,
    0.1780818, 0.06613434, 0.02839866, -0.04575673, -0.1195447, 0.01058804,
    0.06438315, 0.02839866, 0.1034853, -0.05757168, -0.1693159, -0.206227,
    -0.106007, -0.04575673, -0.05757168, 0.126877, 6.351689, -2.177377,
    0.6158214, 0.0689662, 0.05607515, 0.3307248, -2.177377, 8.745292,
    -0.9608991, -0.01873896, -0.2261884, -0.7487289, 0.6158214, -0.9608991,
    9.208145, -0.03504924, 0.6497694, 0.1338963, 0.0689662, -0.01873896,
    -0.03504924, 0.1101463, 0.05196034, 0.07147769, 0.05607515, -0.2261884,
    0.6497694, 0.05196034, 0.1403469, 0.09029636, 0.3307248, -0.7487289,
    0.1338963, 0.07147769, 0.09029636, 0.2555382, 8.38553, 0.9238733,
    2.622353, 0.3022973, 0.2807697, -0.1523911, 0.9238733, 14.20164,
    1.444403, -0.3404138, -0.004966736, -0.6103433, 2.622353, 1.444403,
    9.729606, 0.1162766, 0.41386, -0.07266582, 0.3022973, -0.3404138,
    0.1162766, 0.3330481, -0.04811941, -0.04158972, 0.2807697,
    -0.004966736, 0.41386, -0.04811941, 0.07825799, -0.002615546,
    -0.1523911, -0.6103433, -0.07266582, -0.04158972, -0.002615546,
    0.09978092, 11.63415, -0.359986, -5.951668, 0.2435588, -0.6388377,
    0.1658032, -0.359986, 13.87807, -2.513272, 0.2047493, -0.1141242,
    -0.5348166, -5.951668, -2.513272, 14.37619, -0.06408851, 0.8071009,
    0.1073533, 0.2435588, 0.2047493, -0.06408851, 0.2614096, -0.009435127,
    0.08020651, -0.6388377, -0.1141242, 0.8071009, -0.009435127, 0.1028326,
    0.0137381, 0.1658032, -0.5348166, 0.1073533, 0.08020651, 0.0137381,
    0.0943515, 13.96662, -0.6837479, -0.04597171, -0.08618447, -0.5956457,
    -0.5275293, -0.6837479, 10.60036, 1.664986, 0.3851098, 0.1380227,
    0.06377813, -0.04597171, 1.664986, 6.050803, 0.1578854, -1.317787e-05,
    0.05382267, -0.08618447, 0.3851098, 0.1578854, 0.06628382, -0.02480042,
    0.06382268, -0.5956457, 0.1380227, -1.317787e-05, -0.02480042,
    0.1036583, -0.05083631, -0.5275293, 0.06377813, 0.05382267, 0.06382268,
    -0.05083631, 0.2652427, 8.974321, 0.943748, -0.08047914, 0.1516311,
    -0.5083841, 0.05455603, 0.943748, 7.106064, -2.271839, 0.3182947,
    -0.1646944, -0.05472732, -0.08047914, -2.271839, 6.054483, -0.2527973,
    0.08245764, 0.0702382, 0.1516311, 0.3182947, -0.2527973, 0.05867593,
    -0.03848727, -0.02222025, -0.5083841, -0.1646944, 0.08245764,
    -0.03848727, 0.2254219, 0.1504604, 0.05455603, -0.05472732, 0.0702382,
    -0.02222025, 0.1504604, 0.16056, 4.563704, -0.3036715, 0.5709175,
    0.006725676, -0.1613107, -0.09698201, -0.3036715, 4.736778, 1.042033,
    0.2921322, 0.1096909, -0.1516922, 0.5709175, 1.042033, 3.064473,
    0.1315589, -0.01023939, -0.08664775, 0.006725676, 0.2921322, 0.1315589,
    0.07489306, 0.04784017, -0.09920562, -0.1613107, 0.1096909,
    -0.01023939, 0.04784017, 0.07244021, -0.09709554, -0.09698201,
    -0.1516922, -0.08664775, -0.09920562, -0.09709554, 0.2377073]
    ).reshape(15, 6, 6)
# held within this share of the largest entry (the port's float64 chain
# marginals of its own graph are 1.7e-5 from these on the CPU: the two
# packages' ring graphs differ by float32 rounding, ~1e-5 m a pose)
MARGINAL_TOL = 1e-3
# the JAX package's bar for chain against dense marginals
# (tests/test_chain_solver.py::test_chain_marginals_match_dense) and for
# cg against exact dense marginals (tests/test_graph.py::
# test_marginals_selected_matches_dense). The exact marginals they are
# held to are the float64 inverse of the system the cg and chain marginals
# solve, H + CG_RIDGE I on the free dofs: on full SLAM's graph (smallest
# eigenvalue ~6e-5) it differs by up to 1.6 % from the dense path's
# H + 1e-9 I, and the float32 dense inverse misses the bar on a few
# entries itself (ROADMAP.md §3 B6)
CHAIN_DENSE_RTOL, CHAIN_DENSE_ATOL = 0.05, 0.02
CG_MARG_RTOL, CG_MARG_ATOL = 0.05, 1e-4
CG_RIDGE = 1e-6
# H100 SXM: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
U32 = 2.0 ** -24  # float32 unit roundoff
TIMING_REPS = 20
GRAPH_LAUNCHES = 20  # kernel calls per timed CUDA graph
TIMED_PASSES = 3  # full front-end passes timed after the first


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=TIMING_REPS, warmup=3):
    """Median device time of fn() over `reps` runs, CUDA events; a
    function slower than 0.1 s (a yardstick) gets 3 runs after one
    warm-up."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.1:
        reps, warmup = 3, 0
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(torch, fn, launches=GRAPH_LAUNCHES, reps=TIMING_REPS):
    """Device time of one fn() (median over `reps`): a CUDA graph of
    `launches` calls replayed back to back, so no host time of the wrapper
    falls between two launches, as it does around a single call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(torch, graph.replay, reps) / launches


def bound(pairs, ops_per_pair, extra_ops, nbytes):
    """Least time (ms) for the work: max of FP32 ops and bytes over peak."""
    t_ops = (pairs * ops_per_pair + extra_ops) / PEAK_F32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def build_world(n_frames=SLAM_FRAMES):
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)

    world = SyntheticWorld.build(seed=11, extent=60.0, n_ground=400000,
                                 n_pillars=150, n_walls=40,
                                 max_points_per_scan=RAW, noise=0.02)
    traj = circle_trajectory(TRAJ_FRAMES, radius=20.0, laps=3.02)[:n_frames]
    raw = np.full((n_frames, RAW, 3), 1.0e6, np.float32)
    rmask = np.zeros((n_frames, RAW), bool)
    for i, p in enumerate(traj):
        s = world.scan(p, seed=i)[:RAW]
        raw[i, :len(s)] = s
        rmask[i, :len(s)] = True
    return traj, raw, rmask


def make_configs():
    """bench.py:100-118 in the port's config classes."""
    from mrg_slam_tpu_torch.config import (PrefilterConfig,
                                           RegistrationConfig,
                                           ScanMatchingOdometryConfig)

    pre = PrefilterConfig(downsample_resolution=0.3, capacity_raw_points=RAW,
                          capacity_filtered_points=FILTERED,
                          outlier_removal_method="RADIUS", radius_radius=0.5,
                          radius_min_neighbors=2)
    reg = RegistrationConfig(registration_method="SMALL_GICP",
                             reg_maximum_iterations=12,
                             reg_transformation_epsilon=1e-2,
                             reg_covariance_mode="radius",
                             reg_covariance_radius=0.6,
                             reg_max_correspondence_distance=2.0)
    odo = ScanMatchingOdometryConfig(keyframe_delta_translation=1.0,
                                     registration=reg,
                                     enable_transform_thresholding=True,
                                     max_acceptable_translation=2.5,
                                     max_acceptable_angle=0.5)
    return pre, odo


def make_slam_config(odo):
    """bench.py:119-147 with make_configs(RAW, FILTERED, keyframe_delta=1.1,
    capacity_keyframes=128, capacity_edges=512) (bench.py:176-178)."""
    from mrg_slam_tpu_torch.config import (LoopClosureConfig,
                                           OptimizerConfig, SlamConfig)

    return SlamConfig(
        own_name="bench", multi_robot_names=("bench",),
        keyframe_delta_trans=1.1, capacity_keyframes=128,
        capacity_edges=512, capacity_keyframe_points=FILTERED,
        registration=dataclasses.replace(
            odo.registration, reg_maximum_iterations=16,
            reg_stall_epsilon=0.01, reg_coarse_stride=2,
            reg_coarse_iterations=10),
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=64),
        loop=dataclasses.replace(LoopClosureConfig(), capacity_candidates=4,
                                 fitness_score_max_range=2.0),
        robot_remove_points_radius=0.0)


def make_mr_configs():
    """make_configs(MR_RAW, MR_FILTERED) (bench.py:94-148) with the
    multi-robot overrides of bench.py:309-326 -> (pre, odo, slam)."""
    pre, odo = make_configs()
    pre = dataclasses.replace(pre, capacity_raw_points=MR_RAW,
                              capacity_filtered_points=MR_FILTERED)
    slam = make_slam_config(odo)
    slam = dataclasses.replace(
        slam, keyframe_delta_trans=2.0, capacity_keyframe_points=MR_FILTERED,
        loop=dataclasses.replace(slam.loop,
                                 accum_distance_thresh_other_robot=2.0,
                                 capacity_candidates=2),
        registration=dataclasses.replace(slam.registration,
                                         reg_maximum_iterations=12))
    odo = dataclasses.replace(
        odo, keyframe_delta_translation=2.0,
        registration=dataclasses.replace(odo.registration,
                                         reg_transformation_epsilon=1e-3))
    return pre, odo, slam


class MrInputs(NamedTuple):
    traj: np.ndarray  # (MR_FRAMES, 7) ground truth
    raw: object       # (MR_FRAMES, MR_RAW, 3) float32 scans on the card
    rmask: object     # (MR_FRAMES, MR_RAW) bool
    stamps: object    # (MR_FRAMES,) float32 seconds
    cfgs: tuple       # (pre, odo, slam)


def mr_inputs(torch, dev):
    """bench.py's multi-robot world and configs on the card."""
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)

    world = SyntheticWorld.build(seed=7, extent=45.0, n_ground=120000,
                                 n_pillars=60, n_walls=20,
                                 max_points_per_scan=MR_RAW, noise=0.02)
    traj = circle_trajectory(MR_FRAMES, radius=15.0, laps=1.0)
    raw = np.full((MR_FRAMES, MR_RAW, 3), 1.0e6, np.float32)
    rmask = np.zeros((MR_FRAMES, MR_RAW), bool)
    for i, p in enumerate(traj):
        s = world.scan(p, seed=i)[:MR_RAW]
        raw[i, :len(s)] = s
        rmask[i, :len(s)] = True
    return MrInputs(traj, torch.from_numpy(raw).to(dev),
                    torch.from_numpy(rmask).to(dev),
                    torch.arange(MR_FRAMES, dtype=torch.float32,
                                 device=dev) * 0.1, make_mr_configs())


def windows_for(R):
    """bench.py:341-361: the fixed MR_SURVEY-scan survey of the lap split
    among R robots in evenly spread, overlapping windows."""
    span = MR_SURVEY // R
    stride = (MR_FRAMES - span) // (R - 1)
    w = [(i * stride, i * stride + span) for i in range(R - 1)]
    w.append((MR_FRAMES - span, MR_FRAMES))
    return dict(zip(MR_NAMES[:R], w))


def init_pose_of(p):
    yaw = 2.0 * np.arctan2(p[6], p[3])
    return (float(p[0]), float(p[1]), float(p[2]), float(yaw), 0.0, 0.0)


class MrRun(NamedTuple):
    group: object      # the SharedGraphSlam after the last tick
    windows: dict      # robot -> (first frame, end frame)
    wall: float        # seconds, group creation to the last tick's end
    ticks: list        # one dict per tick
    odo_blocks: list   # per block: (nn launches, sum of slowest GN iters)
    fallbacks: int     # blocks run per robot (ragged tails)


class BucketRecorder:
    """Installed over `registration.align_pairs_packed`, keeps the inputs
    of the largest pair bucket handed to it (rows of target and source
    GICP clouds, the rows' initial poses) and passes every call on."""

    def __init__(self, reg):
        self.reg, self.fn, self.largest = reg, reg.align_pairs_packed, None

    def __enter__(self):
        self.reg.align_pairs_packed = self
        return self

    def __exit__(self, *exc):
        self.reg.align_pairs_packed = self.fn

    def __call__(self, params, tgts, srcs, init_poses, *rest):
        if self.largest is None or len(tgts) > len(self.largest[0]):
            self.largest = (list(tgts), list(srcs),
                            np.array(init_poses, np.float32))
        return self.fn(params, tgts, srcs, init_poses, *rest)


def mr_drive(torch, inp, R):
    """bench.py's run_multirobot_scaling `run(R)` through the port: per
    block one prefilter over the R*B raw scans, one run_batch_multi over
    the robots' (B, MR_FILTERED) blocks and one read of poses and GN
    iterations, SharedGraphSlam.process_scan per robot and frame, one
    optimization_tick; ragged window tails fall back to per-robot
    run_batch (bench.py:413-430); a last tick."""
    from mrg_slam_tpu_torch.models import odometry_fused as fused
    from mrg_slam_tpu_torch.models.shared_graph import SharedGraphSlam
    from mrg_slam_tpu_torch.ops import nn_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter

    pre, odo, slam_cfg = inp.cfgs
    covs_ok = reg.covariance_compatible(odo.registration,
                                        slam_cfg.registration)
    windows = windows_for(R)
    names = list(windows)
    B = MR_BLOCKS[R]
    dev = inp.raw.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    group = SharedGraphSlam(
        dataclasses.replace(slam_cfg, own_name=names[0],
                            multi_robot_names=tuple(names)),
        names, {n: init_pose_of(inp.traj[lo])
                for n, (lo, _) in windows.items()}, device=dev)
    carries = fused.stack_carries([fused.init_carry(MR_FILTERED, device=dev)
                                   for _ in names])
    ticks, odo_blocks, fallbacks = [], [], 0

    def ingest(name, s, fpts, fmask, poses, covs=None):
        for i in range(poses.shape[0]):
            group.process_scan(name, (s + i) * 0.1, poses[i],
                               PointCloud(fpts[i], fmask[i]),
                               source_covs=(covs[i] if covs is not None
                                            else None))

    def tick(now):
        nn0 = nn_kernel.nn_cuda.launches
        t1 = time.perf_counter()
        st = group.optimization_tick(now=now)
        if st is not None:
            ticks.append(dict(
                wall_ms=(time.perf_counter() - t1) * 1e3,
                loop_closure_ms=st.loop_closure_us / 1e3,
                optimize_ms=st.optimization_us / 1e3,
                lm_iterations=st.iterations, loops=st.num_loops,
                pair_rows=sum(r for r, _ in st.pair_buckets),
                gn_iterations_per_bucket=[g for _, g in st.pair_buckets],
                nn_launches=nn_kernel.nn_cuda.launches - nn0))

    n_local = max(hi - lo for lo, hi in windows.values())
    for s in range(0, n_local, B):
        spans = {n: (windows[n][0] + s,
                     min(windows[n][0] + s + B, windows[n][1]))
                 for n in names if s < windows[n][1] - windows[n][0]}
        if (len(spans) == len(names)
                and all(b - a == B for a, b in spans.values())):
            c = prefilter(PointCloud(
                torch.cat([inp.raw[a:b] for a, b in spans.values()]),
                torch.cat([inp.rmask[a:b] for a, b in spans.values()])), pre)
            fpts = c.points.view(R, B, MR_FILTERED, 3)
            fmask = c.mask.view(R, B, MR_FILTERED)
            nn0 = nn_kernel.nn_cuda.launches
            carries, outs = fused.run_batch_multi(
                odo, carries, fpts, fmask, inp.stamps[s:s + B].expand(R, B))
            nn_odo = nn_kernel.nn_cuda.launches - nn0
            # the block's one read: poses and GN iterations together
            host = torch.cat([outs.pose, outs.iterations[..., None].to(
                torch.float32)], -1).cpu().numpy()
            odo_blocks.append((nn_odo, int(host[..., 7].max(0).sum())))
            for r, name in enumerate(names):
                ingest(name, s, fpts[r], fmask[r], host[r, :, :7],
                       covs=(outs.covs[r] if covs_ok else None))
        else:
            rows = fused.unstack_carries(carries)
            for r, name in enumerate(names):
                if name not in spans:
                    continue
                a, b = spans[name]
                c = prefilter(PointCloud(inp.raw[a:b], inp.rmask[a:b]), pre)
                rows[r], outs = fused.run_batch(odo, rows[r], c.points,
                                                c.mask,
                                                inp.stamps[s:s + (b - a)])
                fallbacks += 1
                ingest(name, s, c.points, c.mask, outs.pose.cpu().numpy(),
                       covs=(outs.covs if covs_ok else None))
            carries = fused.stack_carries(rows)
        tick((s + B) * 0.1)
    tick(n_local * 0.1)
    torch.cuda.synchronize()
    return MrRun(group, windows, time.perf_counter() - t0, ticks,
                 odo_blocks, fallbacks)


def mr_metrics(run, traj):
    """bench.py:446-462: per-robot keyframe ATE (Umeyama-aligned at the
    keyframe stamps) and that of odometry alone at the same keyframes,
    keyframes, inter-robot loops, scans/s."""
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse

    group = run.group
    ates, odo_ates, kfs = {}, {}, {}
    for name, (lo, _) in run.windows.items():
        own = sorted(group.robot_keyframes(name), key=lambda k: k.stamp)
        est = group.trajectory(name)
        if not np.isfinite(est).all():
            raise AssertionError(f"{name}: keyframe poses not finite")
        gt = traj[[lo + int(round(k.stamp / 0.1)) for k in own]]
        ates[name] = float(ate_rmse(est[:, :3], gt[:, :3]))
        odo = np.stack([k.odom for k in own])
        odo_ates[name] = float(ate_rmse(odo[:, :3], gt[:, :3]))
        kfs[name] = len(own)
    inter = 0
    for e in group.db.edges:
        if e.type == "loop":
            a = group.db.uuid_keyframe_map[e.from_uuid]
            b = group.db.uuid_keyframe_map[e.to_uuid]
            inter += a.robot_name != b.robot_name
    scans = sum(hi - lo for lo, hi in run.windows.values())
    return dict(scans=scans, wall_s=run.wall, scans_per_s=scans / run.wall,
                scans_per_s_per_robot={n: (hi - lo) / run.wall for n, (lo, hi)
                                       in run.windows.items()},
                ate_m=ates, worst_ate_m=max(ates.values()),
                ate_odom_m=odo_ates, keyframes=kfs,
                inter_loops=inter,
                loops=sum(1 for e in group.db.edges if e.type == "loop"))


def check_mr(R, m):
    """The multi-robot bounds around the JAX package's numbers."""
    ref = REF_MR[R]
    if m["inter_loops"] < 1:
        raise AssertionError(f"{R} robots closed no inter-robot loop")
    if not m["worst_ate_m"] <= ref["worst_ate_m"] + MR_ATE_SPREAD:
        raise AssertionError(
            f"{R} robots: worst ATE {m['worst_ate_m']:.4f} m > "
            f"{ref['worst_ate_m'] + MR_ATE_SPREAD:.4f} m")
    for k, want in zip(m["keyframes"].values(), ref["keyframes"]):
        if abs(k - want) > 2:
            raise AssertionError(f"{R} robots: keyframes "
                                 f"{m['keyframes']}, the JAX package "
                                 f"{ref['keyframes']}")
    if abs(m["inter_loops"] - ref["inter_loops"]) > max(
            3, 0.3 * ref["inter_loops"]):
        raise AssertionError(f"{R} robots: {m['inter_loops']} inter-robot "
                             f"loops, the JAX package {ref['inter_loops']}")


def mr_phase(torch, inp):
    """The multi-robot section for R = 2, 3, 4: a warm run, then a timed
    run with the counts from 0 -> (metrics per R, the R = 4 timed run's
    launches, its odometry's nn launches and its ticks', the largest
    pair bucket of the R = 4 warm run)."""
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel
    from mrg_slam_tpu_torch.ops import registration as reg

    counters = (nn_kernel.nn_cuda, stats_kernel.count_cuda,
                stats_kernel.moments_cuda)
    out, bucket = {}, None
    for R in sorted(MR_BLOCKS):
        with BucketRecorder(reg) as rec:
            warm = mr_drive(torch, inp, R)
        bucket = rec.largest
        for fn in counters:
            fn.launches = 0
        run = mr_drive(torch, inp, R)
        launches = dict(zip(("nn", "count", "moments"),
                            (fn.launches for fn in counters)))
        m = mr_metrics(run, inp.traj)
        log(f"# {R}-robot shared-graph SLAM at bench's width ({MR_RAW} raw "
            f"-> {MR_FILTERED} filtered pts): {m['scans']} scans in "
            f"{run.wall:.3f} s, {m['scans_per_s']:.2f} scans/s aggregate "
            f"(warm run {m['scans'] / warm.wall:.2f}), per robot "
            f"{ {n: round(v, 2) for n, v in m['scans_per_s_per_robot'].items()} }; "
            f"keyframes {m['keyframes']}, worst ATE {m['worst_ate_m']:.4f} m "
            f"({ {n: round(v, 4) for n, v in m['ate_m'].items()} }; "
            f"odometry alone "
            f"{ {n: round(v, 4) for n, v in m['ate_odom_m'].items()} }), "
            f"{m['inter_loops']} inter-robot loops of {m['loops']}; JAX "
            f"reference {REF_MR[R]}")
        for i, t in enumerate(run.ticks):
            log(f"# {R} robots, tick {i}: loop closure "
                f"{t['loop_closure_ms']:.1f} ms, optimize "
                f"{t['optimize_ms']:.1f} ms, pair rows {t['pair_rows']}, nn "
                f"launches {t['nn_launches']} ({json.dumps(t)})")
        odo_nn = sum(n for n, _ in run.odo_blocks)
        slowest = sum(g for _, g in run.odo_blocks)
        tick_nn = sum(t["nn_launches"] for t in run.ticks)
        log(f"# {R} robots: launches {launches}; odometry nn {odo_nn} over "
            f"{len(run.odo_blocks)} batched blocks (sum over frames of the "
            f"slowest robot's GN iterations {slowest}), ticks' nn {tick_nn}, "
            f"ragged-tail fallbacks {run.fallbacks}")
        for k, v in launches.items():
            if v <= 0:
                raise AssertionError(f"{R} robots: kernel {k} never "
                                     "launched")
        if any(n != g for n, g in run.odo_blocks):
            raise AssertionError(
                f"{R} robots: odometry nn launches per block "
                f"{[n for n, _ in run.odo_blocks]} != the slowest robot's "
                f"GN iterations {[g for _, g in run.odo_blocks]}")
        check_mr(R, m)
        for name in run.windows:
            a = warm.group.trajectory(name)
            b = run.group.trajectory(name)
            if a.shape != b.shape or not (a.view(np.uint32)
                                          == b.view(np.uint32)).all():
                raise AssertionError(f"{R} robots, {name}: keyframe poses "
                                     "of the timed run differ from the "
                                     "warm run's")
        log(f"# {R} robots: timed run's keyframe poses bitwise identical to "
            "the warm run's")
        out[R] = dict(m, ticks=run.ticks, launches=launches,
                      odometry_nn=odo_nn, ticks_nn=tick_nn,
                      loop_closure_ms_per_tick=float(np.mean(
                          [t["loop_closure_ms"] for t in run.ticks])),
                      optimize_ms_per_tick=float(np.mean(
                          [t["optimize_ms"] for t in run.ticks])),
                      ref=REF_MR[R])
    return out, launches, odo_nn, tick_nn, bucket


def timed_row(torch, name, source, replaces, fk, fp, flib, launches, err,
              bound_ms, bound_by, where="the R = 4 timed run"):
    """One kernel row of the kernels line, its times measured here;
    `launches` were counted in `where`."""
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               launches=launches, max_abs_err=err, ms=cuda_ms(torch, fk),
               device_ms=graph_ms(torch, fk), plain_ms=cuda_ms(torch, fp),
               bound_ms=bound_ms, bound_by=bound_by,
               library_ms=cuda_ms(torch, flib))
    log(f"# {name}: kernel {row['ms']:.4f} ms around one call "
        f"({row['device_ms']:.4f} ms a launch in a CUDA graph), plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}); {launches} launches in "
        f"{where}")
    return row


def mr_kernel_rows(torch, inp, launches, odo_nn, tick_nn, bucket):
    """Every kernel at the multi-robot path's shapes, on its inputs, held
    to its plain version: nn at the odometry's 4 x 4096 onto 4 x 4096 (the
    first R = 4 block's frames 1 onto 0, with their masks) and at the
    largest pair bucket of the R = 4 run (with every 4th row frozen and on
    the stride-2 coarse rows), bitwise; count on that block's 48 x 4096
    voxel grid output, exact; moments on its 48 x 4096 prefiltered clouds,
    within the float32 summation bound."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import downsample_stage, prefilter
    from mrg_slam_tpu_torch.utils import se3

    pre = inp.cfgs[0]
    R, B = 4, MR_BLOCKS[4]
    spans = [(lo, lo + B) for lo, _ in windows_for(R).values()]
    first = PointCloud(torch.cat([inp.raw[a:b] for a, b in spans]),
                       torch.cat([inp.rmask[a:b] for a, b in spans]))
    vox = downsample_stage(first, pre)
    blk = prefilter(first, pre)
    blk_pts = pad_invalid(blk.points, blk.mask).contiguous()
    pts4 = blk_pts.view(R, B, MR_FILTERED, 3)
    m4 = blk.mask.view(R, B, MR_FILTERED)
    src, tgt = pts4[:, 1].contiguous(), pts4[:, 0].contiguous()
    sm, tm = m4[:, 1].contiguous(), m4[:, 0].contiguous()
    r2c, r2m = sk.radius_sq(0.5), sk.radius_sq(0.6)
    rows = []

    def real_pairs(a_mask, b_mask):
        return float((a_mask.sum(-1).double() * b_mask.sum(-1).double())
                     .sum())

    def lib_nn_rows(s_, t_, s_m, t_m):
        real = [(a[ma], b[mb]) for a, b, ma, mb in zip(s_, t_, s_m, t_m)]

        def lib():
            return [torch.cdist(a[None], b[None],
                                compute_mode="donot_use_mm_for_euclid_dist"
                                ).min(dim=-1) for a, b in real]
        return lib

    # nn at the odometry's shape
    err = check_nn(torch, nk, src, tgt, "odometry rows", sm, tm)
    log(f"# nn at the multi-robot odometry's shape: {R} rows x "
        f"{MR_FILTERED} lanes, real sources {int(sm.sum(-1).min())}-"
        f"{int(sm.sum(-1).max())}: bitwise == plain on every lane")
    rows.append(timed_row(
        torch, "nn_odom_mr", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(src, tgt, sm, tm),
        lambda: nk.nn_plain(src, tgt, sm, tm),
        lib_nn_rows(src, tgt, sm, tm), odo_nn, err,
        *bound(real_pairs(sm, tm), 9, 0,
               (src.numel() + tgt.numel()) * 4 + src.shape[0]
               * src.shape[1] * 12)))

    # nn at the largest pair bucket: its rows' first sweep
    tgts, srcs, inits = bucket
    init = torch.from_numpy(inits).to(src.device)
    p_src = se3.pose_apply(init[:, None, :], torch.stack(
        [c.points for c in srcs])).contiguous()
    p_sm = torch.stack([c.mask for c in srcs]).contiguous()
    t_m = torch.stack([c.mask for c in tgts]).contiguous()
    p_tgt = pad_invalid(torch.stack([c.points for c in tgts]),
                        t_m).contiguous()
    frozen = p_sm.clone()
    frozen[::4] = False
    check_nn(torch, nk, p_src, p_tgt, "pair bucket", p_sm, t_m)
    check_nn(torch, nk, p_src, p_tgt, "pair bucket, frozen", frozen, t_m)
    coarse = [x[:, ::2].contiguous() for x in (p_src, p_tgt, p_sm, t_m)]
    check_nn(torch, nk, coarse[0], coarse[1], "pair bucket, coarse",
             coarse[2], coarse[3])
    err = check_nn(torch, nk, p_src, p_tgt, "pair bucket", p_sm, t_m)
    log(f"# nn at the largest pair bucket of the R = 4 run: "
        f"{p_src.shape[0]} rows x {p_src.shape[1]} lanes, real sources "
        f"{int(p_sm.sum(-1).min())}-{int(p_sm.sum(-1).max())}: bitwise == "
        "plain on every lane, also with every 4th row frozen and on the "
        "stride-2 coarse rows")
    rows.append(timed_row(
        torch, "nn_pairs_mr", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(p_src, p_tgt, p_sm, t_m),
        lambda: nk.nn_plain(p_src, p_tgt, p_sm, t_m),
        lib_nn_rows(p_src, p_tgt, p_sm, t_m), tick_nn, err,
        *bound(real_pairs(p_sm, t_m), 9, 0,
               (p_src.numel() + p_tgt.numel()) * 4 + p_src.shape[0]
               * p_src.shape[1] * 12)))

    # count on the block's voxel grid output
    vp, vm = vox.points.contiguous(), vox.mask.contiguous()
    err, c_plain = check_count(torch, sk, vp, vm, r2c, "multi-robot voxel "
                               "block")
    count_real = [p[m] for p, m in zip(vp, vm)]

    def lib_count():
        return [((d <= 0.5) & (d > 0)).sum(-1) for d in (
            torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
            for p in count_real)]

    rows.append(timed_row(
        torch, "count_mr", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:34",
        lambda: sk.count_cuda(vp, vm, r2c),
        lambda: sk.count_plain(vp, vm, r2c), lib_count, launches["count"],
        err, *bound(float(c_plain.double().sum()), 11, 0,
                    vp.numel() * 4 + vm.numel() * 5)))

    # moments on the block after prefilter (make_source's input)
    err, inside = check_moments(torch, sk, blk_pts, r2m, "multi-robot "
                                "block", blk.mask)
    feats = torch.cat([torch.ones_like(blk_pts[..., :1]), blk_pts,
                       *(blk_pts[..., a:a + 1] * blk_pts[..., b:b + 1]
                         for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                      (2, 2)))], dim=-1)
    pts_real = [p[m] for p, m in zip(blk_pts, blk.mask)]
    feats_real = [f[m] for f, m in zip(feats, blk.mask)]

    def lib_moments():
        return [(torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
                 <= 0.6).float() @ f for p, f in zip(pts_real, feats_real)]

    rows.append(timed_row(
        torch, "moments_mr", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:93",
        lambda: sk.moments_cuda(blk_pts, blk_pts, r2m, blk.mask, blk.mask),
        lambda: sk.moments_plain(blk_pts, blk_pts, r2m, blk.mask, blk.mask),
        lib_moments, launches["moments"], err,
        *bound(real_pairs(blk.mask, blk.mask), 9, 16 * inside,
               blk_pts.numel() * 4 + blk_pts.shape[0] * blk_pts.shape[1]
               * 40)))
    return rows


# ---------------------------------------------------------------------------
# acceptance rows 1, 2 and 7: per-frame odometry and replay
# ---------------------------------------------------------------------------

class GnCounter:
    """Installed over `registration._run_stage`, the Gauss-Newton loop of
    every single-row solve (the odometry's, per frame or fused; the pair
    program runs `_run_rows`): sums the iterations it ran and passes every
    call on. The count is a Python int it returns, so this reads nothing
    from the card."""

    def __init__(self, reg):
        self.reg, self.fn, self.iterations = reg, reg._run_stage, 0

    def __enter__(self):
        self.reg._run_stage = self
        return self

    def __exit__(self, *exc):
        self.reg._run_stage = self.fn

    def __call__(self, *args):
        out = self.fn(*args)
        self.iterations += out[1]
        return out


def knn_statistical_cfg(bl):
    """Row 1's config with kNN covariances (k = reg_correspondence_
    randomness = 10) and STATISTICAL removal (the defaults, mean_k 30,
    stddev 1.2), as tools/replay_reference.py builds it."""
    cfg = bl._base_cfg()
    odo, slam = cfg.odometry, cfg.slam
    return dataclasses.replace(
        cfg,
        prefilter=dataclasses.replace(cfg.prefilter,
                                      outlier_removal_method="STATISTICAL"),
        odometry=dataclasses.replace(odo, registration=dataclasses.replace(
            odo.registration, reg_covariance_mode="knn")),
        slam=dataclasses.replace(slam, registration=dataclasses.replace(
            slam.registration, reg_covariance_mode="knn")))


def sync_top(audit, k=8):
    """The k code lines that made the most of a `utils.profiling.SyncAudit`'s
    synchronizing calls, as ("file:line", count)."""
    import collections

    return collections.Counter(
        f"{os.path.relpath(f, ROOT)}:{line}"
        for f, line, _ in audit.sites).most_common(k)


def replay_row(torch, name, run, ref=None, sync=None):
    """One acceptance row through the port's entry point, the kernels'
    counts from 0 just before it: -> its metrics. The host reads are those
    `sync` (a `utils.profiling.SyncAudit`, a new one by default) sees
    while the row runs, with the code lines that made the most."""
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.utils.profiling import SyncAudit

    counters = (nn_kernel.nn_cuda, stats_kernel.moments_cuda,
                stats_kernel.count_cuda)
    for fn in counters:
        fn.launches = 0
    sync = sync or SyncAudit("cuda")
    with GnCounter(reg) as gn, sync:
        r = run()
    reads = sync.count()
    n = r["frames"]
    m = dict(ate_m=r["ate_rmse"], rpe_m=r["rpe_rmse"], loops=r.get("loops"),
             keyframes=r["keyframes"], frames=n,
             frames_per_s=r["frames_per_s"],
             gn_iterations_per_frame=gn.iterations / n,
             host_reads_per_frame=reads / n,
             host_read_sources=[[w, c / n] for w, c in sync_top(sync)],
             launches=dict(zip(("nn", "moments", "count"),
                               (fn.launches for fn in counters))),
             ref=ref or REF_REPLAY[name])
    log(f"# {name}: ATE {m['ate_m']:.4f} m (JAX CPU "
        f"{m['ref']['ate_m']:.4f}), RPE {m['rpe_m']:.4f} m, loops "
        f"{m['loops']}, keyframes {m['keyframes']} (JAX CPU "
        f"{m['ref'].get('loops')}, {m['ref']['keyframes']}); "
        f"{m['frames_per_s']:.2f} frames/s over {n} frames; GN iterations "
        f"{m['gn_iterations_per_frame']:.2f} and host reads "
        f"{m['host_reads_per_frame']:.2f} a frame; launches "
        f"{m['launches']}; reads a frame by line: "
        + ", ".join(f"{w} {c:.2f}" for w, c in m["host_read_sources"]))
    return m, r


def check_replay(name, m):
    """ATE within max(ref + 0.05 m, 1.2 ref) of the JAX package's on the
    CPU; loops on the SLAM rows: at least one, and within max(2, 0.2 ref)
    of ref's; keyframes within 2 of ref's; nn launched once per odometry
    GN iteration where no tick runs, moments in radius mode."""
    ref = REF_REPLAY[name]
    lim = max(ref["ate_m"] + 0.05, 1.2 * ref["ate_m"])
    if not m["ate_m"] <= lim:
        raise AssertionError(f"{name}: ATE {m['ate_m']:.4f} m > {lim:.4f}")
    if "loops" in ref:
        tol = max(2, 0.2 * ref["loops"])
        if not (m["loops"] >= 1 and abs(m["loops"] - ref["loops"]) <= tol):
            raise AssertionError(f"{name}: {m['loops']} loops, JAX CPU "
                                 f"{ref['loops']}")
    if abs(m["keyframes"] - ref["keyframes"]) > 2:
        raise AssertionError(f"{name}: {m['keyframes']} keyframes, JAX CPU "
                             f"{ref['keyframes']}")
    gn = round(m["gn_iterations_per_frame"] * m["frames"])
    if m["launches"]["nn"] <= 0:
        raise AssertionError(f"{name}: nn never launched")
    if name.startswith("1_") and m["launches"]["nn"] != gn:
        raise AssertionError(f"{name}: nn launches {m['launches']['nn']} "
                             f"!= odometry GN iterations {gn}")
    if "knn" not in name and m["launches"]["moments"] <= 0:
        raise AssertionError(f"{name}: moments never launched")


def frame_kernel_rows(torch, launches):
    """nn and moments at the per-frame path's shape, one frame of 1024
    lanes: row 2's frames 1 onto 0 after prefilter on the card, with their
    masks. nn bitwise to nn_plain, moments (radius 1.0, make_source's)
    within the float32 summation bound; timed as the other rows, with
    their launches over row 2's run."""
    from mrg_slam_tpu_torch.io.synthetic import circle_trajectory
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    cfg = bl._base_cfg()
    world = bl._world()
    traj = circle_trajectory(120, radius=14.0, laps=1.25)
    clouds = [prefilter(PointCloud.from_array(
        world.scan(p, seed=i), cfg.prefilter.capacity_raw_points),
        cfg.prefilter) for i, p in enumerate(traj[:2])]
    src = clouds[1].points[None].contiguous()
    sm = clouds[1].mask[None].contiguous()
    tgt = clouds[0].points[None].contiguous()
    tm = clouds[0].mask[None].contiguous()
    err = check_nn(torch, nk, src, tgt, "one frame", sm, tm)
    check_nn(torch, nk, src, tgt, "one frame, every lane")
    pairs = float(sm.sum()) * float(tm.sum())
    real_s, real_t = src[0][sm[0]], tgt[0][tm[0]]
    log(f"# nn at the per-frame path's shape: 1 x {src.shape[1]} lanes, "
        f"{int(sm.sum())} real sources onto {int(tm.sum())} real targets: "
        "bitwise == plain on every lane, with and without the masks")

    def lib_nn():
        return torch.cdist(real_s[None], real_t[None],
                           compute_mode="donot_use_mm_for_euclid_dist"
                           ).min(dim=-1)

    where = "row 2's per-frame run"
    rows = [timed_row(
        torch, "nn_frame", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(src, tgt, sm, tm),
        lambda: nk.nn_plain(src, tgt, sm, tm), lib_nn, launches["nn"], err,
        *bound(pairs, 9, 0, (src.numel() + tgt.numel()) * 4
               + src.shape[1] * 12), where=where)]

    r2 = sk.radius_sq(cfg.odometry.registration.reg_covariance_radius)
    pts = pad_invalid(clouds[0].points, clouds[0].mask)[None].contiguous()
    err, inside = check_moments(torch, sk, pts, r2, "one frame", tm)
    feats = torch.cat([torch.ones_like(real_t[:, :1]), real_t,
                       *(real_t[:, a:a + 1] * real_t[:, b:b + 1]
                         for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                      (2, 2)))], dim=-1)
    radius = float(cfg.odometry.registration.reg_covariance_radius)

    def lib_moments():
        return (torch.cdist(real_t, real_t,
                            compute_mode="donot_use_mm_for_euclid_dist")
                <= radius).float() @ feats

    rows.append(timed_row(
        torch, "moments_frame", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:93",
        lambda: sk.moments_cuda(pts, pts, r2, tm, tm),
        lambda: sk.moments_plain(pts, pts, r2, tm, tm), lib_moments,
        launches["moments"], err,
        *bound(float(tm.sum()) ** 2, 9, 16 * inside,
               pts.numel() * 4 + pts.shape[1] * 40), where=where))
    return rows


def profiled_frames(torch, n=12):
    """Row 1's per-frame path (`prefilter`, `ScanMatchingOdometry.step`)
    on frames 4 .. 4 + n after 4 warm frames, once unprofiled (wall) and
    once under torch.profiler: device ms, device activities and GN
    iterations a frame, the device's busy share of the unprofiled wall,
    top ops."""
    from torch.profiler import ProfilerActivity, profile

    from mrg_slam_tpu_torch.io.synthetic import circle_trajectory
    from mrg_slam_tpu_torch.models.odometry import ScanMatchingOdometry
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    cfg = bl._base_cfg()
    world = bl._world()
    traj = circle_trajectory(120, radius=14.0, laps=1.1)
    scans = [world.scan(p, seed=i) for i, p in enumerate(traj[:4 + n])]

    def steps(odo, frames):
        for i in frames:
            odo.step(prefilter(PointCloud.from_array(
                scans[i], cfg.prefilter.capacity_raw_points),
                cfg.prefilter), i * 0.1)
        torch.cuda.synchronize()

    walls = []
    for profiled in (False, True):
        odo = ScanMatchingOdometry(cfg.odometry)
        steps(odo, range(4))
        with GnCounter(reg) as gn:
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    steps(odo, range(4, 4 + n))
            else:
                t0 = time.perf_counter()
                steps(odo, range(4, 4 + n))
                walls.append(time.perf_counter() - t0)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    avg = prof.key_averages()
    dev_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    out = dict(frames=n, wall_ms_per_frame=walls[0] * 1e3 / n,
               device_ms_per_frame=dev_ms,
               device_activities_per_frame=len(device) / n,
               gn_iterations_per_frame=gn.iterations / n,
               busy=dev_ms / (walls[0] * 1e3 / n))
    log(f"# row 1 per frame, {n} frames profiled: "
        f"{out['wall_ms_per_frame']:.2f} ms of wall a frame unprofiled, "
        f"device {dev_ms:.3f} ms in "
        f"{out['device_activities_per_frame']:.0f} activities a frame "
        f"(busy {out['busy']:.3f}), {out['gn_iterations_per_frame']:.2f} "
        "GN iterations a frame")
    log(avg.table(sort_by="self_device_time_total", row_limit=12))
    log(avg.table(sort_by="self_cpu_time_total", row_limit=15))
    return out


def replay_phase(torch):
    """Acceptance rows 1, 2 and 7 at their own width through the port's
    entry points (`pipeline.baseline_runs`): row 1 per frame and fused,
    row 2 through `replay` and `replay_fused`, row 7 through `replay`, row
    1 with kNN covariances and STATISTICAL removal; row 2 once more for
    determinism; a profile of row 1's per-frame path; then nn and moments
    at the per-frame shape."""
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    t0 = time.perf_counter()
    runs = (("1_odometry_only", lambda: bl.config1_odometry_only()),
            ("1_odometry_only_fused",
             lambda: bl.config1_odometry_only(fused=True)),
            ("2_full_graph_slam", lambda: bl.config2_full_slam()),
            ("2_full_graph_slam_fused",
             lambda: bl.config2_full_slam(fused=True)),
            ("7_dynamic_objects", lambda: bl.config7_dynamic_world()),
            ("1_odometry_only_knn_statistical",
             lambda: bl.config1_odometry_only(cfg=knn_statistical_cfg(bl))))
    out, kf_row2 = {}, None
    for name, run in runs:
        m, r = replay_row(torch, name, run)
        check_replay(name, m)
        out[name] = m
        if name == "2_full_graph_slam":
            kf_row2 = r["keyframe_trajectory"]
    for name in ("1_odometry_only", "2_full_graph_slam"):
        a, b = out[name], out[name + "_fused"]
        if not (abs(a["ate_m"] - b["ate_m"]) <= 0.02
                and abs(a["keyframes"] - b["keyframes"]) <= 2):
            raise AssertionError(f"{name}: fused ATE {b['ate_m']:.4f} m / "
                                 f"{b['keyframes']} keyframes against "
                                 f"{a['ate_m']:.4f} m / {a['keyframes']} "
                                 "per frame")
    log("# fused rows within 0.02 m ATE and 2 keyframes of their per-frame "
        "rows")
    again = bl.config2_full_slam()["keyframe_trajectory"]
    if again.shape != kf_row2.shape or not (
            again.view(np.uint32) == kf_row2.view(np.uint32)).all():
        raise AssertionError("row 2 rerun: keyframe poses not bitwise "
                             "identical")
    log("# row 2 rerun: keyframe poses bitwise identical")
    prof = profiled_frames(torch)
    rows = frame_kernel_rows(torch, out["2_full_graph_slam"]["launches"])
    phase_s = time.perf_counter() - t0
    log(f"# replay phase: {phase_s:.1f} s")
    return dict(rows=out, profile=prof, phase_s=phase_s), rows


# ---------------------------------------------------------------------------
# acceptance row 3 and the prior and plane families
# ---------------------------------------------------------------------------

class FloorCalls:
    """Installed over `FloorDetection.detect` for one run: the wall of
    each call (it ends on its one packed host read, so the wall is the
    whole call), the host reads each call made as `sync` (a
    `utils.profiling.SyncAudit`, entered around the run) sees them, the
    accepted detections, and that every call got a cloud on the card.
    Passes every call on."""

    def __init__(self, cls, sync):
        self.cls, self.fn, self.sync = cls, cls.detect, sync
        self.ms, self.reads, self.accepted = [], [], 0

    def __enter__(self):
        calls = self

        def detect(det, cloud, stamp=0.0):
            if not cloud.points.is_cuda:
                raise AssertionError("floor detection got a CPU cloud")
            n0 = calls.sync.count()
            t0 = time.perf_counter()
            out = calls.fn(det, cloud, stamp)
            calls.ms.append((time.perf_counter() - t0) * 1e3)
            calls.reads.append(calls.sync.count() - n0)
            calls.accepted += out is not None
            return out

        self.cls.detect = detect
        return self

    def __exit__(self, *exc):
        self.cls.detect = self.fn


def floor_row(torch):
    """Row 3 through `baseline_runs.config3_floor_augmented` on the card,
    the kernels' counts from 0 just before it -> its metrics, checked:
    ATE within max(ref + 0.05 m, 1.2 ref) of the JAX package's, keyframes
    within 2, loops at least one and within 2, plane edges within
    max(3, 0.1 ref), and one host read in every floor detection call."""
    from mrg_slam_tpu_torch.models.floor_detection import FloorDetection
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl
    from mrg_slam_tpu_torch.utils.profiling import SyncAudit

    sync = SyncAudit("cuda")
    with FloorCalls(FloorDetection, sync) as calls:
        m, r = replay_row(torch, "3_floor_augmented",
                          bl.config3_floor_augmented, REF_FLOOR, sync)
    m.update(plane_edges=r["plane_edges"], detections=calls.accepted,
             detect_calls=len(calls.ms),
             detect_ms_median=float(np.median(calls.ms)),
             detect_ms_max=float(np.max(calls.ms)),
             detect_reads_max=int(np.max(calls.reads)),
             detect_reads_min=int(np.min(calls.reads)))
    log(f"# 3_floor_augmented: {m['plane_edges']} plane edges (JAX CPU "
        f"{REF_FLOOR['plane_edges']}), {m['detections']} of "
        f"{m['detect_calls']} floor detections accepted (JAX CPU "
        f"{REF_FLOOR['detections']}), floor detection "
        f"{m['detect_ms_median']:.2f} ms a call (median; max "
        f"{m['detect_ms_max']:.2f}), {m['detect_reads_min']} to "
        f"{m['detect_reads_max']} host reads a call")
    ref = REF_FLOOR
    lim = max(ref["ate_m"] + 0.05, 1.2 * ref["ate_m"])
    checks = ((m["ate_m"] <= lim, f"ATE {m['ate_m']:.4f} m > {lim:.4f}"),
              (abs(m["keyframes"] - ref["keyframes"]) <= 2,
               f"{m['keyframes']} keyframes, JAX CPU {ref['keyframes']}"),
              (m["loops"] >= 1 and abs(m["loops"] - ref["loops"]) <= 2,
               f"{m['loops']} loops, JAX CPU {ref['loops']}"),
              (abs(m["plane_edges"] - ref["plane_edges"])
               <= max(3, 0.1 * ref["plane_edges"]),
               f"{m['plane_edges']} plane edges, JAX CPU "
               f"{ref['plane_edges']}"),
              (m["launches"]["nn"] > 0 and m["launches"]["moments"] > 0,
               f"a kernel never launched: {m['launches']}"),
              (m["detect_reads_min"] == m["detect_reads_max"] == 1,
               f"floor detection made {m['detect_reads_min']} to "
               f"{m['detect_reads_max']} host reads a call, not one"))
    for ok, what in checks:
        if not ok:
            raise AssertionError(f"3_floor_augmented: {what}")
    return m


def exact_marginals64_planes(torch, g, ridge):
    """The diagonal 6x6 node blocks of (H + ridge I)^-1 over the free
    dofs, planes' included, with H assembled (graph/solve.assemble_dense)
    and inverted in float64 from the float32 linearization."""
    from mrg_slam_tpu_torch.graph import solve

    lin = solve.linearize(g)
    lin = solve.LinearizedGraph(*(a if a is None else a.double()
                                  for a in lin))
    H, _, free = solve.assemble_dense(g._replace(poses=g.poses.double()),
                                      lin)
    idx = torch.nonzero(free.bool())[:, 0]
    inv = torch.zeros_like(H)
    inv[idx[:, None], idx[None, :]] = torch.linalg.inv(
        H[idx][:, idx] + ridge * torch.eye(len(idx), dtype=H.dtype,
                                           device=H.device))
    n = g.n_nodes
    return inv[:6 * n, :6 * n].view(n, 6, n, 6).diagonal(
        dim1=0, dim2=2).permute(2, 0, 1).cpu().numpy()


def family_check(torch, dev):
    """`family_graph_spec(256, seed 0)`: every prior and plane family on
    one ring, solved by the dense, cg and chain backends with 40 LM
    iterations each (timed as the solver section: a warm call, then the
    median of SOLVER_REPS on perturbed poses), chi2 held to the JAX
    package's within 1e-3 and dense against chain; then the marginals of
    the dense-solved graph, each path against the float64 inverse of its
    own system (ROADMAP.md §3 B6): dense (H + 1e-9 I) within MARGINAL_TOL
    of the largest entry, cg (H + 1e-6 I) under the JAX package's bar,
    chain (H + 1e-6 I) within MARGINAL_TOL of the largest entry."""
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph import chain_solver, solve
    from mrg_slam_tpu_torch.graph.builder import GraphSLAM
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    spec = bl.family_graph_spec(FAMILY_NODES, 0)
    out, solved = {}, {}
    for backend in ("dense", "cg", "chain"):
        gs = bl.fill_family_graph(GraphSLAM(
            OptimizerConfig(solver_backend=backend), device=dev,
            **bl.family_graph_capacities(spec)), spec)
        g = gs.snapshot()
        if not (g.planes.is_cuda and g.priors.mask.is_cuda):
            raise AssertionError("family graph not on the card")
        out[backend], res = timed_solve(torch, g, backend, FAMILY_ITERS,
                                        f"family graph {backend}")
        out[backend]["chi2_rel_ref"] = check_chi2(
            f"family {backend}", out[backend]["chi2_final"],
            REF_FAMILY[backend], "the JAX package's")
        solved[backend] = g._replace(poses=res.poses, planes=res.planes)
    out["chain_dense_chi2_rel"] = check_chi2(
        "family chain vs dense", out["chain"]["chi2_final"],
        out["dense"]["chi2_final"], "dense's")
    g = solved["dense"]
    n = g.n_nodes
    want9 = exact_marginals64_planes(torch, g, 1e-9)
    want6 = exact_marginals64_planes(torch, g, CG_RIDGE)
    got = dict(
        dense=solve.marginals(g, exact=True).cpu().numpy(),
        cg=solve.marginals_selected(g, torch.arange(n, device=dev)
                                    ).cpu().numpy(),
        chain=chain_solver.chain_marginals(g, solve.chain_aux_for(g),
                                           solve._chain_K(n)).cpu().numpy())
    for name, cov in got.items():
        want = want9 if name == "dense" else want6
        scale = float(np.abs(want).max())
        err = float(np.abs(cov - want).max())
        if name == "cg":
            bad = int((np.abs(cov - want)
                       > CG_MARG_ATOL + CG_MARG_RTOL * np.abs(want)).sum())
            bar = f"rtol {CG_MARG_RTOL} + atol {CG_MARG_ATOL}"
        else:
            bad = int(err > MARGINAL_TOL * scale)
            bar = f"{MARGINAL_TOL} of the largest entry"
        out[f"marginals_{name}"] = dict(max_abs_err=err, largest=scale,
                                        outside=bad)
        log(f"# family graph {name} marginals ({n} nodes, "
            f"{g.n_planes} planes) against the float64 inverse of "
            f"H + {1e-9 if name == 'dense' else CG_RIDGE} I: max |diff| "
            f"{err:.3e} of {scale:.3e}, {bad} outside {bar}")
        if not np.isfinite(cov).all() or bad:
            raise AssertionError(f"family graph: {name} marginals off the "
                                 "float64 inverse")
    return out


def floor_phase(torch, dev):
    """Row 3 at its width, then the prior and plane solver check."""
    t0 = time.perf_counter()
    out = dict(row3=floor_row(torch), family=family_check(torch, dev))
    out["phase_s"] = time.perf_counter() - t0
    log(f"# floor phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# acceptance rows 4 and 6: two robots exchanging graphs
# ---------------------------------------------------------------------------

class Patched:
    """Installs `attr` of `owner` as `make(original)` while entered."""

    def __init__(self, owner, attr, make):
        self.owner, self.attr = owner, attr
        self.fn = getattr(owner, attr)
        self.make = make

    def __enter__(self):
        setattr(self.owner, self.attr, self.make(self.fn))
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)


class ExchangeLog:
    """What one exchange row's run did, recorded by patches that pass
    every call on: per SharedTick its wall, the nn and moments launches it
    made and its shared stats; the host reads each exchange service call
    made (`on_slam_pose_broadcast`, `handle_publish_graph`, as `sync` sees
    them); the largest covariance pass (one PairRunner prefetch chunk)
    that held merged remote keyframes, and how many remote keyframes were
    prefetched; the largest pair bucket (via BucketRecorder)."""

    def __init__(self, torch, sync):
        from mrg_slam_tpu_torch.models.backend import MrgSlam
        from mrg_slam_tpu_torch.models.coordinator import SharedTick
        from mrg_slam_tpu_torch.models.pair_runner import PairRunner
        from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel
        from mrg_slam_tpu_torch.ops import registration as reg

        self.ticks, self.service_reads = [], []
        self.prefetch, self.remote_prefetched, self.owner = None, 0, None
        self.buckets = BucketRecorder(reg)
        nn, mom = nn_kernel.nn_cuda, stats_kernel.moments_cuda

        def tick_all(fn):
            def call(st, now=0.0):
                n0, m0 = nn.launches, mom.launches
                t0 = time.perf_counter()
                out = fn(st, now)
                stats = [x for x in out.values() if x is not None]
                if stats:
                    s0 = stats[0]
                    self.ticks.append(dict(
                        wall_ms=(time.perf_counter() - t0) * 1e3,
                        loop_closure_ms=s0.loop_closure_us / 1e3,
                        lm_ms=s0.lm_ms, marginals_ms=s0.marginals_ms,
                        pair_rows=sum(r for r, _ in s0.pair_buckets),
                        lm_iterations=max(x.iterations for x in stats),
                        nn=nn.launches - n0, moments=mom.launches - m0))
                return out
            return call

        def counted(fn):
            def call(slam, *a, **kw):
                n0 = sync.count()
                out = fn(slam, *a, **kw)
                self.service_reads.append(sync.count() - n0)
                return out
            return call

        def tick_begin(fn):
            def call(slam, now):
                self.owner = slam.own_name
                return fn(slam, now)
            return call

        def prefetch(fn):
            def call(runner, kfs):
                groups = {}
                for k in kfs:
                    if k.gicp is None and k.cloud.capacity > 0:
                        groups.setdefault(k.cloud.capacity, []).append(k)
                b = runner.PREFETCH_BUCKET
                for g in groups.values():
                    for chunk in (g[i:i + b] for i in range(0, len(g), b)):
                        remote = sum(k.robot_name != self.owner
                                     for k in chunk)
                        self.remote_prefetched += remote
                        if remote and (self.prefetch is None or len(chunk)
                                       > self.prefetch[0].shape[0]):
                            self.prefetch = (
                                torch.stack([k.cloud.points for k in chunk]),
                                torch.stack([k.cloud.mask for k in chunk]))
                return fn(runner, kfs)
            return call

        self.patches = [Patched(SharedTick, "tick_all", tick_all),
                        Patched(MrgSlam, "on_slam_pose_broadcast", counted),
                        Patched(MrgSlam, "handle_publish_graph", counted),
                        Patched(MrgSlam, "_tick_begin", tick_begin),
                        Patched(PairRunner, "prefetch_batch", prefetch),
                        self.buckets]

    def __enter__(self):
        for p in self.patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)


def exchange_row(torch, name, run):
    """One of rows 4 and 6 through the port's entry point, the kernels'
    counts from 0 just before it -> (its metrics, its row dict, its
    ExchangeLog): per robot ATE, keyframes, loops, inter-robot loops,
    merged remote keyframes, graph bytes sent and received, frames/s;
    the aggregate frames/s; per tick the loop-closure, LM and marginals
    ms, pair rows, LM iterations and nn launches; host reads a frame with
    the code lines that make the most; the kernels' launches."""
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.utils.profiling import SyncAudit

    counters = (nn_kernel.nn_cuda, stats_kernel.moments_cuda,
                stats_kernel.count_cuda)
    for fn in counters:
        fn.launches = 0
    sync = SyncAudit("cuda")
    with GnCounter(reg) as gn, ExchangeLog(torch, sync) as xlog, sync:
        r = run()
    n = sum(r["robot_frames"].values())
    reads = sync.count()
    keys = ("keyframes", "loops", "inter_robot_loops", "remote_keyframes",
            "sent_bytes", "received_bytes", "robot_frames", "frames_per_s")
    m = dict(ate_m=r["ate_rmse"], **{k: r[k] for k in keys},
             frames_per_s_total=r["frames_per_s_total"], wall_s=r["wall_s"],
             ticks=xlog.ticks, gn_iterations_per_frame=gn.iterations / n,
             host_reads_per_frame=reads / n,
             host_read_sources=[[w, c / n] for w, c in sync_top(sync)],
             service_calls=len(xlog.service_reads),
             service_reads=int(sum(xlog.service_reads)),
             remote_keyframes_prefetched=xlog.remote_prefetched,
             launches=dict(zip(("nn", "moments", "count"),
                               (fn.launches for fn in counters))),
             ref=REF_EXCHANGE[name])
    ref = m["ref"]
    for rob in r["robot_frames"]:
        log(f"# {name} {rob}: ATE {m['ate_m'][rob]:.4f} m (JAX CPU "
            f"{ref['ate_m'][rob]:.4f}), keyframes {m['keyframes'][rob]} "
            f"({ref['keyframes'][rob]}), loops {m['loops'][rob]} "
            f"({ref['loops'][rob]}), inter-robot loops "
            f"{m['inter_robot_loops'][rob]} ({ref['inter_robot_loops'][rob]})"
            f", remote keyframes merged {m['remote_keyframes'][rob]} "
            f"({ref['remote_keyframes'][rob]}), graph bytes sent "
            f"{m['sent_bytes'][rob]} / received {m['received_bytes'][rob]} "
            f"({ref['sent_bytes'][rob]} / {ref['received_bytes'][rob]}); "
            f"{m['frames_per_s'][rob]:.2f} frames/s over "
            f"{m['robot_frames'][rob]} frames")
    for i, t in enumerate(xlog.ticks):
        log(f"# {name} tick {i}: loop closure {t['loop_closure_ms']:.1f} ms"
            f", LM {t['lm_ms']:.1f} ms, marginals {t['marginals_ms']:.1f} "
            f"ms ({t['wall_ms']:.1f} ms in all), {t['pair_rows']} pair rows"
            f", {t['lm_iterations']} LM iterations, {t['nn']} nn and "
            f"{t['moments']} moments launches")
    log(f"# {name}: {m['frames_per_s_total']:.2f} frames/s aggregate over "
        f"{n} robot-frames ({m['wall_s']:.1f} s, the last tick outside); "
        f"GN iterations {m['gn_iterations_per_frame']:.2f} and host reads "
        f"{m['host_reads_per_frame']:.2f} a frame; {m['service_calls']} "
        f"exchange service calls made {m['service_reads']} host reads; "
        f"{xlog.remote_prefetched} merged keyframes prefetched; launches "
        f"{m['launches']}; reads a frame by line: "
        + ", ".join(f"{w} {c:.2f}" for w, c in m["host_read_sources"]))
    return m, r, xlog


def check_exchange(name, m):
    """Row 4: every robot with a loop, loops within max(2, 0.2 ref) and
    keyframes within 2 of ref's, ATE at most ref + MR_ATE_SPREAD (the
    multi-robot run-to-run spread), a remote keyframe merged. Row 6: ATE
    at most max(ref + 0.05 m, 1.2 ref), inter-robot loops at least one and
    within max(3, 0.3 ref), keyframes within 2. Both: nn and moments
    launched, the exchange services read nothing from the card."""
    ref = m["ref"]
    bad = []
    for rob, ate in m["ate_m"].items():
        r_ate, r_kf = ref["ate_m"][rob], ref["keyframes"][rob]
        if abs(m["keyframes"][rob] - r_kf) > 2:
            bad.append(f"{rob}: {m['keyframes'][rob]} keyframes, JAX CPU "
                       f"{r_kf}")
        if name.startswith("4_"):
            lim = r_ate + MR_ATE_SPREAD
            loops, r_loops = m["loops"][rob], ref["loops"][rob]
            if not (loops >= 1 and abs(loops - r_loops)
                    <= max(2, 0.2 * r_loops)):
                bad.append(f"{rob}: {loops} loops, JAX CPU {r_loops}")
        else:
            lim = max(r_ate + 0.05, 1.2 * r_ate)
            inter, r_inter = (m["inter_robot_loops"][rob],
                              ref["inter_robot_loops"][rob])
            if not (inter >= 1 and abs(inter - r_inter)
                    <= max(3, 0.3 * r_inter)):
                bad.append(f"{rob}: {inter} inter-robot loops, JAX CPU "
                           f"{r_inter}")
        if not ate <= lim:
            bad.append(f"{rob}: ATE {ate:.4f} m > {lim:.4f}")
    if name.startswith("4_") and not sum(m["remote_keyframes"].values()):
        bad.append("no remote keyframe merged")
    if m["launches"]["nn"] <= 0 or m["launches"]["moments"] <= 0:
        bad.append(f"a kernel never launched: {m['launches']}")
    if m["service_reads"]:
        bad.append(f"the exchange services made {m['service_reads']} host "
                   "reads")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))


def optimize_many_check(torch, graphs):
    """Row 6's final graphs solved in one batched LM (graph/builder.
    optimize_many), then each alone: chi2 within 1e-5 relative, and the
    batch's host reads exactly one an LM iteration plus the packed read
    (the snapshots' uploads, two a graph, not counted)."""
    import copy
    import inspect

    from mrg_slam_tpu_torch.graph import builder
    from mrg_slam_tpu_torch.utils.profiling import SyncAudit

    batch = [copy.deepcopy(g) for g in graphs]
    alone = [copy.deepcopy(g) for g in graphs]
    src, first = inspect.getsourcelines(builder._upload)
    upload = range(first, first + len(src))
    t0 = time.perf_counter()
    with SyncAudit("cuda") as sync:
        builder.optimize_many(batch)
    batch_ms = (time.perf_counter() - t0) * 1e3
    reads = [(f, line) for f, line, _ in sync.sites
             if not (f == builder.__file__ and line in upload)]
    t0 = time.perf_counter()
    for g in alone:
        g.optimize()
    alone_ms = (time.perf_counter() - t0) * 1e3
    iters = max(g.last_iterations for g in batch)
    rel = [abs(a.chi2_final - b.chi2_final) / max(b.chi2_final, 1e-12)
           for a, b in zip(batch, alone)]
    out = dict(batch_ms=batch_ms, alone_ms=alone_ms, lm_iterations=iters,
               reads=len(reads), chi2=[g.chi2_final for g in batch],
               chi2_alone=[g.chi2_final for g in alone], chi2_rel=rel,
               nodes=[g.num_nodes for g in batch],
               iterations=[g.last_iterations for g in batch],
               iterations_alone=[g.last_iterations for g in alone])
    log(f"# optimize_many on row 6's final graphs ({out['nodes']} nodes): "
        f"{batch_ms:.1f} ms batched against {alone_ms:.1f} ms one by one; "
        f"chi2 {out['chi2']} against {out['chi2_alone']} (rel {rel}); LM "
        f"iterations {out['iterations']} ({out['iterations_alone']} alone); "
        f"{len(reads)} host reads besides the uploads for {iters} LM "
        "iterations")
    if not all(x <= 1e-5 for x in rel):
        raise AssertionError(f"optimize_many: chi2 off the per-graph solves "
                             f"by {rel}")
    if len(reads) != iters + 1:
        raise AssertionError(
            f"optimize_many: {len(reads)} host reads for {iters} LM "
            "iterations and the packed read: "
            f"{[(w.filename, w.lineno) for w in reads]}")
    return out


def exchange_kernel_rows(torch, bucket, prefetch, launches):
    """nn at the largest merged pair bucket of rows 4 and 6 (its rows'
    first sweep; also every 4th row frozen and the stride-2 coarse rows),
    bitwise to nn_plain; moments at the largest covariance pass that held
    merged remote keyframes (radius 1.0, make_source's), within the
    float32 summation bound and MOMENTS_EXCHANGE_TOL; each timed as the
    other rows, with its launches over rows 4 and 6."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import pad_invalid
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl
    from mrg_slam_tpu_torch.utils import se3

    where = "rows 4 and 6"
    tgts, srcs, inits = bucket
    dev = tgts[0].points.device
    init = torch.from_numpy(inits).to(dev)
    p_src = se3.pose_apply(init[:, None, :], torch.stack(
        [c.points for c in srcs])).contiguous()
    p_sm = torch.stack([c.mask for c in srcs]).contiguous()
    t_m = torch.stack([c.mask for c in tgts]).contiguous()
    p_tgt = pad_invalid(torch.stack([c.points for c in tgts]),
                        t_m).contiguous()
    frozen = p_sm.clone()
    frozen[::4] = False
    check_nn(torch, nk, p_src, p_tgt, "exchange pair bucket, frozen",
             frozen, t_m)
    coarse = [x[:, ::2].contiguous() for x in (p_src, p_tgt, p_sm, t_m)]
    check_nn(torch, nk, coarse[0], coarse[1], "exchange pair bucket, coarse",
             coarse[2], coarse[3])
    err = check_nn(torch, nk, p_src, p_tgt, "exchange pair bucket", p_sm,
                   t_m)
    log(f"# nn at the largest merged pair bucket of {where}: "
        f"{p_src.shape[0]} rows x {p_src.shape[1]} lanes, real sources "
        f"{int(p_sm.sum(-1).min())}-{int(p_sm.sum(-1).max())}: bitwise == "
        "plain on every lane, also with every 4th row frozen and on the "
        "stride-2 coarse rows")
    real = [(a[ma], b[mb]) for a, b, ma, mb in zip(p_src, p_tgt, p_sm, t_m)]

    def lib_nn():
        return [torch.cdist(a[None], b[None],
                            compute_mode="donot_use_mm_for_euclid_dist"
                            ).min(dim=-1) for a, b in real]

    pairs = float((p_sm.sum(-1).double() * t_m.sum(-1).double()).sum())
    rows = [timed_row(
        torch, "nn_pairs_exchange", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(p_src, p_tgt, p_sm, t_m),
        lambda: nk.nn_plain(p_src, p_tgt, p_sm, t_m), lib_nn,
        launches["nn"], err,
        *bound(pairs, 9, 0, (p_src.numel() + p_tgt.numel()) * 4
               + p_src.shape[0] * p_src.shape[1] * 12), where=where)]

    pts, mask = (x.contiguous() for x in prefetch)
    r2 = sk.radius_sq(bl._base_cfg().slam.registration.reg_covariance_radius)
    err, inside = check_moments(torch, sk, pts, r2, "exchange prefetch",
                                mask)
    log(f"# moments at the merged keyframes' covariance pass: "
        f"{pts.shape[0]} x {pts.shape[1]} lanes, max |err| {err:.3g} "
        f"(bar {MOMENTS_EXCHANGE_TOL})")
    if not err <= MOMENTS_EXCHANGE_TOL:
        raise AssertionError(f"moments exchange prefetch: {err} > "
                             f"{MOMENTS_EXCHANGE_TOL}")
    feats = torch.cat([torch.ones_like(pts[..., :1]), pts,
                       *(pts[..., a:a + 1] * pts[..., b:b + 1]
                         for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                      (2, 2)))], dim=-1)
    pts_real = [p[m] for p, m in zip(pts, mask)]
    feats_real = [f[m] for f, m in zip(feats, mask)]
    radius = float(bl._base_cfg().slam.registration.reg_covariance_radius)

    def lib_moments():
        return [(torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
                 <= radius).float() @ f for p, f in zip(pts_real, feats_real)]

    n_real = mask.sum(-1).double()
    rows.append(timed_row(
        torch, "moments_prefetch_exchange",
        "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:93",
        lambda: sk.moments_cuda(pts, pts, r2, mask, mask),
        lambda: sk.moments_plain(pts, pts, r2, mask, mask), lib_moments,
        launches["moments"], err,
        *bound(float((n_real * n_real).sum()), 9, 16 * inside,
               pts.numel() * 4 + pts.shape[0] * pts.shape[1] * 40),
        where=where))
    return rows


def exchange_phase(torch):
    """Acceptance rows 4 and 6 at their width through the port's
    `baseline_runs` (`replay_multirobot` with SharedTick), each held to
    the JAX package's CPU run of the same frames; row 6 again for
    determinism (keyframe poses bit for bit) and with serial ticks
    (`coordinate=False`: keyframes equal, loops within 1, trajectories
    within 0.1 m); `optimize_many` on row 6's final graphs; then nn and
    moments at this path's shapes."""
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    t0 = time.perf_counter()
    out, launches = {}, {"nn": 0, "moments": 0}
    bucket, prefetch = None, None
    rows6 = None
    for name, run in (("4_two_robot_exchange", bl.config4_two_robot),
                      ("6_reversed_encounter",
                       bl.config6_reversed_encounter)):
        m, r, xlog = exchange_row(torch, name, run)
        check_exchange(name, m)
        out[name] = m
        for k in launches:
            launches[k] += m["launches"][k]
        big = xlog.buckets.largest
        if big is not None and (bucket is None or len(big[0])
                                > len(bucket[0])):
            bucket = big
        if xlog.prefetch is not None and (
                prefetch is None
                or xlog.prefetch[0].shape[0] > prefetch[0].shape[0]):
            prefetch = xlog.prefetch
        if name.startswith("6_"):
            rows6 = r
    if prefetch is None:
        raise AssertionError("no merged remote keyframe was prefetched")

    again = bl.config6_reversed_encounter()
    for rob, kf in rows6["keyframe_trajectory"].items():
        kf2 = again["keyframe_trajectory"][rob]
        if kf2.shape != kf.shape or not (kf2.view(np.uint32)
                                         == kf.view(np.uint32)).all():
            raise AssertionError(f"row 6 rerun: {rob}'s keyframe poses not "
                                 "bitwise identical")
    log("# row 6 rerun: both robots' keyframe poses bitwise identical")

    serial = bl.config6_reversed_encounter(coordinate=False)
    cmp = {}
    for rob, kf in rows6["keyframe_trajectory"].items():
        kf_s = serial["keyframe_trajectory"][rob]
        l_c, l_s = rows6["loops"][rob], serial["loops"][rob]
        ok = kf_s.shape == kf.shape
        d = float(np.abs(kf_s[:, :3] - kf[:, :3]).max()) if ok else None
        cmp[rob] = dict(keyframes=(len(kf), len(kf_s)), loops=(l_c, l_s),
                        max_pose_diff_m=d, ate_serial_m=serial["ate_rmse"][rob],
                        frames_per_s_serial=serial["frames_per_s"][rob])
        log(f"# row 6 {rob}, SharedTick against serial ticks: keyframes "
            f"{len(kf)} / {len(kf_s)}, loops {l_c} / {l_s}, keyframe poses "
            f"within {d} m; serial ATE {serial['ate_rmse'][rob]:.4f} m, "
            f"{serial['frames_per_s'][rob]:.2f} frames/s")
        if not (ok and abs(l_c - l_s) <= 1 and d < 0.1):
            raise AssertionError(f"row 6 {rob}: SharedTick differs from "
                                 f"serial ticks: {cmp[rob]}")
    log(f"# row 6 aggregate frames/s: SharedTick "
        f"{rows6['frames_per_s_total']:.2f}, serial ticks "
        f"{serial['frames_per_s_total']:.2f}")
    om = optimize_many_check(torch, list(rows6["graphs"].values()))
    rows = exchange_kernel_rows(torch, bucket, prefetch, launches)
    phase_s = time.perf_counter() - t0
    log(f"# exchange phase: {phase_s:.1f} s")
    return dict(rows=out, serial=cmp,
                serial_frames_per_s_total=serial["frames_per_s_total"],
                optimize_many=om, launches=launches,
                phase_s=phase_s), rows


def _changed_fields(cfg, default):
    """The plain (not dataclass) fields of `cfg` that differ from
    `default`, tuples as lists: what a user's YAML would say."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if not dataclasses.is_dataclass(v) and v != getattr(default, f.name):
            out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def launch_engine_config():
    """The CLI's config in the launch phase: bench's make_configs() and
    make_slam_config() (131072 raw -> 8192 points, RADIUS removal,
    SMALL_GICP with radius covariances, a dense LM) as an EngineConfig."""
    from mrg_slam_tpu_torch.config import EngineConfig

    pre, odo = make_configs()
    return EngineConfig(model_namespace="bench", prefilter=pre,
                        odometry=odo, slam=make_slam_config(odo))


def config_yaml(cfg, drop=()):
    """An EngineConfig as a YAML dict in the reference's layout
    (`<section>: {ros__parameters: {...}}`, config/mrg_slam.yaml), each
    section holding the fields that differ from the defaults, less the
    keys in `drop` (given on the command line instead)."""
    from mrg_slam_tpu_torch.config import EngineConfig

    base = EngineConfig()
    odo = {**_changed_fields(cfg.odometry, base.odometry),
           **_changed_fields(cfg.odometry.registration,
                             base.odometry.registration)}
    slam = _changed_fields(cfg.slam, base.slam)
    for name in ("optimizer", "loop", "inf_matrix", "registration", "gps",
                 "imu", "floor_coeffs", "exchange"):
        slam.update(_changed_fields(getattr(cfg.slam, name),
                                    getattr(base.slam, name)))
    sections = {"prefiltering_component": _changed_fields(cfg.prefilter,
                                                          base.prefilter),
                "scan_matching_odometry_component": odo,
                "floor_detection_component": _changed_fields(cfg.floor,
                                                             base.floor),
                "mrg_slam_component": slam}
    out = {"/**": {"ros__parameters": {"model_namespace":
                                        cfg.model_namespace}}}
    for name, params in sections.items():
        out[name] = {"ros__parameters": {k: v for k, v in params.items()
                                         if k not in drop}}
    return out


def launch_yaml():
    """launch_engine_config() as a YAML dict, less the keys that
    LAUNCH_OVERRIDES gives on the command line."""
    return config_yaml(launch_engine_config(),
                       [t.split(":=")[0] for t in LAUNCH_OVERRIDES])


def launch_argv(config, bag, out, fused=False):
    """The launch phase's session 1 command line (after `python -m
    mrg_slam_tpu_torch.launch`)."""
    return (["--config", str(config), "--dataset", "rosbag", "--bag",
             str(bag), "--topic", LAUNCH_TOPIC, "--tick-every",
             str(LAUNCH_TICK), "--output", str(out)]
            + (["--fused"] if fused else []) + list(LAUNCH_OVERRIDES))


def session2_init_pose(traj, se3np):
    """Frame LAUNCH_FRAMES's true pose in session 1's map frame (whose
    origin is frame 0's pose)."""
    return init_pose_of(se3np.pose_between(traj[0], traj[LAUNCH_FRAMES]))


def inter_robot_loops(db, name=None):
    """Loop edges whose ends belong to different robots (with `name`: of
    which one is `name`'s)."""
    def robots(e):
        return {db.uuid_keyframe_map[e.from_uuid].robot_name,
                db.uuid_keyframe_map[e.to_uuid].robot_name}
    return sum(1 for e in db.edges if e.type == "loop"
               and len(robots(e)) == 2 and (name is None or name in robots(e)))


def keyframe_ate(kfs, traj, ate_rmse):
    """ATE of (stamp, 7-pose) keyframe estimates against the ground truth
    at their frames (a frame every 0.1 s), Umeyama-aligned, as bench.py
    evaluates full SLAM."""
    kfs = sorted(kfs, key=lambda sp: sp[0])
    idx = [int(round(st / 0.1)) for st, _ in kfs]
    est = np.stack([np.asarray(p, np.float64) for _, p in kfs])
    return float(ate_rmse(est[:, :3], traj[idx, :3]))


def own_keyframes(db, name):
    """(stamp, optimized pose) of `name`'s own keyframes in a store."""
    return [(k.stamp, k.estimate(db.graph))
            for k in db.keyframes + db.new_keyframes
            if k.robot_name == name and k.odom_counter >= 0]


def saved_keyframes(directory):
    """(stamp, saved estimate) of every keyframe of a graph directory."""
    from pathlib import Path

    out = []
    for kdir in sorted((Path(directory) / "keyframes").iterdir()):
        meta = dict(line.split(" ", 1) for line in
                    (kdir / "data.txt").read_text().splitlines())
        out.append((float(meta["stamp"]),
                    np.asarray(meta["estimate"].split(), np.float32)))
    return out


def session2_counts(db):
    """Session 2's store: its own keyframes, merged (loaded) keyframes,
    loop edges and loop edges to loaded keyframes."""
    kfs = [k for k in db.keyframes + db.new_keyframes]
    return dict(
        keyframes=sum(k.robot_name == SESSION2 for k in kfs),
        merged_keyframes=sum(k.robot_name != SESSION2 for k in kfs),
        loops=sum(1 for e in db.edges if e.type == "loop"),
        loaded_loops=inter_robot_loops(db, SESSION2))


def fleet_metrics(robots, traj, ate_rmse):
    """Per robot of the fleet run: keyframes (its own), loops, inter-robot
    loops, remote keyframes merged and the ATE of its own keyframes'
    optimized poses (`keyframe_ate`)."""
    out = {}
    for name, robot in robots.items():
        db = robot.slam.db
        kfs = db.keyframes + db.new_keyframes
        out[name] = dict(
            keyframes=sum(k.robot_name == name for k in kfs),
            remote_keyframes=sum(k.robot_name != name for k in kfs),
            loops=sum(1 for e in db.edges if e.type == "loop"),
            inter_robot_loops=inter_robot_loops(db),
            ate_m=keyframe_ate(own_keyframes(db, name), traj, ate_rmse))
    return out


class LaunchLog:
    """What the launch phase's runs did, recorded by patches that pass
    every call on: the host time spent decoding bag messages (in the
    reader's generator) and the frames decoded; per PairRunner prefetch
    chunk (one moments launch) whether it held loaded keyframes, and the
    largest such chunk; the largest pair bucket (via BucketRecorder)."""

    def __init__(self, torch):
        from mrg_slam_tpu_torch.io import rosbag
        from mrg_slam_tpu_torch.models.pair_runner import PairRunner
        from mrg_slam_tpu_torch.ops import registration as reg

        self.decode_s, self.decoded = 0.0, 0
        self.chunks, self.loaded_chunks, self.prefetch = 0, 0, None
        self.buckets = BucketRecorder(reg)

        def pointclouds(fn):
            def call(bag, topic):
                it = fn(bag, topic)
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    finally:
                        self.decode_s += time.perf_counter() - t0
                    self.decoded += 1
                    yield item
            return call

        def prefetch(fn):
            def call(runner, kfs):
                groups = {}
                for k in kfs:
                    if k.gicp is None and k.cloud.capacity > 0:
                        groups.setdefault(k.cloud.capacity, []).append(k)
                b = runner.PREFETCH_BUCKET
                for g in groups.values():
                    for chunk in (g[i:i + b] for i in range(0, len(g), b)):
                        self.chunks += 1
                        if not any(k.estimate_loaded is not None
                                   for k in chunk):
                            continue
                        self.loaded_chunks += 1
                        if self.prefetch is None or (
                                len(chunk) > self.prefetch[0].shape[0]):
                            self.prefetch = (
                                torch.stack([k.cloud.points for k in chunk]),
                                torch.stack([k.cloud.mask for k in chunk]))
                return fn(runner, kfs)
            return call

        self.patches = [Patched(rosbag.BagReader, "pointclouds", pointclouds),
                        Patched(PairRunner, "prefetch_batch", prefetch),
                        self.buckets]

    def __enter__(self):
        for p in self.patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)


def _launch_counters():
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel

    return (("nn", nn_kernel.nn_cuda), ("count", stats_kernel.count_cuda),
            ("moments", stats_kernel.moments_cuda))


def _same_tree(a, b):
    """Byte-identical `keyframes/` and `edges/` of two graph directories
    (file names and contents) -> number of files compared."""
    import filecmp
    from pathlib import Path

    n = 0
    for sub in ("keyframes", "edges"):
        fa = sorted(p.relative_to(a) for p in (Path(a) / sub).rglob("*")
                    if p.is_file())
        fb = sorted(p.relative_to(b) for p in (Path(b) / sub).rglob("*")
                    if p.is_file())
        if fa != fb:
            raise AssertionError(f"save -> load -> save: {sub}/ holds other "
                                 "files")
        for f in fa:
            if not filecmp.cmp(Path(a) / f, Path(b) / f, shallow=False):
                raise AssertionError(f"save -> load -> save: {f} differs")
        n += len(fa)
    return n


def check_cli_outputs(out, summary, frames, min_points=1):
    """The CLI's output contract: the TUM trajectory a line a frame, a
    map PCD holding summary["map_points"] points (at least `min_points`),
    a graph directory of summary["keyframes"] keyframes, a PLY and the
    summary's keys."""
    keys = {"frames", "keyframes", "loops", "ate_rmse", "rpe_rmse",
            "frames_per_s", "map_points"}
    bad = []
    if set(summary) != keys:
        bad.append(f"summary keys {sorted(summary)}")
    if summary["frames"] != frames:
        bad.append(f"{summary['frames']} frames, {frames} in the input")
    tum = np.loadtxt(out / "trajectory_tum.txt", ndmin=2)
    if tum.shape != (frames, 8) or not np.isfinite(tum).all():
        bad.append(f"trajectory_tum.txt {tum.shape}")
    pcd = (out / "map.pcd").read_bytes()
    head, _, body = pcd.partition(b"DATA binary\n")
    n = summary["map_points"]
    if (f"POINTS {n}\n".encode() not in head or len(body) != 12 * n
            or n < min_points):
        bad.append(f"map.pcd does not hold {n} points")
    kfs = len(list((out / "graph" / "keyframes").iterdir()))
    if kfs != summary["keyframes"] or not (out / "graph" / "graph.g2o"
                                           ).exists():
        bad.append(f"graph/ holds {kfs} keyframes, summary "
                   f"{summary['keyframes']}")
    if not (out / "graph.ply").read_bytes().startswith(b"ply\n"):
        bad.append("graph.ply")
    if bad:
        raise AssertionError("CLI outputs: " + "; ".join(bad))


def _within(name, got, ref, band, at_least_one=False):
    """got within `band` of ref (and >= 1 when asked) or a message."""
    if abs(got - ref) > band or (at_least_one and got < 1):
        return [f"{name} {got}, JAX CPU {ref}"]
    return []


def _ate_bound(ref):
    return max(ref + 0.05, 1.2 * ref)


def check_launch(m):
    """Sessions 1 and 2 and the fleet against REF_LAUNCH: ATE at most
    max(ref + 0.05 m, 1.2 ref), keyframes within 2, loops within
    max(2, 0.2 ref) (at least one where the JAX package has one), loops
    to loaded keyframes in the same band, the fleet's inter-robot loops
    within max(3, 0.3 ref) and at least one; every kernel launched."""
    bad = []
    for part in ("session1", "session2"):
        got, ref = m[part], REF_LAUNCH[part]
        if not got["ate_m"] <= _ate_bound(ref["ate_m"]):
            bad.append(f"{part} ATE {got['ate_m']:.4f} m > "
                       f"{_ate_bound(ref['ate_m']):.4f}")
        bad += _within(f"{part} keyframes", got["keyframes"],
                       ref["keyframes"], 2)
        bad += _within(f"{part} loops", got["loops"], ref["loops"],
                       max(2, 0.2 * ref["loops"]), ref["loops"] >= 1)
    ref = REF_LAUNCH["session2"]
    bad += _within("session2 loops to loaded keyframes",
                   m["session2"]["loaded_loops"], ref["loaded_loops"],
                   max(2, 0.2 * ref["loaded_loops"]),
                   ref["loaded_loops"] >= 1)
    if m["session2"]["merged_keyframes"] != m["session1"]["keyframes"]:
        bad.append(f"session2 merged {m['session2']['merged_keyframes']} "
                   f"keyframes of session 1's {m['session1']['keyframes']}")
    for name in FLEET_NAMES:
        got, ref = m["fleet"][name], REF_LAUNCH["fleet"][name]
        if not got["ate_m"] <= _ate_bound(ref["ate_m"]):
            bad.append(f"fleet {name} ATE {got['ate_m']:.4f} m > "
                       f"{_ate_bound(ref['ate_m']):.4f}")
        bad += _within(f"fleet {name} keyframes", got["keyframes"],
                       ref["keyframes"], 2)
        bad += _within(f"fleet {name} loops", got["loops"], ref["loops"],
                       max(2, 0.2 * ref["loops"]), ref["loops"] >= 1)
        bad += _within(f"fleet {name} inter-robot loops",
                       got["inter_robot_loops"], ref["inter_robot_loops"],
                       max(3, 0.3 * ref["inter_robot_loops"]), True)
    for part in ("sessions", "fleet"):
        if not all(v > 0 for k, v in m["launches"][part].items()
                   if part == "sessions" or k != "count"):
            bad.append(f"{part}: a kernel never launched: "
                       f"{m['launches'][part]}")
    if bad:
        raise AssertionError("launch phase: " + "; ".join(bad))


def launch_device_share(torch, cfg, frames, work, n=8, warm=4):
    """Session 1's per-frame path (its config, a fresh `Robot`) on frames
    warm .. warm + n after `warm` warm-up frames, once unprofiled (wall)
    and once under the port's `utils.profiling.trace`: wall and device
    time a frame (the sum of the device activities), the device-busy
    share of the unprofiled wall, and the Chrome trace it wrote. The
    kernels' counts are put back as they were: the sessions' counts
    leave these frames out."""
    from mrg_slam_tpu_torch.pipeline.replay import Robot
    from mrg_slam_tpu_torch.utils import profiling

    counts = [(fn, fn.launches) for _, fn in _launch_counters()]

    def steps(robot, idx):
        for i in idx:
            robot.step(*frames[i])
        torch.cuda.synchronize()

    for traced in (False, True):
        robot = Robot(cfg)
        steps(robot, range(warm))
        if traced:
            with profiling.trace(str(work / "trace")) as prof:
                steps(robot, range(warm, warm + n))
        else:
            t0 = time.perf_counter()
            steps(robot, range(warm, warm + n))
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
    for fn, c in counts:
        fn.launches = c
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / n
    trace = work / "trace" / "trace.json"
    out = dict(frames=n, wall_ms_per_frame=wall_ms,
               device_ms_per_frame=dev_ms,
               device_activities_per_frame=len(device) / n,
               busy=dev_ms / wall_ms, trace_bytes=trace.stat().st_size)
    log(f"# launch session 1, {n} frames traced (utils.profiling.trace): "
        f"{wall_ms:.2f} ms of wall a frame unprofiled, device "
        f"{dev_ms:.3f} ms in {out['device_activities_per_frame']:.0f} "
        f"activities a frame: device busy {out['busy']:.3f}; Chrome trace "
        f"{out['trace_bytes'] / 2**20:.1f} MiB")
    return out


def launch_sessions(torch, inp, work):
    """(a) session 1 through the CLI from a bag, (b) save -> load -> save
    of its graph on the card, (c) session 2 continuing from it, the
    kernels' counts from 0 just before (a) and read just after (c).
    -> (metrics, LaunchLog of (c), frame 0's scan)."""
    import yaml

    from mrg_slam_tpu_torch import launch
    from mrg_slam_tpu_torch.config import EngineConfig
    from mrg_slam_tpu_torch.io.rosbag import write_bag
    from mrg_slam_tpu_torch.models import persistence
    from mrg_slam_tpu_torch.models.backend import MrgSlam
    from mrg_slam_tpu_torch.pipeline.replay import Robot, replay
    from mrg_slam_tpu_torch.utils import se3np
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse
    from mrg_slam_tpu_torch.utils.profiling import SyncAudit
    from mrg_slam_tpu_torch.utils.tum import load_tum

    n1 = LAUNCH_FRAMES
    raw = inp.raw[:SLAM_FRAMES].cpu().numpy()
    rmask = inp.rmask[:SLAM_FRAMES].cpu().numpy()
    frames = [(i * 0.1, raw[i][rmask[i]]) for i in range(SLAM_FRAMES)]
    del raw, rmask
    traj = inp.traj
    t0 = time.perf_counter()
    bag = work / "session1.db3"
    write_bag(str(bag), LAUNCH_TOPIC, frames[:n1])
    bag_s = time.perf_counter() - t0
    config = work / "launch.yaml"
    config.write_text(yaml.safe_dump(launch_yaml()))
    cfg = EngineConfig.from_yaml_dict(launch._apply_overrides(
        yaml.safe_load(config.read_text()),
        launch._parse_overrides(LAUNCH_OVERRIDES)))
    if cfg != launch_engine_config():
        raise AssertionError("the launch YAML with its overrides is not "
                             "bench's config")
    log(f"# launch: bag of {n1} frames ({bag.stat().st_size / 2**20:.1f} "
        f"MiB) written in {bag_s:.1f} s; YAML + {list(LAUNCH_OVERRIDES)} "
        "== bench's configs")

    counters = _launch_counters()
    for _, fn in counters:
        fn.launches = 0
    out1 = work / "session1"
    sync = SyncAudit("cuda")
    with LaunchLog(torch) as log1, sync:
        t0 = time.perf_counter()
        rc = launch.main(launch_argv(config, bag, out1))
        s1_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"launch.main returned {rc}")
    summary = json.loads((out1 / "summary.json").read_text())
    check_cli_outputs(out1, summary, n1)
    _, poses = load_tum(out1 / "trajectory_tum.txt")
    s1 = dict(ate_m=keyframe_ate(saved_keyframes(out1 / "graph"), traj,
                                 ate_rmse),
              ate_frames_m=float(ate_rmse(poses[:, :3], traj[:n1, :3])),
              keyframes=summary["keyframes"], loops=summary["loops"],
              map_points=summary["map_points"],
              frames_per_s=summary["frames_per_s"], wall_s=s1_s,
              decode_ms_per_frame=log1.decode_s / max(log1.decoded, 1) * 1e3,
              host_reads_per_frame=sync.count() / n1,
              host_read_sources=[[w, c / n1] for w, c in sync_top(sync)],
              launches={k: fn.launches for k, fn in counters})
    ref = REF_LAUNCH["session1"]
    log(f"# launch session 1 (CLI, rosbag, per frame): {n1} frames at "
        f"{s1['frames_per_s']:.2f} frames/s ({s1_s:.1f} s in launch.main, "
        f"outputs included); keyframe ATE {s1['ate_m']:.4f} m (JAX CPU "
        f"{ref['ate_m']:.4f}), per-frame ATE of trajectory_tum.txt "
        f"{s1['ate_frames_m']:.4f} m ({ref['ate_frames_m']:.4f}), keyframes "
        f"{s1['keyframes']} "
        f"({ref['keyframes']}), loops {s1['loops']} ({ref['loops']}), map "
        f"points {s1['map_points']} ({ref['map_points']}); bag decode "
        f"{s1['decode_ms_per_frame']:.2f} ms a frame (host), host reads "
        f"{s1['host_reads_per_frame']:.2f} a frame; launches "
        f"{s1['launches']}; reads a frame by line: "
        + ", ".join(f"{w} {c:.2f}" for w, c in s1["host_read_sources"]))
    s1["device_share"] = launch_device_share(torch, cfg, frames, work)

    # (b) save -> load -> flush (no optimize) -> save, on the card
    slam = MrgSlam(cfg.slam)
    loaded = persistence.load_graph(slam, out1 / "graph")
    slam.db.flush_loaded_graph(slam.loop_detector.loop_manager)
    with SyncAudit("cuda") as sync_save:
        t0 = time.perf_counter()
        persistence.save_graph(slam, work / "graph_again")
        save_ms = (time.perf_counter() - t0) * 1e3
    files = _same_tree(out1 / "graph", work / "graph_again")
    persist = dict(keyframes=loaded, files=files, save_ms=save_ms,
                   save_reads=sync_save.count())
    log(f"# launch persistence: session 1's graph loaded ({loaded} "
        f"keyframes), flushed and saved again on the card: {files} files "
        f"of keyframes/ and edges/ byte-identical; the save took "
        f"{save_ms:.1f} ms and {persist['save_reads']} host reads")
    del slam

    # (c) session 2: a fresh stack loads session 1's graph and goes on
    cfg2 = dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, own_name=SESSION2, multi_robot_names=(SESSION2,),
        init_pose=session2_init_pose(traj, se3np)))
    with LaunchLog(torch) as log2:
        t0 = time.perf_counter()
        robot = Robot(cfg2)
        persistence.load_graph(robot.slam, out1 / "graph")
        res = replay(robot, frames[n1:], tick_every=LAUNCH_TICK)
        s2_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters}
    s2 = dict(ate_m=keyframe_ate(own_keyframes(robot.slam.db, SESSION2),
                                 traj, ate_rmse),
              **session2_counts(robot.slam.db),
              frames_per_s=res.frames_per_s, wall_s=s2_s,
              prefetch_chunks_loaded=log2.loaded_chunks,
              launches={k: launches[k] - s1["launches"][k]
                        for k in launches})
    ref = REF_LAUNCH["session2"]
    log(f"# launch session 2 (load_graph, replay of frames {n1}-"
        f"{SLAM_FRAMES - 1}): keyframe ATE {s2['ate_m']:.4f} m (JAX CPU "
        f"{ref['ate_m']:.4f}), own keyframes {s2['keyframes']} "
        f"({ref['keyframes']}), merged {s2['merged_keyframes']} "
        f"({ref['merged_keyframes']}), loops {s2['loops']} ({ref['loops']}),"
        f" loops to loaded keyframes {s2['loaded_loops']} "
        f"({ref['loaded_loops']}); {s2['frames_per_s']:.2f} frames/s; "
        f"{log2.loaded_chunks} covariance passes over loaded keyframes; "
        f"launches {s2['launches']}")
    if log2.prefetch is None:
        raise AssertionError("no covariance pass held loaded keyframes")
    moments_frame = (launches["moments"] - log1.chunks - log2.chunks)
    return (dict(session1=s1, persistence=persist, session2=s2,
                 launches=launches, moments_frame_launches=moments_frame,
                 prefetch_launches=log2.loaded_chunks),
            log2, frames[0][1])


def launch_fleet(torch, work):
    """(d) the fleet bag through `run_fleet_from_bag`, then the CLI's
    --robots path on the same bag for its output contract; (e) the CLI on
    tests/data/kitti_mini. -> metrics."""
    import yaml

    from mrg_slam_tpu_torch import launch
    from mrg_slam_tpu_torch.io.rosbag import write_multi_bag
    from mrg_slam_tpu_torch.io.synthetic import circle_trajectory
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl
    from mrg_slam_tpu_torch.pipeline.bagfleet import run_fleet_from_bag
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse

    world = bl._world()
    traj = circle_trajectory(FLEET_FRAMES, radius=14.0, laps=1.0)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    a, b = FLEET_NAMES
    bag = work / "fleet.db3"
    write_multi_bag(str(bag), {
        f"/{a}/velodyne_points": frames[:FLEET_WINDOW],
        f"/{b}/velodyne_points": frames[FLEET_START_B:]})
    cfg = bl._base_cfg()
    cfg = dataclasses.replace(cfg, slam=dataclasses.replace(
        cfg.slam, exchange=dataclasses.replace(
            cfg.slam.exchange, graph_request_min_time_delay=0.5,
            graph_request_min_accum_dist=1.0)))
    counters = _launch_counters()
    for _, fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    robots, results = run_fleet_from_bag(
        cfg, str(bag), list(FLEET_NAMES), tick_every=FLEET_TICK,
        init_poses={a: init_pose_of(traj[0]),
                    b: init_pose_of(traj[FLEET_START_B])})
    wall = time.perf_counter() - t0
    fleet = fleet_metrics(robots, traj, ate_rmse)
    launches = {k: fn.launches for k, fn in counters}
    for name in FLEET_NAMES:
        f, ref = fleet[name], REF_LAUNCH["fleet"][name]
        log(f"# launch fleet {name}: keyframe ATE {f['ate_m']:.4f} m (JAX "
            f"CPU {ref['ate_m']:.4f}), keyframes {f['keyframes']} "
            f"({ref['keyframes']}), loops {f['loops']} ({ref['loops']}), "
            f"inter-robot loops {f['inter_robot_loops']} "
            f"({ref['inter_robot_loops']}), remote keyframes "
            f"{f['remote_keyframes']} ({ref['remote_keyframes']}); "
            f"{results[name].frames_per_s:.2f} frames/s")
    log(f"# launch fleet: {wall:.1f} s, launches {launches}")

    config = work / "fleet.yaml"
    config.write_text(yaml.safe_dump(config_yaml(cfg)))
    out = work / "fleet_cli"
    rc = launch.main(["--config", str(config), "--dataset", "rosbag",
                      "--bag", str(bag), "--robots", ",".join(FLEET_NAMES),
                      "--tick-every", str(FLEET_TICK), "--output", str(out)])
    cli = json.loads((out / "summary.json").read_text())
    keys = {"frames", "keyframes", "loops", "inter_robot_loops"}
    if rc != 0 or list(cli) != list(FLEET_NAMES) or any(
            set(v) != keys or v["frames"] != FLEET_WINDOW
            or len(list((out / n / "graph" / "keyframes").iterdir()))
            != v["keyframes"] for n, v in cli.items()):
        raise AssertionError(f"launch --robots: rc {rc}, summary {cli}")
    log(f"# launch --robots (CLI, no init poses): {json.dumps(cli)}")

    out = work / "kitti"
    rc = launch.main(["--dataset", "kitti", "--kitti-root",
                      os.path.join(ROOT, "tests", "data", "kitti_mini"),
                      "--tick-every", "2", "--output", str(out),
                      "capacity_raw_points:=128",
                      "capacity_filtered_points:=64",
                      "capacity_keyframe_points:=64",
                      "capacity_keyframes:=16", "capacity_edges:=64",
                      "outlier_removal_method:=NONE",
                      "downsample_resolution:=0.05"])
    kitti = json.loads((out / "summary.json").read_text())
    if rc != 0:
        raise AssertionError(f"launch --dataset kitti returned {rc}")
    check_cli_outputs(out, kitti, 3, min_points=0)
    log(f"# launch --dataset kitti (kitti_mini): {json.dumps(kitti)}")
    return dict(fleet, wall_s=wall, launches=launches, cli=cli,
                kitti=kitti)


def launch_kernel_rows(torch, m, log2, scan0):
    """count and moments at the per-frame path's shape at this width (one
    frame of 8192 lanes: frame 0's voxel grid output for count, its
    prefiltered cloud for moments), moments at the largest covariance
    pass over loaded keyframes (K x 8192), nn at session 2's largest pair
    bucket; each held to its plain version (count exact, nn bitwise,
    moments within the summation bound and MOMENTS_ULPS float32 steps of
    X^2) and timed as the other rows."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import downsample_stage, prefilter
    from mrg_slam_tpu_torch.utils import se3

    cfg = launch_engine_config()
    pre = cfg.prefilter
    pc = PointCloud.from_array(scan0, pre.capacity_raw_points)
    base = torch.from_numpy(cfg.lidar2base.pose7()).to(pc.points.device)
    vox = downsample_stage(pc, pre, base_transform=base)
    c_pts, c_mask = vox.points[None].contiguous(), vox.mask[None].contiguous()
    r2c = sk.radius_sq(pre.radius_radius)
    err_c, c_plain = check_count(torch, sk, c_pts, c_mask, r2c,
                                 "one frame at 8192")
    c_real = c_pts[0][c_mask[0]]
    rad_c = float(pre.radius_radius)

    def lib_count():
        d = torch.cdist(c_real, c_real,
                        compute_mode="donot_use_mm_for_euclid_dist")
        return ((d <= rad_c) & (d > 0)).sum(-1)

    where = "sessions 1 and 2"
    rows = [timed_row(
        torch, "count_frame_8192", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:34",
        lambda: sk.count_cuda(c_pts, c_mask, r2c),
        lambda: sk.count_plain(c_pts, c_mask, r2c), lib_count,
        m["launches"]["count"], err_c,
        *bound(float(c_plain.double().sum()), 11, 0,
               c_pts.numel() * 4 + c_mask.numel() * 5), where=where)]

    def moments_row(name, pts, mask, radius, launches, what, where):
        r2 = sk.radius_sq(radius)
        err, inside = check_moments(torch, sk, pts, r2, what, mask)
        x = float(pts[mask].abs().max())
        bar = max(MOMENTS_EXCHANGE_TOL,
                  MOMENTS_ULPS * float(np.spacing(np.float32(x * x))))
        log(f"# moments {what}: max |err| {err:.3g}, bar {bar:.3g} "
            f"({MOMENTS_ULPS} float32 steps of X^2, X = {x:.1f} m)")
        if not err <= bar:
            raise AssertionError(f"moments {what}: {err} > {bar}")
        feats = torch.cat([torch.ones_like(pts[..., :1]), pts,
                           *(pts[..., i:i + 1] * pts[..., j:j + 1]
                             for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                          (1, 2), (2, 2)))], dim=-1)
        real = [(p[k], f[k]) for p, f, k in zip(pts, feats, mask)]

        def lib():
            return [(torch.cdist(p, p,
                                 compute_mode="donot_use_mm_for_euclid_dist")
                     <= radius).float() @ f for p, f in real]

        n_real = mask.sum(-1).double()
        return timed_row(
            torch, name, "mrg_slam_tpu_torch/csrc/radius_stats.cu",
            "mrg_slam_tpu/ops/pallas_stats.py:93",
            lambda: sk.moments_cuda(pts, pts, r2, mask, mask),
            lambda: sk.moments_plain(pts, pts, r2, mask, mask), lib,
            launches, err,
            *bound(float((n_real * n_real).sum()), 9, 16 * inside,
                   pts.numel() * 4 + pts.shape[0] * pts.shape[1] * 40),
            where=where)

    blk = prefilter(pc, pre, base_transform=base)
    f_pts = pad_invalid(blk.points, blk.mask)[None].contiguous()
    f_mask = blk.mask[None].contiguous()
    rows.append(moments_row(
        "moments_frame_8192", f_pts, f_mask,
        float(cfg.odometry.registration.reg_covariance_radius),
        m["moments_frame_launches"], "one frame at 8192",
        "sessions 1 and 2 (per-frame odometry)"))
    p_pts, p_mask = (x.contiguous() for x in log2.prefetch)
    p_pts = pad_invalid(p_pts, p_mask).contiguous()
    rows.append(moments_row(
        "moments_prefetch_loaded", p_pts, p_mask,
        float(cfg.slam.registration.reg_covariance_radius),
        m["prefetch_launches"], "loaded keyframes' covariance pass",
        "session 2 (passes over loaded keyframes)"))
    log(f"# moments at the loaded keyframes' covariance pass: "
        f"{p_pts.shape[0]} x {p_pts.shape[1]} lanes")

    tgts, srcs, inits = log2.buckets.largest
    init = torch.from_numpy(inits).to(tgts[0].points.device)
    p_src = se3.pose_apply(init[:, None, :], torch.stack(
        [c.points for c in srcs])).contiguous()
    p_sm = torch.stack([c.mask for c in srcs]).contiguous()
    t_m = torch.stack([c.mask for c in tgts]).contiguous()
    p_tgt = pad_invalid(torch.stack([c.points for c in tgts]),
                        t_m).contiguous()
    err = check_nn(torch, nk, p_src, p_tgt, "session 2 pair bucket", p_sm,
                   t_m)
    log(f"# nn at session 2's largest pair bucket: {p_src.shape[0]} rows x "
        f"{p_src.shape[1]} lanes: bitwise == plain on every lane")
    real = [(s[ms], t[mt]) for s, t, ms, mt in zip(p_src, p_tgt, p_sm, t_m)]

    def lib_nn():
        return [torch.cdist(s[None], t[None],
                            compute_mode="donot_use_mm_for_euclid_dist"
                            ).min(dim=-1) for s, t in real]

    pairs = float((p_sm.sum(-1).double() * t_m.sum(-1).double()).sum())
    rows.append(timed_row(
        torch, "nn_pairs_loaded", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(p_src, p_tgt, p_sm, t_m),
        lambda: nk.nn_plain(p_src, p_tgt, p_sm, t_m), lib_nn,
        m["launches"]["nn"], err,
        *bound(pairs, 9, 0, (p_src.numel() + p_tgt.numel()) * 4
               + p_src.shape[0] * p_src.shape[1] * 12), where=where))
    return rows


def launch_phase(torch, inp):
    """The launch path on the card: (a) session 1 through `python -m
    mrg_slam_tpu_torch.launch` (in process) from a bag of the first
    LAUNCH_FRAMES frames of the full-SLAM world at bench's production
    width, with bench's configs as a reference-layout YAML and
    LAUNCH_OVERRIDES; (b) its graph saved, loaded, flushed and saved
    again byte for byte; (c) session 2 loading it and replaying the
    frames after it; (d) the fleet bag through run_fleet_from_bag and
    the CLI's --robots; (e) the CLI on kitti_mini. Each held to
    tools/launch_reference.py's numbers (REF_LAUNCH); then the kernel
    rows of this path's new shapes."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        m, log2, scan0 = launch_sessions(torch, inp, work)
        fl = launch_fleet(torch, work)
    m["fleet"] = {n: fl[n] for n in FLEET_NAMES}
    m["fleet_wall_s"], m["fleet_cli"], m["kitti"] = (
        fl["wall_s"], fl["cli"], fl["kitti"])
    m["launches"] = dict(sessions=m["launches"], fleet=fl["launches"])
    check_launch(m)
    rows = launch_kernel_rows(torch, dict(
        launches=m["launches"]["sessions"],
        moments_frame_launches=m.pop("moments_frame_launches"),
        prefetch_launches=m.pop("prefetch_launches")), log2, scan0)
    m["phase_s"] = time.perf_counter() - t0
    log(f"# launch phase: {m['phase_s']:.1f} s")
    return m, rows


class FrontEndInputs(NamedTuple):
    traj: np.ndarray   # (SLAM_FRAMES, 7) ground-truth poses
    raw: object        # (SLAM_FRAMES, RAW, 3) float32 scans on the card
    rmask: object      # (SLAM_FRAMES, RAW) bool
    stamps: object     # (SLAM_FRAMES,) float32 seconds
    pre: object        # PrefilterConfig
    odo: object        # ScanMatchingOdometryConfig


class FrontEndRun(NamedTuple):
    poses: object        # (n_frames, 7)
    iterations: object   # (n_frames,) GN iterations
    keyframes: object    # (n_frames,) bool
    block_walls: list    # wall seconds of each block, sync to sync


def front_end_inputs(torch, dev):
    """bench.py's production world and front-end configs on the card."""
    traj, raw, rmask = build_world()
    pre, odo = make_configs()
    return FrontEndInputs(
        traj, torch.from_numpy(raw).to(dev), torch.from_numpy(rmask).to(dev),
        torch.arange(len(traj), dtype=torch.float32, device=dev) * 0.1, pre,
        odo)


def front_end(torch, inp, n_frames=FRAMES, split=None):
    """Blocks of BLOCK frames through the port's prefilter and run_batch,
    from a fresh carry, as bench.py:253-265 drives the JAX package. The
    stream is synced at each block's end to time it; with `split` (a
    dict), a sync between the two stages adds each stage's wall time."""
    from mrg_slam_tpu_torch.models import odometry_fused as fused
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter

    carry = fused.init_carry(FILTERED, device=inp.raw.device)
    poses, iters, kfs, walls = [], [], [], []
    torch.cuda.synchronize()
    for s in range(0, n_frames, BLOCK):
        t0 = time.perf_counter()
        c = prefilter(PointCloud(inp.raw[s:s + BLOCK],
                                 inp.rmask[s:s + BLOCK]), inp.pre)
        if split is not None:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            split["prefilter"] = split.get("prefilter", 0) + t1 - t0
        carry, outs = fused.run_batch(inp.odo, carry, c.points, c.mask,
                                      inp.stamps[s:s + BLOCK])
        torch.cuda.synchronize()
        if split is not None:
            split["odometry"] = (split.get("odometry", 0)
                                 + time.perf_counter() - t1)
        walls.append(time.perf_counter() - t0)
        poses.append(outs.pose)
        iters.append(outs.iterations)
        kfs.append(outs.is_new_keyframe)
    return FrontEndRun(torch.cat(poses), torch.cat(iters), torch.cat(kfs),
                       walls)


def uniform_input(torch, dev, n, rng):
    """±45 m uniform points with duplicates and a masked tail."""
    pts = rng.uniform(-45, 45, size=(n, 3)).astype(np.float32)
    pts[n // 2:n // 2 + 256] = pts[:256]  # exact duplicates: ties, d2 == 0
    mask = np.ones(n, bool)
    mask[-n // 16:] = False
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))


def check_nn(torch, nk, src, tgt, name, *masks):
    """Bitwise on every lane, the fixed (inf, 0) of the masked source
    lanes included; `masks` are nn_cuda's source and target masks."""
    d_k, i_k = nk.nn_cuda(src, tgt, *masks)
    d_p, i_p = nk.nn_plain(src, tgt, *masks)
    torch.cuda.synchronize()
    if not torch.equal(i_k, i_p):
        raise AssertionError(f"nn {name}: {(i_k != i_p).sum().item()} "
                             "indices differ from the plain version")
    # bitwise: the same float32 bits, infinities included
    if not torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)):
        raise AssertionError(f"nn {name}: d2 not bitwise equal")
    fin = torch.isfinite(d_p)
    return float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0


def check_count(torch, sk, pts, mask, r2, name):
    """Exact on every lane, 0 on the masked ones; -> (max |error|, the
    plain counts)."""
    c_k = sk.count_cuda(pts, mask, r2)
    c_p = sk.count_plain(pts, mask, r2)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"count {name}: {(c_k != c_p).sum().item()} "
                             "counts differ from the plain version")
    if mask is not None and not (c_k[~mask] == 0).all():
        raise AssertionError(f"count {name}: masked lanes are not 0")
    return float((c_k - c_p).abs().max()), c_p


def count_hard_rows(torch, dev, sk, rng, r2):
    """Rows that bin badly or sit on the cell rule's edge -> (name,
    points, mask) for check_count: every point in one cell; pairs at the
    radius (d2 within a few float32 steps of r^2 either side), each
    crossing a cell face, at up to +-45 m; an all-masked row beside a
    full one."""
    c, _ = sk.count_cell(r2)
    one = (rng.uniform(0.01, 0.3, (2, 3000, 3)) + 7 * c).astype(np.float32)
    k = FILTERED // 2
    v = rng.normal(size=(4, k, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a = rng.integers(-89, 89, (4, k, 3)) * c - 0.25 * v
    s = np.sqrt(r2) * (1 + rng.integers(-4, 5, (4, k, 1)) * 2.0 ** -22)
    pairs = np.concatenate([a, a + s * v], 1).astype(np.float32)
    half = rng.uniform(-45, 45, (2, FILTERED, 3)).astype(np.float32)
    half_mask = np.zeros((2, FILTERED), bool)
    half_mask[0] = True
    return [(name, torch.from_numpy(x).to(dev),
             None if m is None else torch.from_numpy(m).to(dev))
            for name, x, m in (("one cell", one, None),
                               ("pairs at the radius", pairs, None),
                               ("all-masked row", half, half_mask))]


def check_moments(torch, sk, pts, r2, name, mask=None):
    """Counts exact; mean and cov within the float32 summation bound.

    The kernel sums neighbours in index order, the plain version through
    a matmul in another order. Two orders of an n-term float32 sum of
    terms up to X differ by at most ~2 n u X (u = 2^-24), so
    mean <= 2 n u X and, through cov = M2/n - mean mean^T with its
    cancellation, cov <= 2 n u X^2 + 2 X (mean bound); X = max |coord|
    over the real points, n = the largest neighbour count. With masks,
    the masked lanes must hold zeros.
    """
    m_k = sk.moments_cuda(pts, pts, r2, mask, mask)
    m_p = sk.moments_plain(pts, pts, r2, mask, mask)
    torch.cuda.synchronize()
    errs = moments_errors(torch, sk, pts, mask, m_k, m_p, name)
    e_mean, tol_mean, e_cov, tol_cov, n, x, total = errs
    log(f"# moments {name}: |mean| err {e_mean:.3g} (tol {tol_mean:.3g}), "
        f"|cov| err {e_cov:.3g} (tol {tol_cov:.3g}), n<={n:.0f}, X={x:.1f}")
    return max(e_mean, e_cov), total


def moments_errors(torch, sk, pts, mask, m_k, m_p, name):
    """check_moments' test of the kernel's moments m_k against the plain
    version's m_p -> (mean error, its bound, cov error, its bound, n, X,
    the neighbour count over the real lanes); raises beyond a bound."""
    if mask is None:
        real = (pts.abs() < 1e5).all(-1)  # moments of pad lanes are unused
    else:
        real = mask
        if not (m_k[~mask] == 0).all():
            raise AssertionError(f"moments {name}: masked lanes are not "
                                 "zero")
    c_k, mean_k, cov_k = sk.moments_to_mean_cov(m_k)
    c_p, mean_p, cov_p = sk.moments_to_mean_cov(m_p)
    if not torch.equal(c_k[real], c_p[real]):
        raise AssertionError(f"moments {name}: counts differ")
    n = float(c_k[real].max())
    x = float(pts[real].abs().max())
    tol_mean = 2 * n * U32 * x
    tol_cov = 2 * n * U32 * x * x + 2 * x * tol_mean
    e_mean = float((mean_k - mean_p)[real].abs().max())
    e_cov = float((cov_k - cov_p)[real].abs().max())
    if not (e_mean <= tol_mean and e_cov <= tol_cov):
        raise AssertionError(f"moments {name}: beyond tolerance: |mean| "
                             f"err {e_mean:.3g} (tol {tol_mean:.3g}), |cov| "
                             f"err {e_cov:.3g} (tol {tol_cov:.3g})")
    return e_mean, tol_mean, e_cov, tol_cov, n, x, float(c_k[real].sum())


# ragged rows for the mask checks: (name, where the source rows' valid
# lanes end, the same for the targets, lanes, hole lanes); B = 3 rows that
# end at different lanes, a row with no valid lane, holes, ends on no tile
# boundary
RAGGED = (("ragged rows", (997, 3, 0), (1, 640, 999), 1000, ()),
          ("holes", (700, 129, 257), (300, 513, 1), 800, (5, 128, 129, 255)))


def ragged_rows(torch, dev, rng, ends, n, holes):
    """Rows of n lanes whose valid lanes end at `ends`, `holes` masked;
    half of each row a dense cluster. -> (points with the masked lanes at
    PAD_VALUE, the same points unpadded, mask)."""
    from mrg_slam_tpu_torch.ops.cloud import pad_invalid

    pts = rng.uniform(-45, 45, (len(ends), n, 3)).astype(np.float32)
    pts[:, n // 2:] = pts[:, n // 2:] * 0.02 + 30.0
    mask = np.arange(n)[None, :] < np.asarray(ends)[:, None]
    mask[:, list(holes)] = False
    for r, e in enumerate(ends):
        if e:
            mask[r, e - 1] = True
    mask = torch.from_numpy(mask).to(dev)
    pts = torch.from_numpy(pts).to(dev)
    return pad_invalid(pts, mask).contiguous(), pts, mask


def launch_floor_ms(torch, native):
    """An empty kernel (csrc/launch_floor.cu): its CUDA-event time around
    one call, and its device time per launch in a CUDA graph."""
    fn = native.library("launch_floor").mrg_empty

    def empty():
        native.check_rc(fn(native.stream_ptr(torch.device("cuda"))), "empty")

    return cuda_ms(torch, empty), graph_ms(torch, empty)


def kernel_phase(torch, dev, block_pts, block_mask, nn_src, nn_tgt,
                 count_pts, count_mask, count_long):
    """Hold every kernel against its plain version; time all three.

    `block_mask` marks the real points of `block_pts`, the first block
    after prefilter (frame 0 is the nn target, frame 1 its source); nn
    and moments get the rows' masks, as on the main path. Count runs
    before RADIUS removal, on the same block's voxel grid output
    `count_pts` with its mask `count_mask`; `count_long` is the same at
    the port's default capacity (points, mask). The bounds count only what
    these inputs need: the pairs of real points for nn and moments (pad
    lanes' results are never read), the pairs within the radius for
    count (any exact search does at least those)."""
    from mrg_slam_tpu_torch.ops import native
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import pad_invalid

    rng = np.random.default_rng(0)
    u_pts, u_mask = uniform_input(torch, dev, FILTERED, rng)
    u_pad = pad_invalid(u_pts, u_mask)[None].contiguous()
    src_u = torch.from_numpy(rng.uniform(-45, 45, (FILTERED, 3)).astype(
        np.float32)).to(dev)[None]
    src_u[0, :256] = u_pts[:256]  # sources sitting on duplicated targets
    check_nn(torch, nk, src_u, u_pad, "uniform")
    empty = torch.full_like(u_pad, 1.0e6)
    d_e, i_e = nk.nn_cuda(src_u, empty)
    if not (torch.isinf(d_e).all() and (i_e == 0).all()):
        raise AssertionError("nn: an all-masked target must give inf, 0")
    r2c, r2m = sk.radius_sq(0.5), sk.radius_sq(0.6)
    for name, s_ends, t_ends, n_lanes, holes in RAGGED:
        src_p, src_r, sm = ragged_rows(torch, dev, rng, s_ends, n_lanes,
                                       holes)
        tgt_p, tgt_r, tm = ragged_rows(torch, dev, rng, t_ends, n_lanes,
                                       holes)
        check_nn(torch, nk, src_p, tgt_p, name, sm, tm)
        check_nn(torch, nk, src_r, tgt_r, name + ", unpadded", sm, tm)
        check_moments(torch, sk, src_p, r2m, name, sm)
        check_moments(torch, sk, src_r, r2m, name + ", unpadded", sm)
    # the main path's lanes: each frame's mask
    nn_masks = (block_mask[1:2].contiguous(), block_mask[0:1].contiguous())
    check_nn(torch, nk, nn_src, nn_tgt, "real, every lane")
    err_nn = check_nn(torch, nk, nn_src, nn_tgt, "real", *nn_masks)
    check_count(torch, sk, u_pts[None], u_mask[None], r2c, "uniform")
    check_count(torch, sk, u_pad, None, r2c, "uniform, every lane")
    for name, s_ends, _, n_lanes, holes in RAGGED:
        src_p, src_r, sm = ragged_rows(torch, dev, rng, s_ends, n_lanes,
                                       holes)
        check_count(torch, sk, src_p, sm, r2c, name)
        check_count(torch, sk, src_r, sm, r2c, name + ", unpadded")
        check_count(torch, sk, src_p, None, r2c, name + ", every lane")
    for name, pts, mask in count_hard_rows(torch, dev, sk, rng, r2c):
        check_count(torch, sk, pts, mask, r2c, name)
    check_count(torch, sk, count_pts, None, r2c, "voxel block, every lane")
    err_c, c_plain = check_count(torch, sk, count_pts, count_mask, r2c,
                                 "voxel block")
    check_moments(torch, sk, u_pad, r2m, "uniform")
    check_moments(torch, sk, block_pts, r2m, "real block, every lane")
    err_m, inside = check_moments(torch, sk, block_pts, r2m, "real block",
                                  block_mask)
    log("# kernels == plain versions on the card (nn bitwise on every lane, "
        "counts exact, moments within the f32 summation bound; with and "
        "without masks; count on the voxel block, rows in one cell, pairs "
        "at the radius across cell faces and an all-masked row)")

    # the library yardsticks compute the same function: pairs of real
    # points (their lanes found on the host here, outside the path)
    real = [m.nonzero().squeeze(1) for m in block_mask]
    feats = torch.cat([torch.ones_like(block_pts[..., :1]), block_pts,
                       *(block_pts[..., a:a + 1] * block_pts[..., b:b + 1]
                         for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                      (2, 2)))], dim=-1)

    nn_src_real, nn_tgt_real = nn_src[:, real[1]], nn_tgt[:, real[0]]

    def lib_nn():
        d = torch.cdist(nn_src_real, nn_tgt_real,
                        compute_mode="donot_use_mm_for_euclid_dist")
        return d.min(dim=-1)

    # the exact-difference cdist refuses a batch of 32 x 8192 rows (its
    # grid overflows), so the yardsticks run it frame by frame
    count_real = [p[m] for p, m in zip(count_pts, count_mask)]

    def lib_count():
        return [((d <= 0.5) & (d > 0)).sum(-1) for d in (
            torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
            for p in count_real)]

    pts_real = [p[r] for p, r in zip(block_pts, real)]
    feats_real = [f[r] for f, r in zip(feats, real)]

    def lib_moments():
        return [(torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
                 <= 0.6).float() @ f for p, f in zip(pts_real, feats_real)]

    b, n, _ = block_pts.shape
    n_real = block_mask.sum(-1).double()
    pairs_nn = float(n_real[1] * n_real[0])
    pairs_blk = float((n_real * n_real).sum())
    log(f"# real points per frame {int(n_real.min())}-{int(n_real.max())} "
        f"of {n}; in-radius (0.6 m) real pairs {inside:.0f}")
    # count's input: every lane of the voxel grid's output is valid
    c_lanes = count_mask.sum(-1).double()
    pairs_c = float(c_plain.double().sum())  # ordered pairs within 0.5 m
    c_per = c_plain[count_mask].double()
    brute_ms = bound(float((c_lanes * c_lanes).sum()), 11, 0, 0)[0]
    log(f"# count input (voxel grid output): valid lanes per frame "
        f"{int(c_lanes.min())}-{int(c_lanes.max())} of "
        f"{count_pts.shape[1]}; in-radius (0.5 m) pairs {pairs_c:.0f}, "
        f"neighbours per point mean {float(c_per.mean()):.3f}, max "
        f"{int(c_per.max())}; a sweep of every valid pair would be bound "
        f"at {brute_ms:.4f} ms (operations)")
    # the port's default capacity: rows longer than a block's shared
    # memory holds, binned in global memory (exact on 8 rows, timed on 32)
    long_pts, long_mask = count_long
    check_count(torch, sk, long_pts[:8].contiguous(),
                long_mask[:8].contiguous(), r2c, "default capacity")
    long_ms = graph_ms(torch, lambda: sk.count_cuda(long_pts, long_mask,
                                                    r2c))
    long_lanes = long_mask.sum(-1)
    log(f"# count at the default capacity ({long_pts.shape[1]} lanes, "
        f"{int(long_lanes.min())}-{int(long_lanes.max())} valid a row, "
        f"bins in global memory): == plain on 8 rows; {long_ms:.4f} ms a "
        f"launch in a CUDA graph for {long_pts.shape[0]} rows")
    floor_ms = launch_floor_ms(torch, native)
    rows = []
    for name, src, fk, fp, flib, pairs, opp, extra, out_b, repl in (
            ("nn", "mrg_slam_tpu_torch/csrc/nn.cu",
             lambda: nk.nn_cuda(nn_src, nn_tgt, *nn_masks),
             lambda: nk.nn_plain(nn_src, nn_tgt, *nn_masks), lib_nn,
             pairs_nn, 9, 0, nn_src.shape[1] * 12,
             "mrg_slam_tpu/ops/pallas_nn.py:48"),
            ("count", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
             lambda: sk.count_cuda(count_pts, count_mask, r2c),
             lambda: sk.count_plain(count_pts, count_mask, r2c), lib_count,
             pairs_c, 11, 0, count_mask.numel() * 5,
             "mrg_slam_tpu/ops/pallas_stats.py:34"),
            ("moments", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
             lambda: sk.moments_cuda(block_pts, block_pts, r2m, block_mask,
                                     block_mask),
             lambda: sk.moments_plain(block_pts, block_pts, r2m, block_mask,
                                      block_mask),
             lib_moments, pairs_blk, 9, 16 * inside, b * n * 40,
             "mrg_slam_tpu/ops/pallas_stats.py:93")):
        in_b = {"nn": (nn_src.numel() + nn_tgt.numel()) * 4,
                "count": count_pts.numel() * 4}.get(name,
                                                    block_pts.numel() * 4)
        bms, by = bound(pairs, opp, extra, in_b + out_b)
        ms = cuda_ms(torch, fk)
        device_ms = graph_ms(torch, fk)
        plain_ms = cuda_ms(torch, fp)
        lib_ms = cuda_ms(torch, flib)
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=None,
                         max_abs_err={"nn": err_nn, "count": err_c,
                                      "moments": err_m}[name],
                         ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=lib_ms))
        # the launch floor: no launch, however small, takes less
        log(f"# {name}: kernel {ms:.4f} ms around one call "
            f"({device_ms:.4f} ms a launch in a CUDA graph), plain "
            f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}); launch floor: an empty kernel takes {floor_ms[0]:.4f} "
            f"ms around one call, {floor_ms[1]:.4f} ms a launch in a CUDA "
            "graph")
    return rows


def sync_cost(torch, odo, src, tgt):
    """Host sync per Gauss-Newton iteration: 12 iterations with the exit
    flag read after each, against the same 12 with one sync at the end."""
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.utils import se3

    params = odo.registration
    ridge = reg.hessian_ridge(src.points.device)

    def run(read_flag):
        pose = se3.pose_identity(src.points.device)
        for _ in range(12):
            xi, *_ = reg._gn_step(params, src, tgt, pose, ridge)
            pose = se3.pose_retract(pose, xi)
            if read_flag:
                bool(torch.linalg.vector_norm(xi) < 0)
        torch.cuda.synchronize()

    out = {}
    for mode in (False, True, True, False):
        run(mode)  # warm
        t0 = time.perf_counter()
        run(mode)
        out.setdefault(mode, []).append(time.perf_counter() - t0)
    per = (min(out[True]) - min(out[False])) / 12 * 1e3
    log(f"# host sync per GN iteration: {per:.4f} ms "
        f"(12 iters {min(out[True]) * 1e3:.3f} ms with the flag read, "
        f"{min(out[False]) * 1e3:.3f} ms without)")
    return per

class SlamRun(NamedTuple):
    slam: object      # the MrgSlam after the last tick
    ticks: list       # one dict per tick
    wall: float       # seconds, first block to the last tick's end
    growth: list      # (tick, node capacity, edge capacity) after growth


def LM_COUNTERS(lm_dense):
    """The dense LM's kernel wrappers, in LM_KERNELS' order."""
    return (lm_dense.linearize_cuda, lm_dense.assemble_cuda,
            lm_dense.trial_cuda)


LM_KERNELS = ("lm_linearize", "lm_assemble", "lm_trial")


def full_slam(torch, inp, slam_cfg, profile_tick=None):
    """bench.py:200-223 through the port, on the first SLAM_FRAMES frames:
    per block of BLOCK frames, prefilter and run_batch, process_scan per
    frame (the front end's covariances reused, as bench.py does when
    covariance_compatible) and one optimization_tick. With `profile_tick`
    (a dict), the last tick runs under torch.profiler and the dict gets
    its device time, wall and top ops."""
    from mrg_slam_tpu_torch.graph import lm_dense
    from mrg_slam_tpu_torch.models import odometry_fused as fused
    from mrg_slam_tpu_torch.models.backend import MrgSlam
    from mrg_slam_tpu_torch.ops import nn_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter

    covs_ok = reg.covariance_compatible(inp.odo.registration,
                                        slam_cfg.registration)
    dev = inp.raw.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam = MrgSlam(slam_cfg, device=dev)
    carry = fused.init_carry(FILTERED, device=dev)
    ticks, growth = [], []
    for s in range(0, SLAM_FRAMES, BLOCK):
        c = prefilter(PointCloud(inp.raw[s:s + BLOCK],
                                 inp.rmask[s:s + BLOCK]), inp.pre)
        carry, outs = fused.run_batch(inp.odo, carry, c.points, c.mask,
                                      inp.stamps[s:s + BLOCK])
        poses = outs.pose.cpu().numpy()  # one read per block
        for i in range(poses.shape[0]):
            slam.process_scan((s + i) * 0.1, poses[i],
                              PointCloud(c.points[i], c.mask[i]),
                              source_covs=outs.covs[i] if covs_ok else None)
        cap0, nn0 = slam.db.graph.cap, nn_kernel.nn_cuda.launches
        lm0 = [fn.launches for fn in LM_COUNTERS(lm_dense)]
        last = s + BLOCK >= SLAM_FRAMES
        t1 = time.perf_counter()
        if profile_tick is not None and last:
            st = profiled_tick(torch, slam, (s + BLOCK) * 0.1, profile_tick)
        else:
            st = slam.optimization_tick(now=(s + BLOCK) * 0.1)
        wall = time.perf_counter() - t1
        if st is None:
            raise AssertionError(f"tick {s // BLOCK}: no keyframe in its "
                                 "block, nothing to do")
        nn_ticks = nn_kernel.nn_cuda.launches - nn0
        ticks.append(dict(
            wall_ms=wall * 1e3, loop_closure_ms=st.loop_closure_us / 1e3,
            optimize_ms=st.optimization_us / 1e3, lm_ms=st.lm_ms,
            marginals_ms=st.marginals_ms, lm_iterations=st.iterations,
            loops=st.num_loops, pair_rows=sum(r for r, _ in st.pair_buckets),
            gn_iterations_per_bucket=[g for _, g in st.pair_buckets],
            nn_launches=nn_ticks,
            lm_fused_iterations=st.lm_fused_iterations,
            # the LM kernels' launches and the store's node capacity the
            # tick's solve ran at
            lm_launches=[fn.launches - n0 for fn, n0
                         in zip(LM_COUNTERS(lm_dense), lm0)],
            nodes_cap=slam.db.graph.cap["nodes"],
            # the tick's host reads, counted from where the code reads:
            # one per GN sweep and one per bucket (together the nn
            # launches: each bucket's fitness pass stands for its read),
            # one per LM iteration and the solve's packed read
            host_reads=nn_ticks + st.iterations + 1))
        if slam.db.graph.cap != cap0:
            growth.append((s // BLOCK, slam.db.graph.cap["nodes"],
                           slam.db.graph.cap["edges"]))
    return SlamRun(slam, ticks, time.perf_counter() - t0, growth)


def profiled_tick(torch, slam, now, out):
    """One optimization_tick under torch.profiler: device time (the sum
    of the device activities), wall, device activities and top ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = slam.optimization_tick(now=now)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    avg = prof.key_averages()
    out.update(device_ms=sum(e.time_range.elapsed_us() for e in device)
               / 1e3, profiled_wall_ms=wall * 1e3,
               device_activities=len(device),
               by_device=avg.table(sort_by="self_device_time_total",
                                   row_limit=12),
               by_host=avg.table(sort_by="self_cpu_time_total",
                                 row_limit=12))
    return st


def slam_metrics(slam, traj):
    """bench.py:227-236: keyframes, loops, ATE after SLAM and of odometry
    alone at the keyframes' stamps."""
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse

    own = sorted(slam.db.own_keyframes(), key=lambda k: k.stamp)
    idx = [int(round(k.stamp / 0.1)) for k in own]
    te = slam.trajectory()
    if not np.isfinite(te).all():
        raise AssertionError("full SLAM: keyframe poses not finite")
    odo = np.stack([k.odom for k in own])
    return dict(keyframes=len(slam.db.keyframes) + len(slam.db.new_keyframes),
                loops=sum(1 for e in slam.db.edges if e.type == "loop"),
                ate_m=ate_rmse(te[:, :3], traj[idx][:, :3]),
                ate_odom_m=ate_rmse(odo[:, :3], traj[idx][:, :3]))


def check_slam(m):
    """The full-SLAM bounds around the JAX package's numbers."""
    ref = REF_SLAM
    bound_ate = max(ref["ate_m"] + 0.05, 1.2 * ref["ate_m"])
    if m["loops"] < 1:
        raise AssertionError("full SLAM closed no loop")
    if not m["ate_m"] <= bound_ate:
        raise AssertionError(f"full SLAM ATE {m['ate_m']:.4f} m > "
                             f"{bound_ate:.4f} m")
    if abs(m["keyframes"] - ref["keyframes"]) > 2:
        raise AssertionError(f"full SLAM: {m['keyframes']} keyframes, "
                             f"the JAX package {ref['keyframes']}")
    if abs(m["loops"] - ref["loops"]) > max(2, 0.2 * ref["loops"]):
        raise AssertionError(f"full SLAM: {m['loops']} loops, the JAX "
                             f"package {ref['loops']}")


def pair_rows(torch, slam):
    """The pair program's nn inputs on PAIR_ROWS rows of the run's
    keyframes: row i is the odometry edge-fitness row of keyframe i+1
    onto i (the source moved into the target's frame by their graph
    estimates), with both clouds' masks. -> (src, tgt, src_mask,
    tgt_mask), tgt at PAD_VALUE on its masked lanes as the clouds are."""
    from mrg_slam_tpu_torch.ops.cloud import pad_invalid
    from mrg_slam_tpu_torch.utils import se3, se3np

    kfs = sorted(slam.db.own_keyframes(), key=lambda k: k.stamp)
    src, tgt, sm, tm = [], [], [], []
    for a, b in zip(kfs[:PAIR_ROWS], kfs[1:PAIR_ROWS + 1]):
        rel = se3np.pose_between(b.estimate(slam.db.graph),
                                 a.estimate(slam.db.graph))
        p = torch.from_numpy(rel).to(a.cloud.points.device)
        src.append(se3.pose_apply(p, a.cloud.points))
        sm.append(a.cloud.mask)
        tgt.append(pad_invalid(b.cloud.points, b.cloud.mask))
        tm.append(b.cloud.mask)
    return tuple(torch.stack(x).contiguous() for x in (src, tgt, sm, tm))


def pair_nn_phase(torch, slam, launches, ticks):
    """nn at the pair program's shape: bitwise to nn_plain on every lane
    of PAIR_ROWS real keyframe pairs with their ragged masks, with a
    quarter of the rows frozen (every source lane masked, as the pair
    program masks a finished row), and on the stride-2 coarse rows; then
    its kernel row, timed on the rows as they are."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk

    src, tgt, sm, tm = pair_rows(torch, slam)
    frozen = sm.clone()
    frozen[::4] = False
    check_nn(torch, nk, src, tgt, "pair rows", sm, tm)
    check_nn(torch, nk, src, tgt, "pair rows, frozen", frozen, tm)
    coarse = [x[:, ::2].contiguous() for x in (src, tgt, sm, tm)]
    check_nn(torch, nk, coarse[0], coarse[1], "pair rows, coarse",
             coarse[2], coarse[3])
    err = check_nn(torch, nk, src, tgt, "pair rows", sm, tm)
    n_src, n_tgt = sm.sum(-1).double(), tm.sum(-1).double()
    pairs = float((n_src * n_tgt).sum())
    log(f"# nn at the pair program's shape: {src.shape[0]} rows x "
        f"{src.shape[1]} lanes onto {tgt.shape[1]}, real sources "
        f"{int(n_src.min())}-{int(n_src.max())}, real targets "
        f"{int(n_tgt.min())}-{int(n_tgt.max())}: bitwise == plain on every "
        "lane, also with every 4th row frozen and on the stride-2 coarse "
        "rows")
    real_src = [s_[m] for s_, m in zip(src, sm)]
    real_tgt = [t_[m] for t_, m in zip(tgt, tm)]

    def lib_nn():
        return [torch.cdist(a[None], b[None],
                            compute_mode="donot_use_mm_for_euclid_dist"
                            ).min(dim=-1)
                for a, b in zip(real_src, real_tgt)]

    def fk():
        return nk.nn_cuda(src, tgt, sm, tm)

    bms, by = bound(pairs, 9, 0, (src.numel() + tgt.numel()) * 4
                    + src.shape[0] * src.shape[1] * 12)
    row = dict(name="nn_pairs", route="cuda",
               source="mrg_slam_tpu_torch/csrc/nn.cu",
               replaces="mrg_slam_tpu/ops/pallas_nn.py:48",
               launches=launches, max_abs_err=err, ms=cuda_ms(torch, fk),
               device_ms=graph_ms(torch, fk),
               plain_ms=cuda_ms(torch, lambda: nk.nn_plain(src, tgt, sm, tm)),
               bound_ms=bms, bound_by=by, library_ms=cuda_ms(torch, lib_nn),
               launches_per_tick=launches / len(ticks))
    log(f"# nn_pairs: kernel {row['ms']:.4f} ms around one call "
        f"({row['device_ms']:.4f} ms a launch in a CUDA graph), plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {bms:.4f} ms ({by}); {launches} launches in the timed pass's "
        f"ticks, {row['launches_per_tick']:.1f} a tick")
    return row


def slam_phase(torch, inp):
    """Full SLAM twice (warm-up with the last tick profiled, then timed,
    counts from 0 around the timed pass) -> (metrics, launches, timed
    run)."""
    from mrg_slam_tpu_torch.graph import lm_dense
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel

    slam_cfg = make_slam_config(inp.odo)
    prof = {}
    warm = full_slam(torch, inp, slam_cfg, profile_tick=prof)
    counters = (nn_kernel.nn_cuda, stats_kernel.count_cuda,
                stats_kernel.moments_cuda) + LM_COUNTERS(lm_dense)
    for fn in counters:
        fn.launches = 0
    run = full_slam(torch, inp, slam_cfg)
    launches = dict(zip(("nn", "count", "moments") + LM_KERNELS,
                        (fn.launches for fn in counters)))
    m = slam_metrics(run.slam, inp.traj)
    fps = SLAM_FRAMES / run.wall
    log(f"# full SLAM at full width: {SLAM_FRAMES} frames, {RAW} raw -> "
        f"{FILTERED} filtered pts; timed pass {run.wall:.3f} s, {fps:.2f} "
        f"frames/s (warm-up pass {SLAM_FRAMES / warm.wall:.2f}); "
        f"{m['keyframes']} keyframes, {m['loops']} loops, ATE "
        f"{m['ate_m']:.4f} m (odometry alone {m['ate_odom_m']:.4f} m); "
        f"JAX reference {REF_SLAM}")
    log(f"# store growth: {len(run.growth)} event(s) (tick, node capacity, "
        f"edge capacity): {run.growth}")
    for i, t in enumerate(run.ticks):
        log(f"# tick {i}: {json.dumps(t)}")
    back_nn = sum(t["nn_launches"] for t in run.ticks)
    log(f"# launches in the timed pass: {launches}, nn in the ticks "
        f"{back_nn}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in full SLAM")
    # every LM iteration of every tick ran the three kernels once
    lm_iters = sum(t["lm_iterations"] for t in run.ticks)
    for t in run.ticks:
        if t["lm_fused_iterations"] != t["lm_iterations"] or \
                t["lm_launches"] != [t["lm_iterations"]] * 3:
            raise AssertionError(f"a tick's LM ran off the kernels: {t}")
    if [launches[k] for k in LM_KERNELS] != [lm_iters] * 3:
        raise AssertionError(f"LM kernel launches {launches} against "
                             f"{lm_iters} LM iterations")
    lm_by_cap = {}
    for t in run.ticks:
        cap = lm_by_cap.setdefault(t["nodes_cap"], dict.fromkeys(
            LM_KERNELS, 0))
        for k, v in zip(LM_KERNELS, t["lm_launches"]):
            cap[k] += v
    log(f"# LM kernels in the timed pass: {lm_iters} LM iterations, each "
        f"one launch of each kernel; by node capacity {lm_by_cap}")
    check_slam(m)
    a, b = warm.slam.trajectory(), run.slam.trajectory()
    if a.shape != b.shape or not (a.view(np.uint32) == b.view(np.uint32)
                                  ).all():
        raise AssertionError("full SLAM rerun: keyframe poses not bitwise "
                             "identical to the warm-up pass")
    log("# timed pass: keyframe poses bitwise identical to the warm-up "
        "pass's")
    timed_last = run.ticks[-1]["wall_ms"]
    log(f"# last tick under torch.profiler (warm-up pass): device "
        f"{prof['device_ms']:.3f} ms in {prof['device_activities']} "
        f"activities, profiled wall {prof['profiled_wall_ms']:.3f} ms; the "
        f"same tick unprofiled in the timed pass {timed_last:.3f} ms, device "
        f"busy {prof['device_ms'] / timed_last:.3f} of it")
    log(prof["by_device"])
    log(prof["by_host"])
    ticks = run.ticks
    metrics = dict(
        frames=SLAM_FRAMES, frames_per_s=fps, wall_s=run.wall, **m,
        ref=REF_SLAM, growth=run.growth,
        loop_closure_ms_per_tick=float(np.mean(
            [t["loop_closure_ms"] for t in ticks])),
        optimize_ms_per_tick=float(np.mean([t["optimize_ms"]
                                            for t in ticks])),
        lm_ms_per_tick=float(np.mean([t["lm_ms"] for t in ticks])),
        marginals_ms_per_tick=float(np.mean([t["marginals_ms"]
                                             for t in ticks])),
        host_reads_per_tick=float(np.mean([t["host_reads"]
                                           for t in ticks])),
        lm_iterations_per_tick=float(np.mean([t["lm_iterations"]
                                              for t in ticks])),
        last_tick_device_ms=prof["device_ms"],
        last_tick_wall_ms=timed_last, launches=launches,
        nn_launches_in_ticks=back_nn, lm_launches_by_nodes_cap=lm_by_cap)
    return metrics, back_nn, run


def load_file(rel):
    """A module of this repo by its path (tests/ and tools/ are not
    packages)."""
    import importlib.util

    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_kernel_rows(torch, dev, by_cap):
    """The dense LM's kernels (csrc/lm_dense.cu) at the main path's two
    store shapes, 128 nodes / 512 edge rows and 256 / 1024, 3/4 of the
    nodes live, on seeded rings with chords of every robust kernel id:
    one iteration held to the op path within tests/test_torch_lm_kernel.py's
    tolerances (its `check_against_plain`) at R = 4 and R = 1, then each
    kernel timed at R = 1, its plain twin's stage beside it (linearize's:
    linearize, assemble_dense, equilibrate and the gradient, assemble's
    included; the trial's: retraction, chi2 and schedule). The trial is
    timed with a fixed damping and no stop (is_lm off, rel_tol 0), so
    every launch does the whole step. Launches: the timed full-SLAM
    pass's, at that node capacity (`by_cap`)."""
    from mrg_slam_tpu_torch.graph import lm_dense

    test = load_file("tests/test_torch_lm_kernel.py")
    tool = load_file("tools/time_lm_dense.py")
    rows = []
    for cap_n, cap_e, R in ((128, 512, 4), (128, 512, 1), (256, 1024, 1)):
        b, snaps, y, dy = test.one_iteration(dev, cap_n, cap_e, R)
        gaps = test.check_against_plain(b, snaps, y, dy)
        log(f"# LM kernels at {cap_n} / {cap_e}, R = {R}: against the op "
            f"path within the test's tolerances; largest gaps {gaps}")
        if R != 1:
            continue
        g = snaps[0]
        n_live, e_live = int(g.node_mask.sum()), int(g.se3.mask.sum())
        bounds = tool.bounds_ms(b.index, cap_n, n_live, e_live)
        info = torch.zeros(1, dtype=torch.int32, device=dev)
        lam = torch.full((), 1e-3, device=dev)
        pl = lm_dense.assemble_plain(g, lam)
        yy = torch.nn.functional.pad((y + dy)[0, :, 0],
                                     (0, 6 * cap_n - b.Hs.shape[1]))
        b.flags[0].zero_()
        b.flags[1].fill_(True)
        stages = {
            "lm_linearize": (lambda: lm_dense.linearize_cuda(b),
                             lambda: lm_dense.assemble_plain(g, lam),
                             gaps["grad"]),
            "lm_assemble": (lambda: lm_dense.assemble_cuda(b, init=False),
                            None, gaps["Hs"]),
            "lm_trial": (
                lambda: lm_dense.trial_cuda(b, y, dy, info, False, 0.0),
                lambda: lm_dense.trial_plain(
                    g, yy, pl["s"], pl["diag"], pl["b"], pl["chi2"], lam,
                    torch.full_like(lam, 2.0), False, 0.0),
                gaps["trial"]),
        }
        for name, (fk, fp, err) in stages.items():
            row = dict(name=f"{name}_{cap_n}", route="cuda",
                       source="mrg_slam_tpu_torch/csrc/lm_dense.cu",
                       replaces=None, shape=[cap_n, cap_e, n_live, e_live],
                       launches=by_cap.get(cap_n, {}).get(name, 0),
                       max_abs_err=err, ms=cuda_ms(torch, fk),
                       device_ms=graph_ms(torch, fk),
                       plain_ms=cuda_ms(torch, fp) if fp else None,
                       bound_ms=bounds[name][0], bound_by=bounds[name][1],
                       library_ms=None)
            # a graph done skips every kernel, one not to relinearize
            # skips linearize: neither may happen while it is timed
            if b.flags[0].any() or (name == "lm_linearize"
                                    and not b.flags[1].all()):
                raise AssertionError(f"{name} timing: a launch stopped "
                                     "short (done set or relin cleared)")
            log(f"# {row['name']}: kernel {row['ms']:.4f} ms around one "
                f"call ({row['device_ms']:.4f} ms a launch in a CUDA "
                f"graph), plain {row['plain_ms']} ms, bound "
                f"{row['bound_ms']:.2e} ms ({row['bound_by']}); "
                f"{row['launches']} launches in the timed full-SLAM pass "
                f"at {cap_n} nodes")
            rows.append(row)
    return rows


def solver_graph(n, backend, dev):
    """bench.py:486-495 through the port: the ring and its n/128 Huber
    chords across it."""
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.utils import se3np

    gs = build_ring_graph(n_nodes=n, capacity_nodes=n, capacity_edges=2 * n,
                          backend=backend, seed=0, device=dev)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    for i in range(0, n - n // 2, 64):
        j = i + n // 2
        gs.add_se3_edge(i, j, se3np.pose_between(gs.poses[i], gs.poses[j]),
                        info * 0.25, kernel="Huber", kernel_delta=1.0)
    return gs


def perturbed(torch, g, k):
    """bench.py's reps: the poses' translations moved by 1e-4 (k + 1)."""
    poses = g.poses.clone()
    poses[:, :3] += 1e-4 * (k + 1)
    return g._replace(poses=poses)


def timed(torch, fn, g):
    """bench.py's timing: one warm call, then the median wall of
    SOLVER_REPS calls on perturbed poses (each ends in a synchronize) ->
    (ms, rep ms, the last rep's result)."""
    fn(g)
    torch.cuda.synchronize()
    ts = []
    for k in range(SOLVER_REPS):
        gk = perturbed(torch, g, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(gk)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), ts, out


def timed_solve(torch, g, backend, iters, name):
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph import solve

    cfg = OptimizerConfig(solver_backend=backend,
                          g2o_solver_num_iterations=iters)
    aux = solve.chain_aux_for(g) if backend == "chain" else None
    ms, reps, res = timed(torch, lambda gk: solve.optimize(gk, cfg, aux=aux),
                          g)
    out = dict(ms=ms, reps_ms=reps, chi2_initial=float(res.chi2_initial),
               chi2_final=float(res.chi2_final), iterations=res.iterations,
               cg_iterations=int(res.cg_iterations))
    log(f"# solver {name}: {ms:.1f} ms (reps {[round(t, 1) for t in reps]}); "
        f"chi2 {out['chi2_initial']:.1f} -> {out['chi2_final']:.6f}, "
        f"{res.iterations} LM iterations"
        + (f", {out['cg_iterations']} CG iterations" if backend == "cg"
           else ""))
    if not np.isfinite(res.poses.cpu().numpy()).all():
        raise AssertionError(f"solver {name}: poses not finite")
    return out, res


def check_chi2(name, got, want, what):
    rel = abs(got - want) / max(abs(want), 1e-12)
    if not rel <= SOLVER_CHI2_RTOL:
        raise AssertionError(f"solver {name}: chi2 {got:.6f} is {rel:.2e} "
                             f"from {what} {want:.6f}")
    return rel


def profiled_solve(torch, fn, wall_ms):
    """One call under torch.profiler -> device ms, activities, share of the
    unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=10))
    return dict(device_ms=dev_ms, device_activities=len(device),
                device_share=dev_ms / wall_ms)


def copy_graph(gs, cfg, cap_nodes, cap_edges, dev):
    """A GraphSLAM of the given capacities holding `gs`'s nodes and
    edges."""
    from mrg_slam_tpu_torch.graph.builder import KERNEL_IDS, GraphSLAM

    out = GraphSLAM(cfg, capacity_nodes=cap_nodes, capacity_edges=cap_edges,
                    device=dev)
    for p, fixed in zip(gs.poses, gs.fixed):
        out.add_se3_node(p, fixed=bool(fixed))
    names = {v: k for k, v in KERNEL_IDS.items()}
    a = gs._se3.arrays
    for e in range(gs.num_edges):
        out.add_se3_edge(int(a["from_idx"][e]), int(a["to_idx"][e]),
                         a["meas"][e], a["info"][e],
                         kernel=names[int(a["kernel"][e])],
                         kernel_delta=float(a["delta"][e]))
    return out


def exact_marginals64(torch, g, ridge):
    """The diagonal 6x6 blocks of (H + ridge I)^-1 over the free dofs, with
    H assembled and inverted in float64 from the float32 linearization,
    zero for fixed and invalid nodes."""
    from mrg_slam_tpu_torch.graph import solve

    lin = solve.linearize(g)
    n = g.n_nodes
    H = torch.zeros(6 * n, 6 * n, dtype=torch.float64, device=g.poses.device)
    ar = torch.arange(6, device=H.device)
    ends = ((g.se3.from_idx.long(), lin.Ji.double()),
            (g.se3.to_idx.long(), lin.Jj.double()))
    for ia, Ja in ends:
        for ib, Jb in ends:
            H.index_put_((ia[:, None, None] * 6 + ar[:, None],
                          ib[:, None, None] * 6 + ar),
                         Ja.transpose(1, 2) @ lin.W_se3.double() @ Jb,
                         accumulate=True)
    fn, _ = solve._free_masks(g)
    idx = torch.nonzero(fn[:, 0].bool().repeat_interleave(6))[:, 0]
    inv = torch.zeros_like(H)
    inv[idx[:, None], idx[None, :]] = torch.linalg.inv(
        H[idx][:, idx] + ridge * torch.eye(len(idx), dtype=H.dtype,
                                           device=H.device))
    return inv.view(n, 6, n, 6).diagonal(dim1=0, dim2=2).permute(
        2, 0, 1).cpu().numpy()


def default_capacity_tick(torch, slam_graph, dev):
    """ROADMAP fault 3.1 on the card: the full-SLAM run's final graph in a
    GraphSLAM of the default capacities (2048 nodes, so a dense LM at D =
    12288) with the default OptimizerConfig (marginals "auto" -> cg), once
    to warm up and SOLVER_REPS times timed; held to the same graph at its
    run's capacity (chi2) and to the float64 inverse of H + CG_RIDGE I
    (marginals)."""
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph.builder import GraphSLAM

    cfg = OptimizerConfig()
    cap = slam_graph.cap
    n = slam_graph.num_nodes
    small = copy_graph(slam_graph, cfg, cap["nodes"], cap["edges"], dev)
    small.optimize()
    default = GraphSLAM(cfg, device=dev).cap
    runs = []
    for _ in range(1 + SOLVER_REPS):
        big = copy_graph(slam_graph, cfg, default["nodes"], default["edges"],
                         dev)
        big.optimize()
        runs.append(big)
    big = runs[-1]
    lm = float(np.median([r.last_lm_ms for r in runs[1:]]))
    marg = float(np.median([r.last_marginals_ms for r in runs[1:]]))
    rel = check_chi2("default-capacity tick", big.chi2_final,
                     small.chi2_final, "the run's capacity")
    small._poses[:n] = big.poses
    g = small.snapshot()
    exact = exact_marginals64(torch, g, CG_RIDGE)[:n]
    gap = float(np.abs(exact_marginals64(torch, g, 1e-9)[:n] - exact).max())
    cov = big.last_marginals
    if cov is None or cov.shape != (n, 6, 6) or not np.isfinite(cov).all():
        raise AssertionError("default-capacity tick: no finite marginals")
    bad = np.abs(cov - exact) > CG_MARG_ATOL + CG_MARG_RTOL * np.abs(exact)
    err = float(np.abs(cov - exact).max())
    log(f"# default-capacity tick (fault 3.1): {n} keyframes, "
        f"{slam_graph.num_edges} edges in a store of {big.cap} with the "
        f"default OptimizerConfig (dense LM at D = {6 * big.cap['nodes']}, "
        f"cg marginals): LM {lm:.1f} ms, {big.last_iterations} iterations, "
        f"marginals {marg:.1f} ms; chi2 {big.chi2_final:.6f} against "
        f"{small.chi2_final:.6f} at capacity {cap['nodes']} (rel {rel:.2e}); "
        f"cg marginals against the float64 inverse of H + {CG_RIDGE} I: "
        f"max |diff| {err:.3e} of {float(np.abs(exact).max()):.3e}, "
        f"{int(bad.sum())} entries outside rtol {CG_MARG_RTOL} + atol "
        f"{CG_MARG_ATOL} (that inverse and the one of H + 1e-9 I, the dense "
        f"path's, differ by up to {gap:.3e})")
    if bad.any():
        raise AssertionError("default-capacity tick: cg marginals off the "
                             "exact ones")
    return dict(nodes=n, capacity=big.cap, lm_ms=lm, marginals_ms=marg,
                lm_iterations=big.last_iterations, chi2=big.chi2_final,
                chi2_run_capacity=small.chi2_final, chi2_rel=rel,
                marginals_max_abs_err=err, ridge_gap=gap)


def solver_phase(torch, dev, slam_graph):
    """bench.py's solver section on the card at its own width and the
    default-capacity tick -> metrics (row 5's single-device half runs in
    the distributed phase, beside its distributed half)."""
    from mrg_slam_tpu_torch.graph import chain_solver, solve

    t_phase = time.perf_counter()
    out = {}
    solved = {}
    for n, backend in ((1024, "dense"), (1024, "chain"), (8192, "chain")):
        name = f"{backend}_{n}"
        g = solver_graph(n, backend, dev).snapshot()
        out[name], res = timed_solve(torch, g, backend, SOLVER_ITERS,
                                     f"{backend} {n} nodes")
        out[name]["chi2_rel_ref"] = check_chi2(
            name, out[name]["chi2_final"], REF_SOLVERS[name],
            "the JAX package's")
        solved[name] = (g, res)
    parity = check_chi2("chain 1024 vs dense 1024",
                        out["chain_1024"]["chi2_final"],
                        out["dense_1024"]["chi2_final"], "dense's")
    log(f"# 1024-node chi2 parity dense vs chain: rel diff {parity:.2e}")
    out["chain_dense_chi2_rel"] = parity

    # where a 1024-node chain solve's time goes
    g, _ = solved["chain_1024"]
    aux = solve.chain_aux_for(g)
    from mrg_slam_tpu_torch.config import OptimizerConfig
    cfg = OptimizerConfig(solver_backend="chain",
                          g2o_solver_num_iterations=SOLVER_ITERS)
    out["chain_1024"]["profile"] = profiled_solve(
        torch, lambda: solve.optimize(g, cfg, aux=aux),
        out["chain_1024"]["ms"])
    log(f"# profiled chain 1024 solve: {out['chain_1024']['profile']}")

    # chain marginals at 1024 (solved poses) against the dense inverse
    g, res = solved["chain_1024"]
    g = g._replace(poses=res.poses)
    cov = chain_solver.chain_marginals(g, solve.chain_aux_for(g), 64)
    dense = solve.marginals(g, exact=True)
    scale = float(dense[1:].abs().max())
    diff = (cov - dense).abs()
    bad = diff > CHAIN_DENSE_ATOL * scale + CHAIN_DENSE_RTOL * dense.abs()
    out["marginals_1024_vs_dense_max_abs"] = float(diff.max())
    log(f"# chain marginals 1024 against the dense inverse: max |diff| "
        f"{float(diff.max()):.3e} of {scale:.3e}, {int(bad.sum())} entries "
        f"outside rtol {CHAIN_DENSE_RTOL} + atol {CHAIN_DENSE_ATOL} x max")
    if bool(bad.any()):
        raise AssertionError("chain marginals at 1024 off the dense inverse")

    # exact chain marginals of the unsolved 8192-node graph
    g8, _ = solved["chain_8192"]
    aux8 = solve.chain_aux_for(g8)
    ms, reps, _ = timed(torch, lambda gk: chain_solver.chain_marginals(
        gk, aux8, 64), g8)
    cov = chain_solver.chain_marginals(g8, aux8, 64).cpu().numpy()
    blocks = cov[MARGINAL_STRIDE::MARGINAL_STRIDE]
    err = float(np.abs(blocks - REF_MARGINALS_8192).max())
    rel = err / float(np.abs(REF_MARGINALS_8192).max())
    out["marginals_8192"] = dict(ms=ms, reps_ms=reps, max_abs_err=err,
                                 rel_err=rel)
    log(f"# chain marginals 8192 nodes: {ms:.1f} ms (reps "
        f"{[round(t, 1) for t in reps]}); sampled blocks against the exact "
        f"reference: max |diff| {err:.3e}, {rel:.2e} of the largest entry "
        f"(tolerance {MARGINAL_TOL})")
    if not (np.isfinite(cov).all() and (cov[0] == 0).all()
            and rel <= MARGINAL_TOL):
        raise AssertionError("chain marginals at 8192 off the reference")

    out["default_capacity_tick"] = default_capacity_tick(torch, slam_graph,
                                                          dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"# solver phase: {out['phase_s']:.1f} s")
    return out


class CardMemory:
    """Samples the card's used memory (total - free, every process on
    it) from a thread of this process while entered; `peak` in bytes."""

    def __init__(self, torch, every_s=0.2):
        self.torch, self.every_s, self.peak = torch, every_s, 0
        self._stop = None

    def _run(self):
        while not self._stop.wait(self.every_s):
            free, total = self.torch.cuda.mem_get_info(0)
            self.peak = max(self.peak, total - free)

    def __enter__(self):
        import threading

        free, total = self.torch.cuda.mem_get_info(0)
        self.peak = total - free
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def processes_run(torch, R, work):
    """`run_multiprocess` on the card with R robot processes at the JAX
    package's width -> its metrics: per robot keyframes, merged remote
    keyframes, loops, inter-robot loops, ATE, bytes, frames/s, the
    publish_graph calls (ms, host reads each), host reads a frame,
    kernel launches and peak card memory (allocated and reserved); the
    aggregate robot-frames/s (frames summed over the robots / the slowest
    worker's wall) and the card's used memory sampled from here."""
    from mrg_slam_tpu_torch.pipeline.multiprocess import run_multiprocess

    t0 = time.perf_counter()
    with CardMemory(torch) as mem:
        res = run_multiprocess(n_robots=R, total_frames=PROC_FRAMES,
                               tick_every=PROC_TICK, world_seed=PROC_SEED,
                               out_dir=str(work / f"R{R}"))
    wall = time.perf_counter() - t0
    slowest = max(r["wall_s"] for r in res.values())
    frames = sum(r["frames"] for r in res.values())
    m = dict(robots={}, frames=frames, slowest_wall_s=slowest,
             phase_wall_s=wall, card_used_peak_bytes=mem.peak,
             aggregate_frames_per_s=frames / slowest)
    for name, r in res.items():
        pub = r["publish_graph"]
        m["robots"][name] = dict(
            {k: r[k] for k in ("frames", "keyframes", "remote_keyframes",
                               "loops", "inter_robot_loops", "ate_m",
                               "received_bytes", "sent_bytes", "wall_s",
                               "frames_per_s", "host_reads_per_frame",
                               "launches", "peak_allocated_bytes",
                               "peak_reserved_bytes", "device")},
            publish_calls=len(pub),
            publish_ms=float(sum(p["ms"] for p in pub)),
            publish_reads=[p["reads"] for p in pub],
            publish_keyframes=[p["keyframes"] for p in pub],
            ref=REF_PROC[R][name])
    for name, r in m["robots"].items():
        ref = r["ref"]
        log(f"# processes R = {R} {name}: {r['frames']} frames at "
            f"{r['frames_per_s']:.2f} frames/s; keyframes {r['keyframes']} "
            f"(JAX CPU {ref['keyframes']}), remote keyframes merged "
            f"{r['remote_keyframes']} ({ref['remote_keyframes']}), loops "
            f"{r['loops']} ({ref['loops']}), inter-robot loops "
            f"{r['inter_robot_loops']}, ATE {r['ate_m']:.4f} m "
            f"({ref['ate_m']:.4f}); graph bytes received "
            f"{r['received_bytes']} / sent {r['sent_bytes']} for "
            f"{sum(r['publish_keyframes'])} keyframes sent; "
            f"{r['publish_calls']} publish_graph calls in "
            f"{r['publish_ms']:.1f} ms, host reads each "
            f"{r['publish_reads']}; host reads a frame "
            f"{r['host_reads_per_frame']:.2f}; launches {r['launches']}; "
            f"peak card memory {r['peak_allocated_bytes'] / 2**20:.1f} MiB "
            f"allocated, {r['peak_reserved_bytes'] / 2**20:.1f} MiB "
            "reserved")
    log(f"# processes R = {R}: {m['aggregate_frames_per_s']:.2f} "
        f"robot-frames/s aggregate ({frames} robot-frames, slowest worker "
        f"{slowest:.1f} s, {wall:.1f} s with process start-up; row 4 in "
        f"one process: {ROW4_ONE_PROCESS_FPS} robot-frames/s); the "
        f"card's used memory peaked at {mem.peak / 2**20:.0f} MiB (every "
        f"process on it, this one's {torch.cuda.memory_reserved() / 2**20:.0f}"
        " MiB reserved included)")
    return m


def check_processes(R, m):
    """Every robot: keyframes within 2 of ref's, remote keyframes merged
    at least one and within max(3, 0.3 ref), ATE at most ref + 0.3 m (the
    multi-robot run-to-run spread), fewer than PROC_BYTES_PER_KF bytes a
    keyframe on the wire (graph bytes sent over keyframes sent: at R > 2
    a robot receives some keyframes from more than one peer, so bytes
    received over keyframes merged exceeds it), nn and moments launched
    on the card, and one host
    read for each publish_graph that sent a keyframe (none for one that
    sent none); an inter-robot loop in the fleet. ref: the JAX package's
    run of the same arguments on the CPU (REF_PROC)."""
    bad = []
    for name, r in m["robots"].items():
        ref = r["ref"]
        if abs(r["keyframes"] - ref["keyframes"]) > 2:
            bad.append(f"{name}: {r['keyframes']} keyframes, JAX CPU "
                       f"{ref['keyframes']}")
        rk, wk = r["remote_keyframes"], ref["remote_keyframes"]
        if not (rk >= 1 and abs(rk - wk) <= max(3, 0.3 * wk)):
            bad.append(f"{name}: {rk} remote keyframes merged, JAX CPU {wk}")
        if not r["ate_m"] <= ref["ate_m"] + MR_ATE_SPREAD:
            bad.append(f"{name}: ATE {r['ate_m']:.4f} m > "
                       f"{ref['ate_m'] + MR_ATE_SPREAD:.4f}")
        sent_kf = sum(r["publish_keyframes"])
        per_kf = r["sent_bytes"] / max(sent_kf, 1)
        if not per_kf < PROC_BYTES_PER_KF:
            bad.append(f"{name}: {per_kf:.0f} bytes a keyframe sent")
        if r["device"] != "cuda" or r["launches"]["nn"] <= 0 \
                or r["launches"]["moments"] <= 0:
            bad.append(f"{name}: on {r['device']}, launches "
                       f"{r['launches']}")
        want = [1 if k else 0 for k in r["publish_keyframes"]]
        if r["publish_reads"] != want:
            bad.append(f"{name}: publish_graph host reads "
                       f"{r['publish_reads']} for keyframes "
                       f"{r['publish_keyframes']}")
    if not sum(r["inter_robot_loops"] for r in m["robots"].values()):
        bad.append("no inter-robot loop in the fleet")
    if bad:
        raise AssertionError(f"processes R = {R}: " + "; ".join(bad))


def kernel_worker_inputs(torch, dev):
    """The robot workers' kernel inputs, from their world (seed
    PROC_SEED) and config: PROC_BUCKET + 1 consecutive frames prefiltered
    to 1024 lanes -> {name: (nn source, target, source mask, target
    mask)} for one frame and a pair bucket of PROC_BUCKET rows, and
    {name: (points, mask)} for moments at the same shapes, and r^2."""
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
    from mrg_slam_tpu_torch.pipeline import multiprocess as mp

    cfg = mp._default_cfg("alpha", ["alpha"], (0.0,) * 6)
    world = SyntheticWorld.build(seed=PROC_SEED, extent=30.0,
                                 n_ground=25000, max_points_per_scan=8192,
                                 noise=0.02)
    traj = circle_trajectory(PROC_FRAMES, radius=12.0, laps=1.1)
    clouds = [prefilter(PointCloud.from_array(
        world.scan(traj[i], seed=i), cfg.prefilter.capacity_raw_points,
        device=dev), cfg.prefilter) for i in range(PROC_BUCKET + 1)]
    pts = torch.stack([c.points for c in clouds]).contiguous()
    mask = torch.stack([c.mask for c in clouds]).contiguous()
    tgt = pad_invalid(pts, mask).contiguous()
    k = PROC_BUCKET
    nn = {"frame": (pts[1:2], tgt[0:1], mask[1:2], mask[0:1]),
          f"bucket {k}": (pts[1:k + 1], tgt[:k], mask[1:k + 1], mask[:k])}
    mom = {"frame": (pts[0:1], mask[0:1]), f"bucket {k}": (pts[:k],
                                                            mask[:k])}
    r2 = sk.radius_sq(cfg.odometry.registration.reg_covariance_radius)
    return ({n: tuple(x.contiguous() for x in a) for n, a in nn.items()},
            {n: tuple(x.contiguous() for x in a) for n, a in mom.items()},
            r2)


def kernel_worker(out_path, sync_dir):
    """One of the concurrent kernel check's two processes: on the
    workers' inputs, nn and moments launched again and again for
    PROC_KERNEL_S seconds once both processes are ready, each result held
    to its plain version (nn bitwise, moments within check_moments'
    summation bound); -> a JSON file with its iterations, launches,
    largest errors and the wall-clock window it launched in."""
    import torch

    from mrg_slam_tpu_torch.ops import native, nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk
    from mrg_slam_tpu_torch.runtime import resolve_device

    dev = resolve_device()
    native.build_all()
    nn_in, mom_in, r2 = kernel_worker_inputs(torch, dev)
    nn_ref = {n: nk.nn_plain(*a) for n, a in nn_in.items()}
    mom_ref = {n: sk.moments_plain(p, p, r2, m, m)
               for n, (p, m) in mom_in.items()}
    with open(os.path.join(sync_dir, f"ready.{os.getpid()}"), "w"):
        pass
    deadline = time.time() + 300.0
    while not os.path.exists(os.path.join(sync_dir, "go")):
        if time.time() > deadline:
            raise RuntimeError("kernel worker: no go signal")
        time.sleep(0.005)
    nn_k0, mom_k0 = nk.nn_cuda.launches, sk.moments_cuda.launches
    err_nn, err_mom, iters = 0.0, 0.0, 0
    t0 = time.time()
    while time.time() - t0 < PROC_KERNEL_S:
        for n, a in nn_in.items():
            d, i = nk.nn_cuda(*a)
            d_p, i_p = nn_ref[n]
            if not (torch.equal(i, i_p) and torch.equal(
                    d.view(torch.int32), d_p.view(torch.int32))):
                raise AssertionError(f"nn {n}: not bitwise its plain "
                                     "version while another process "
                                     "launched")
        for n, (p, m) in mom_in.items():
            m_k = sk.moments_cuda(p, p, r2, m, m)
            e = moments_errors(torch, sk, p, m, m_k, mom_ref[n],
                               f"{n}, concurrent")
            err_mom = max(err_mom, e[0], e[2])
        iters += 1
    t1 = time.time()
    out = dict(pid=os.getpid(), iterations=iters, window=[t0, t1],
               nn_launches=nk.nn_cuda.launches - nn_k0,
               moments_launches=sk.moments_cuda.launches - mom_k0,
               nn_max_abs_err=err_nn, moments_max_abs_err=err_mom,
               ms_per_iteration=(t1 - t0) / max(iters, 1) * 1e3,
               shapes={n: list(a[0].shape) for n, a in nn_in.items()})
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def concurrent_kernels(work):
    """The concurrent kernel check: two processes of this script
    (`--kernel-worker`) launch nn and moments on the card at the same
    time, each holding every result to its plain version; fails if one
    exits non-zero or if their launch windows overlap by less than half.
    -> their reports."""
    sync = work / "sync"
    sync.mkdir()
    procs, outs = [], [work / f"kernels.{i}.json" for i in range(2)]
    logs = [open(work / f"kernels.{i}.log", "w") for i in range(2)]
    try:
        for out, lf in zip(outs, logs):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--kernel-worker",
                 str(out), str(sync)], stdout=lf, stderr=subprocess.STDOUT))
        deadline = time.time() + 300.0
        while len(list(sync.glob("ready.*"))) < 2:
            if time.time() > deadline or any(p.poll() not in (None, 0)
                                             for p in procs):
                raise AssertionError("concurrent kernels: a worker did not "
                                     "get ready")
            time.sleep(0.01)
        (sync / "go").touch()
        for i, p in enumerate(procs):
            rc = p.wait(timeout=300)
            if rc != 0:
                logs[i].flush()
                tail = (work / f"kernels.{i}.log").read_text()[-3000:]
                raise AssertionError(f"concurrent kernel worker {i} exited "
                                     f"{rc}:\n{tail}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
    reps = [json.loads(o.read_text()) for o in outs]
    (a0, a1), (b0, b1) = reps[0]["window"], reps[1]["window"]
    overlap = max(0.0, min(a1, b1) - max(a0, b0))
    short = min(a1 - a0, b1 - b0)
    for r in reps:
        log(f"# concurrent kernels, process {r['pid']}: {r['iterations']} "
            f"iterations ({r['nn_launches']} nn and {r['moments_launches']} "
            f"moments launches at {r['shapes']}), "
            f"{r['ms_per_iteration']:.3f} ms an iteration; nn bitwise its "
            f"plain version on every launch, moments max |err| "
            f"{r['moments_max_abs_err']:.3g} within the summation bound")
    log(f"# concurrent kernels: launch windows overlap {overlap:.2f} s of "
        f"{short:.2f} s")
    if overlap < 0.5 * short:
        raise AssertionError(f"concurrent kernels: windows overlap only "
                             f"{overlap:.2f} s of {short:.2f} s")
    return dict(processes=reps, overlap_s=overlap)


def processes_kernel_rows(torch, launches):
    """nn and moments at the robot workers' per-frame shape (one frame of
    1024 lanes), timed here as the other rows, with the launches the
    workers counted over the R = 2 and R = 4 runs."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops import stats_kernel as sk

    where = "the processes phase's workers, R = 2 and 4"
    nn_in, mom_in, r2 = kernel_worker_inputs(torch, torch.device("cuda"))
    src, tgt, sm, tm = nn_in["frame"]
    err = check_nn(torch, nk, src, tgt, "processes frame", sm, tm)
    a, b = src[sm], tgt[tm]

    def lib_nn():
        return torch.cdist(a[None], b[None],
                           compute_mode="donot_use_mm_for_euclid_dist"
                           ).min(dim=-1)

    pairs = float(sm.sum()) * float(tm.sum())
    rows = [timed_row(
        torch, "nn_frame_procs", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(src, tgt, sm, tm),
        lambda: nk.nn_plain(src, tgt, sm, tm), lib_nn, launches["nn"], err,
        *bound(pairs, 9, 0, (src.numel() + tgt.numel()) * 4
               + src.shape[1] * 12), where=where)]
    pts, mask = mom_in["frame"]
    err, inside = check_moments(torch, sk, pts, r2, "processes frame", mask)
    real = pts[mask]
    feats = torch.cat([torch.ones_like(real[:, :1]), real,
                       *(real[:, i:i + 1] * real[:, j:j + 1]
                         for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                      (1, 2), (2, 2)))], dim=-1)
    radius = float(np.sqrt(r2))

    def lib_moments():
        return (torch.cdist(real, real,
                            compute_mode="donot_use_mm_for_euclid_dist")
                <= radius).float() @ feats

    n_real = float(mask.sum())
    rows.append(timed_row(
        torch, "moments_frame_procs",
        "mrg_slam_tpu_torch/csrc/radius_stats.cu",
        "mrg_slam_tpu/ops/pallas_stats.py:93",
        lambda: sk.moments_cuda(pts, pts, r2, mask, mask),
        lambda: sk.moments_plain(pts, pts, r2, mask, mask), lib_moments,
        launches["moments"], err,
        *bound(n_real * n_real, 9, 16 * inside,
               pts.numel() * 4 + pts.shape[1] * 40), where=where))
    return rows


def processes_phase(torch):
    """Robots as separate processes on the card: `run_multiprocess` at
    R = 2 and R = 4 (one CUDA context a robot on the one card, delta
    graphs over TCP), every robot held to the JAX package's CPU run of
    the same arguments; then two processes launching nn and moments at
    once, each held to the plain versions; then the kernel rows of the
    workers' frame shape."""
    import tempfile
    from pathlib import Path

    t0 = time.perf_counter()
    # what this process's allocator caches from the earlier phases goes
    # back to the card before the robot processes start
    torch.cuda.empty_cache()
    out, launches = {}, {"nn": 0, "moments": 0, "count": 0}
    out["parent_reserved_bytes"] = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for R in PROC_ROBOTS:
            m = processes_run(torch, R, work)
            check_processes(R, m)
            out[str(R)] = m
            for r in m["robots"].values():
                for k in launches:
                    launches[k] += r["launches"][k]
        out["concurrent_kernels"] = concurrent_kernels(work)
    rows = processes_kernel_rows(torch, launches)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t0
    log(f"# processes phase: {out['phase_s']:.1f} s; worker launches over "
        f"R = 2 and 4: {launches}")
    return out, rows


# ---------------------------------------------------------------------------
# the distributed solve over ranks on the card
# ---------------------------------------------------------------------------

def dist_phase(torch):
    """Row 5's distributed half (`baseline_runs.config5_distributed`:
    `build_ring_graph(256)`, cg, 40 LM iterations, DIST_RANKS ranks as
    processes on the one card, gloo, CUDA tensors) held to ROW5_CHI2 and to
    the one-device solve; the dry run (`parallel.dryrun.dryrun_multichip`:
    256 nodes with every family by dense LM, 2048 nodes by the chain
    backend's split panels) under its own asserts; with the reductions'
    count and host wall. Every rank must return the same bits."""
    from mrg_slam_tpu_torch.parallel import dryrun
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    t0 = time.perf_counter()
    with CardMemory(torch) as mem:
        row = bl.config5_distributed(n_nodes=256, n_ranks=DIST_RANKS)
    rel = abs(row["chi2_distributed"] - ROW5_CHI2) / ROW5_CHI2
    row["chi2_rel_row5_single"] = check_chi2(
        "row 5, one device", row["chi2_single"], ROW5_CHI2, "row 5's")
    per_it = row["all_reduces"] / max(row["lm_iterations"], 1)
    log(f"# row 5 distributed ({DIST_RANKS} ranks, {row['backend']}): chi2 "
        f"{row['chi2_distributed']:.6f} (one device {row['chi2_single']:.6f}"
        f", BASELINE_SYNTH {ROW5_CHI2:.6f}, rel {rel:.2e}); largest pose "
        f"divergence {row['max_pose_divergence_m']:.2e} m; ranks bitwise "
        f"equal: {row['ranks_bitwise_equal']}; solve "
        f"{row['distributed_solve_s'] * 1e3:.1f} ms over {DIST_RANKS} ranks "
        f"against {row['single_solve_s'] * 1e3:.1f} ms on one device; "
        f"{row['lm_iterations']} LM and {row['cg_iterations']} CG "
        f"iterations, {row['all_reduces']} reductions over the ranks "
        f"({per_it:.1f} an LM iteration, {row['all_reduce_ms']:.3f} ms "
        f"each); peak allocated a rank (MiB) "
        f"{[round(b / 2**20, 1) for b in row['peak_allocated_bytes']]}; "
        f"the card's used memory peaked at {mem.peak / 2**20:.0f} MiB")
    if not row["ranks_bitwise_equal"]:
        raise AssertionError("row 5: the ranks' poses differ")
    if not rel < 1e-3:
        raise AssertionError(f"row 5 distributed chi2 "
                             f"{row['chi2_distributed']} vs {ROW5_CHI2}")
    if not row["max_pose_divergence_m"] < DIST_POSE_ATOL:
        raise AssertionError(f"row 5 pose divergence "
                             f"{row['max_pose_divergence_m']} m")
    row["card_used_peak_bytes"] = mem.peak
    dry = dryrun.dryrun_multichip(DIST_RANKS)
    log(f"# a reduction over {DIST_RANKS} ranks (host wall, rank 0's mean): "
        f"row 5's cg {row['all_reduce_ms']:.3f} ms (256 x 6 floats an H v),"
        f" the dry run's dense {dry['dense']['all_reduce_ms']:.3f} ms (the "
        f"(D, D) Hessian, D = 1596) and chain "
        f"{dry['chain']['all_reduce_ms']:.3f} ms")
    phase_s = time.perf_counter() - t0
    log(f"# distributed phase: {phase_s:.1f} s")
    return dict(row5=row, dryrun=dry, phase_s=phase_s)


# ---------------------------------------------------------------------------
# acceptance row 2 with the voxel registration family
# ---------------------------------------------------------------------------

class VoxelBucketRecorder(BucketRecorder):
    """BucketRecorder over `registration.align_pairs_voxel_packed`: keeps
    the largest voxel pair bucket's raw target clouds, sources and initial
    poses (what its fitness pass searches)."""

    def __init__(self, reg):
        self.reg, self.fn, self.largest = (reg, reg.align_pairs_voxel_packed,
                                           None)

    def __enter__(self):
        self.reg.align_pairs_voxel_packed = self
        return self

    def __exit__(self, *exc):
        self.reg.align_pairs_voxel_packed = self.fn

    def __call__(self, params, maps, clouds, srcs, init_poses, *rest):
        if self.largest is None or len(clouds) > len(self.largest[0]):
            self.largest = (list(clouds), list(srcs),
                            np.array(init_poses, np.float32))
        return self.fn(params, maps, clouds, srcs, init_poses, *rest)


def check_voxel(method, m):
    """Loops within max(2, 0.2 ref) of the JAX package's on the CPU, a
    loop where it has one; where the reference kept the track (ATE under
    DIVERGED_ATE_M), ATE within max(ref + 0.05 m, 1.2 ref) and keyframes
    within 2 of ref's; where it lost it (NDT, B12), a run that loses it
    too (its ATE and keyframe count are the drift's, not the method's);
    a finite ATE; nn launched (the fitness passes), moments with VGICP."""
    ref = REF_VOXEL[method]
    if not np.isfinite(m["ate_m"]):
        raise AssertionError(f"{method}: ATE not finite")
    if ref["ate_m"] <= DIVERGED_ATE_M:
        lim = max(ref["ate_m"] + 0.05, 1.2 * ref["ate_m"])
        if not m["ate_m"] <= lim:
            raise AssertionError(f"{method}: ATE {m['ate_m']:.4f} m > "
                                 f"{lim:.4f}")
        if abs(m["keyframes"] - ref["keyframes"]) > 2:
            raise AssertionError(f"{method}: {m['keyframes']} keyframes, "
                                 f"JAX CPU {ref['keyframes']}")
    elif not m["ate_m"] > DIVERGED_ATE_M:
        raise AssertionError(f"{method}: ATE {m['ate_m']:.4f} m where the "
                             f"JAX package loses the track "
                             f"({ref['ate_m']:.2f} m): the reference is no "
                             "longer what this row reproduces")
    if abs(m["loops"] - ref["loops"]) > max(2, 0.2 * ref["loops"]) or (
            ref["loops"] and not m["loops"]):
        raise AssertionError(f"{method}: {m['loops']} loops, JAX CPU "
                             f"{ref['loops']}")
    if m["launches"]["nn"] <= 0:
        raise AssertionError(f"{method}: nn never launched")
    if method == "FAST_VGICP" and m["launches"]["moments"] <= 0:
        raise AssertionError(f"{method}: moments never launched")


def ndt_scene_check(torch):
    """NDT and FAST_VGICP on tests/test_registration.py's structured scene
    (two walls and a floor, 1500 points, resolution 2.0) on the card:
    each recovers the known pose within the JAX package's own bounds."""
    from mrg_slam_tpu_torch.config import RegistrationConfig
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.utils import se3

    rng = np.random.default_rng(0)
    n = 500
    pts = np.concatenate([
        np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                  rng.normal(scale=0.02, size=n)], 1),
        np.stack([rng.uniform(-10, 10, n),
                  10 + rng.normal(scale=0.02, size=n),
                  rng.uniform(0, 4, n)], 1),
        np.stack([-10 + rng.normal(scale=0.02, size=n),
                  rng.uniform(-10, 10, n), rng.uniform(0, 4, n)], 1)]
    ).astype(np.float32)
    gt = se3.pose_exp(torch.tensor([0.3, -0.2, 0.1, 0.02, 0.03, -0.05]))
    src = se3.pose_apply(se3.pose_inverse(gt), torch.from_numpy(pts))
    out = {}
    for method, tol_t, tol_r in (("NDT", 0.05, 0.01),
                                 ("FAST_VGICP", 0.10, 0.02)):
        p = RegistrationConfig(registration_method=method,
                               reg_transformation_epsilon=1e-4,
                               reg_maximum_iterations=64,
                               reg_resolution=2.0)
        res = reg.align(p, reg.make_source(PointCloud.from_array(
            src.numpy(), 2048), p), reg.make_target(
            PointCloud.from_array(pts, 2048), p), se3.pose_identity("cuda"))
        est = res.pose.cpu()
        t_err = float(torch.linalg.vector_norm(est[:3] - gt[:3]))
        r_err = float(se3.rotation_angle(se3.pose_between(est, gt)[3:]))
        out[method] = dict(t_err_m=t_err, r_err=r_err,
                           iterations=int(res.iterations))
        if not (t_err < tol_t and r_err < tol_r):
            raise AssertionError(f"{method} on the structured scene: "
                                 f"{t_err:.4f} m / {r_err:.4f} rad")
    log(f"# voxel family on the structured scene (card): {out}")
    return out


def voxel_kernel_rows(torch, bucket, launches):
    """nn at the largest voxel pair bucket (the fitness pass: sources at
    the rows' initial poses against the raw target clouds, also with
    every 4th row frozen), bitwise to nn_plain; timed as the other rows,
    with its launches over both voxel runs."""
    from mrg_slam_tpu_torch.ops import nn_kernel as nk
    from mrg_slam_tpu_torch.ops.cloud import pad_invalid
    from mrg_slam_tpu_torch.utils import se3

    where = "row 2's FAST_VGICP and NDT runs"
    clouds, srcs, inits = bucket
    dev = clouds[0].points.device
    init = torch.from_numpy(inits).to(dev)
    p_src = se3.pose_apply(init[:, None, :], torch.stack(
        [c.points for c in srcs])).contiguous()
    p_sm = torch.stack([c.mask for c in srcs]).contiguous()
    t_m = torch.stack([c.mask for c in clouds]).contiguous()
    p_tgt = pad_invalid(torch.stack([c.points for c in clouds]),
                        t_m).contiguous()
    frozen = p_sm.clone()
    frozen[::4] = False
    check_nn(torch, nk, p_src, p_tgt, "voxel pair bucket, frozen", frozen,
             t_m)
    err = check_nn(torch, nk, p_src, p_tgt, "voxel pair bucket", p_sm, t_m)
    log(f"# nn at the largest voxel pair bucket: {p_src.shape[0]} rows x "
        f"{p_src.shape[1]} lanes: bitwise == plain on every lane, also "
        "with every 4th row frozen")
    real = [(a[ma], b[mb]) for a, b, ma, mb in zip(p_src, p_tgt, p_sm, t_m)]

    def lib_nn():
        return [torch.cdist(a[None], b[None],
                            compute_mode="donot_use_mm_for_euclid_dist"
                            ).min(dim=-1) for a, b in real]

    pairs = float((p_sm.sum(-1).double() * t_m.sum(-1).double()).sum())
    return [timed_row(
        torch, "nn_pairs_voxel", "mrg_slam_tpu_torch/csrc/nn.cu",
        "mrg_slam_tpu/ops/pallas_nn.py:48",
        lambda: nk.nn_cuda(p_src, p_tgt, p_sm, t_m),
        lambda: nk.nn_plain(p_src, p_tgt, p_sm, t_m), lib_nn,
        launches, err,
        *bound(pairs, 9, 0, (p_src.numel() + p_tgt.numel()) * 4
               + p_src.shape[0] * p_src.shape[1] * 12), where=where)]


def voxel_phase(torch):
    """Acceptance row 2 at its width through `baseline_runs.config2_full_
    slam(registration_method=...)` (per frame `replay`) with FAST_VGICP
    and with NDT, each held to REF_VOXEL; the voxel family on the
    structured scene; then nn at the largest voxel pair bucket."""
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    t0 = time.perf_counter()
    out, nn_launches = {}, 0
    with VoxelBucketRecorder(reg) as rec:
        for method in ("FAST_VGICP", "NDT"):
            m, r = replay_row(torch, f"2_full_graph_slam_{method}",
                              lambda: bl.config2_full_slam(
                                  registration_method=method),
                              ref=REF_VOXEL[method])
            if not np.isfinite(r["keyframe_trajectory"]).all():
                raise AssertionError(f"{method}: keyframe poses not finite")
            check_voxel(method, m)
            out[method] = m
            nn_launches += m["launches"]["nn"]
    out["structured_scene"] = ndt_scene_check(torch)
    rows = voxel_kernel_rows(torch, rec.largest, nn_launches)
    out["phase_s"] = time.perf_counter() - t0
    log(f"# voxel phase: {out['phase_s']:.1f} s")
    return out, rows


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    from mrg_slam_tpu_torch.config import PrefilterConfig
    from mrg_slam_tpu_torch.ops import native, nn_kernel, stats_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import downsample_stage, prefilter
    from mrg_slam_tpu_torch.runtime import resolve_device
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse

    dev = resolve_device()
    log(card_line())
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    native.build_all()
    log(f"# kernels built (nvcc, sm_90a) in {native.build_seconds:.1f} s")

    t0 = time.perf_counter()
    inp = front_end_inputs(torch, dev)
    log(f"# production world: {SLAM_FRAMES} of {TRAJ_FRAMES} frames (depth "
        f"cut; the front end runs the first {FRAMES}) "
        f"x {int(inp.rmask.sum(1).float().mean())} raw pts, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # kernel phase inputs on the main path: the first block (B=32 x 8192)
    # as RADIUS removal counts on it (count), the same block prefiltered
    # (moments) and one frame pair of it (nn, 8192^2)
    first = PointCloud(inp.raw[:BLOCK], inp.rmask[:BLOCK])
    vox = downsample_stage(first, inp.pre)
    vox_long = downsample_stage(first, dataclasses.replace(
        inp.pre, capacity_filtered_points=PrefilterConfig()
        .capacity_filtered_points))
    blk = prefilter(first, inp.pre)
    block_pts = pad_invalid(blk.points, blk.mask).contiguous()
    nn_src = blk.points[1:2].contiguous()
    nn_tgt = block_pts[0:1].contiguous()
    rows = kernel_phase(torch, dev, block_pts, blk.mask, nn_src, nn_tgt,
                        vox.points.contiguous(), vox.mask.contiguous(),
                        (vox_long.points.contiguous(),
                         vox_long.mask.contiguous()))
    src1 = reg.make_source(PointCloud(blk.points[1], blk.mask[1]),
                           inp.odo.registration)
    tgt0 = reg.make_target(PointCloud(blk.points[0], blk.mask[0]),
                           inp.odo.registration)
    sync_ms = sync_cost(torch, inp.odo, src1, tgt0)

    counters = (nn_kernel.nn_cuda, stats_kernel.count_cuda,
                stats_kernel.moments_cuda)
    for fn in counters:
        fn.launches = 0
    run1 = front_end(torch, inp)
    launches = {"nn": nn_kernel.nn_cuda.launches,
                "count": stats_kernel.count_cuda.launches,
                "moments": stats_kernel.moments_cuda.launches}
    pose_np = run1.poses.cpu().numpy()
    if pose_np.shape != (FRAMES, 7) or not np.isfinite(pose_np).all():
        raise AssertionError(f"poses {pose_np.shape} not finite")
    ate = ate_rmse(pose_np[:, :3], inp.traj[:FRAMES, :3])
    gn_iters = int(run1.iterations.sum())
    log(f"# front end at full width: {FRAMES} frames, {RAW} raw -> "
        f"{FILTERED} filtered pts, {int(run1.keyframes.sum())} keyframes, "
        f"{gn_iters} GN iterations; ATE {ate:.4f} m (JAX reference "
        f"{REF_ATE_M:.4f} m)")
    log(f"# launches on the main path: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the path")
    if launches["nn"] != gn_iters:
        raise AssertionError(f"nn launches {launches['nn']} != GN "
                             f"iterations {gn_iters}")
    bound_ate = max(REF_ATE_M + 0.05, 1.2 * REF_ATE_M)
    if not ate <= bound_ate:
        raise AssertionError(f"ATE {ate:.4f} m > {bound_ate:.4f} m")

    # throughput: the first pass warms the process, so frames/s is the
    # median of the full passes after it; each must repeat pass 1 bitwise
    runs = [run1] + [front_end(torch, inp) for _ in range(TIMED_PASSES)]
    for r in runs[1:]:
        if not torch.equal(r.poses, run1.poses):
            raise AssertionError("front end rerun: poses not bitwise "
                                 "identical")
    log(f"# {TIMED_PASSES} reruns: poses bitwise identical to pass 1")
    iters_blk = run1.iterations.view(-1, BLOCK).sum(1).tolist()
    for i, r in enumerate(runs):
        log(f"# pass {i + 1}: block walls (ms) "
            f"{[round(w * 1e3, 1) for w in r.block_walls]} for GN "
            f"iterations {iters_blk}; {FRAMES / sum(r.block_walls):.2f} "
            "frames/s")
    fps = float(np.median([FRAMES / sum(r.block_walls) for r in runs[1:]]))
    log(f"# {fps:.2f} frames/s (median of passes 2-{TIMED_PASSES + 1})")
    split = {}
    front_end(torch, inp, split=split)
    per_frame = {k: v / FRAMES * 1e3 for k, v in split.items()}
    log(f"# wall per frame with a sync between stages (ms): {per_frame}")

    for r in rows:
        r["launches"] = launches[r["name"]]
    slam_m, back_nn, slam_run = slam_phase(torch, inp)
    rows.append(pair_nn_phase(torch, slam_run.slam, back_nn,
                              slam_run.ticks))
    rows.extend(lm_kernel_rows(torch, dev,
                               slam_m["lm_launches_by_nodes_cap"]))

    t0 = time.perf_counter()
    mr = mr_inputs(torch, dev)
    log(f"# multi-robot world: {MR_FRAMES} frames x "
        f"{int(mr.rmask.sum(1).float().mean())} raw pts, built in "
        f"{time.perf_counter() - t0:.1f} s")
    mr_m, mr_launches, odo_nn, tick_nn, bucket = mr_phase(torch, mr)
    rows.extend(mr_kernel_rows(torch, mr, mr_launches, odo_nn, tick_nn,
                               bucket))
    solver_m = solver_phase(torch, dev, slam_run.slam.db.graph)
    replay_m, frame_rows = replay_phase(torch)
    rows.extend(frame_rows)
    floor_m = floor_phase(torch, dev)
    exchange_m, exchange_rows = exchange_phase(torch)
    rows.extend(exchange_rows)
    launch_m, launch_rows = launch_phase(torch, inp)
    rows.extend(launch_rows)
    proc_m, proc_rows = processes_phase(torch)
    rows.extend(proc_rows)
    dist_m = dist_phase(torch)
    voxel_m, voxel_rows = voxel_phase(torch)
    rows.extend(voxel_rows)
    log(json.dumps({"frames_per_s": fps,
                    "pass1_frames_per_s": FRAMES / sum(run1.block_walls),
                    "ate_m": ate, "ref_ate_m": REF_ATE_M,
                    "frames": FRAMES, "gn_iterations": gn_iters,
                    "host_sync_ms_per_iter": sync_ms,
                    "stage_ms_per_frame": per_frame,
                    "full_slam": slam_m,
                    "multi_robot": {str(R): v for R, v in mr_m.items()},
                    "solvers": solver_m,
                    "replay": replay_m,
                    "floor": floor_m,
                    "exchange": exchange_m,
                    "launch": launch_m,
                    "processes": proc_m,
                    "distributed": dist_m,
                    "voxel": voxel_m,
                    "build_s": native.build_seconds}))
    log(f"# smoke run: {time.perf_counter() - t_start:.1f} s, kernel builds "
        "included")
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-worker"]:
        # one process of the processes phase's concurrent kernel check
        sys.exit(kernel_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main())
