#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels of `mrg_slam_tpu_torch/csrc/` for sm_90a,
holds each one against its plain PyTorch version on the card at the shapes
of the front end's main path (with and without the rows' masks, ragged
rows included), then drives the front end (prefilter -> fused GICP
odometry) at full width on bench.py's production world and checks its
ATE against the JAX package's on the same frames. Any failed check
raises. The last line of standard output is {"ok": true, "device":
{...}}; the line before it lists every kernel with its launches, error
and times: "ms", "plain_ms" and "library_ms" are one call between CUDA
events (the wrapper's host time included, whenever the card waits for
it), and "device_ms" is the kernel's device time per launch in a CUDA
graph.

Needs a CUDA card; without one it exits non-zero and prints no result.
Imports nothing of JAX and nothing of the JAX package.
"""

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
# (bench.py:166-168); depth is cut from 640 frames to FRAMES so the run
# fits its time limit
RAW, FILTERED, BLOCK, TRAJ_FRAMES, FRAMES = 131072, 8192, 32, 640, 96
# the JAX package's odometry ATE on the same world, configs and FRAMES
# frames, on the CPU: `python tools/front_end_reference.py --frames 96`
REF_ATE_M = 0.2813718731443308
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
    """Median device time of fn() over `reps` runs, CUDA events."""
    for _ in range(warmup):
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


def build_world():
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)

    world = SyntheticWorld.build(seed=11, extent=60.0, n_ground=400000,
                                 n_pillars=150, n_walls=40,
                                 max_points_per_scan=RAW, noise=0.02)
    traj = circle_trajectory(TRAJ_FRAMES, radius=20.0, laps=3.02)[:FRAMES]
    raw = np.full((FRAMES, RAW, 3), 1.0e6, np.float32)
    rmask = np.zeros((FRAMES, RAW), bool)
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


class FrontEndInputs(NamedTuple):
    traj: np.ndarray   # (FRAMES, 7) ground-truth poses
    raw: object        # (FRAMES, RAW, 3) float32 scans on the card
    rmask: object      # (FRAMES, RAW) bool
    stamps: object     # (FRAMES,) float32 seconds
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
        torch.arange(FRAMES, dtype=torch.float32, device=dev) * 0.1, pre,
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


def check_count(torch, sk, pts, r2, name):
    c_k = sk.count_cuda(pts, pts, r2)
    c_p = sk.count_plain(pts, pts, r2)
    torch.cuda.synchronize()
    if not torch.equal(c_k, c_p):
        raise AssertionError(f"count {name}: {(c_k != c_p).sum().item()} "
                             "counts differ from the plain version")
    return float((c_k - c_p).abs().max())


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
    log(f"# moments {name}: |mean| err {e_mean:.3g} (tol {tol_mean:.3g}), "
        f"|cov| err {e_cov:.3g} (tol {tol_cov:.3g}), n<={n:.0f}, X={x:.1f}")
    if not (e_mean <= tol_mean and e_cov <= tol_cov):
        raise AssertionError(f"moments {name}: beyond tolerance")
    return max(e_mean, e_cov), float(c_k[real].sum())


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


def kernel_phase(torch, dev, block_pts, block_mask, nn_src, nn_tgt):
    """Hold every kernel against its plain version; time all three.

    `block_mask` marks the real points of `block_pts` (frame 0 is the nn
    target, frame 1 its source). nn and moments get the rows' masks, as
    on the main path. The bounds count only the pairs of real points,
    which are all the main path needs: pad lanes' results are never
    read."""
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
    check_count(torch, sk, u_pad, r2c, "uniform")
    err_c = check_count(torch, sk, block_pts, r2c, "real block")
    check_moments(torch, sk, u_pad, r2m, "uniform")
    check_moments(torch, sk, block_pts, r2m, "real block, every lane")
    err_m, inside = check_moments(torch, sk, block_pts, r2m, "real block",
                                  block_mask)
    log("# kernels == plain versions on the card (nn bitwise on every lane, "
        "counts exact, moments within the f32 summation bound; with and "
        "without masks)")

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
    def lib_count():
        return [((d <= 0.5) & (d > 0)).sum(-1) for d in (
            torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
            for p in block_pts)]

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
    floor_ms = launch_floor_ms(torch, native)
    rows = []
    for name, src, fk, fp, flib, pairs, opp, extra, out_b, repl in (
            ("nn", "mrg_slam_tpu_torch/csrc/nn.cu",
             lambda: nk.nn_cuda(nn_src, nn_tgt, *nn_masks),
             lambda: nk.nn_plain(nn_src, nn_tgt, *nn_masks), lib_nn,
             pairs_nn, 9, 0, nn_src.shape[1] * 12,
             "mrg_slam_tpu/ops/pallas_nn.py:48"),
            ("count", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
             lambda: sk.count_cuda(block_pts, block_pts, r2c),
             lambda: sk.count_plain(block_pts, block_pts, r2c), lib_count,
             pairs_blk, 11, 0, b * n * 4,
             "mrg_slam_tpu/ops/pallas_stats.py:34"),
            ("moments", "mrg_slam_tpu_torch/csrc/radius_stats.cu",
             lambda: sk.moments_cuda(block_pts, block_pts, r2m, block_mask,
                                     block_mask),
             lambda: sk.moments_plain(block_pts, block_pts, r2m, block_mask,
                                      block_mask),
             lib_moments, pairs_blk, 9, 16 * inside, b * n * 40,
             "mrg_slam_tpu/ops/pallas_stats.py:93")):
        in_b = (nn_src.numel() + nn_tgt.numel()) * 4 if name == "nn" \
            else block_pts.numel() * 4
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; nothing to run", file=sys.stderr)
        return 1
    from mrg_slam_tpu_torch.ops import native, nn_kernel, stats_kernel
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud, pad_invalid
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
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
    log(f"# production world: {FRAMES} of {TRAJ_FRAMES} frames (depth cut) "
        f"x {int(inp.rmask.sum(1).float().mean())} raw pts, built in "
        f"{time.perf_counter() - t0:.1f} s")

    # kernel phase inputs at the main path's shapes: the first prefiltered
    # block (count/moments, B=32 x 8192) and one frame pair (nn, 8192^2)
    blk = prefilter(PointCloud(inp.raw[:BLOCK], inp.rmask[:BLOCK]), inp.pre)
    block_pts = pad_invalid(blk.points, blk.mask).contiguous()
    nn_src = blk.points[1:2].contiguous()
    nn_tgt = block_pts[0:1].contiguous()
    rows = kernel_phase(torch, dev, block_pts, blk.mask, nn_src, nn_tgt)
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
    ate = ate_rmse(pose_np[:, :3], inp.traj[:, :3])
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
    log(json.dumps({"frames_per_s": fps,
                    "pass1_frames_per_s": FRAMES / sum(run1.block_walls),
                    "ate_m": ate, "ref_ate_m": REF_ATE_M,
                    "frames": FRAMES, "gn_iterations": gn_iters,
                    "host_sync_ms_per_iter": sync_ms,
                    "stage_ms_per_frame": per_frame,
                    "build_s": native.build_seconds}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
