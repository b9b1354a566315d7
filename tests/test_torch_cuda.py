"""The port's CUDA kernels against their plain versions, on the card,
and the paths around them (pair program, ticks, large-graph solvers,
the per-frame front end's top-k kNN, kNN covariances, STATISTICAL mask,
deskew and odometry) against the same on the CPU.

Needs a CUDA card (marker `cuda`); without one every test skips. On a
machine with a card and without JAX (tests/conftest.py imports it):
`python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""`.
chip_smoke.py makes the same checks at the main path's full shapes.

Tolerances: nn indices and d2 bitwise (both round d2 step by step with no
FMA), counts exact (on voxel-grid rows of the front end's shape and of
the default capacity, one-cell rows, pairs at the radius across cell
faces, duplicates, masked and all-masked rows), moments within the
float32 summation bound of two orders (see chip_smoke.check_moments). With masks (B rows whose valid
lanes end at different lanes, holes, a row without a valid lane; masked
lanes padded or not), nn stays bitwise on every lane and moments hold on
the valid lanes, with the fixed values on the masked lanes.
"""

import numpy as np
import pytest
import torch

from mrg_slam_tpu_torch.ops import knn, nn_kernel, stats_kernel
from mrg_slam_tpu_torch.ops.cloud import pad_invalid

pytestmark = pytest.mark.cuda
U32 = 2.0 ** -24


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(rng, dev, b, n):
    pts = rng.uniform(-45, 45, size=(b, n, 3)).astype(np.float32)
    pts[:, n // 2:] = pts[:, n // 2:] * 0.02 + 30.0  # a dense cluster
    pts[:, 10:20] = pts[:, :10]  # duplicates
    mask = np.ones((b, n), bool)
    mask[:, -n // 8:] = False
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("b,n,m", [(1, 1000, 3000), (3, 513, 257),
                                   (1, 8192, 8192)])
def test_nn_kernel_matches_plain(rng, dev, b, n, m):
    src, _ = _cloud(rng, dev, b, n)
    tgt, tmask = _cloud(rng, dev, b, m)
    tgt = pad_invalid(tgt, tmask).contiguous()
    d_k, i_k = nn_kernel.nn_cuda(src, tgt)
    d_p, i_p = nn_kernel.nn_plain(src, tgt)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))


def test_nn_kernel_empty_target(rng, dev):
    src, _ = _cloud(rng, dev, 1, 300)
    d2, idx = knn.nearest_neighbor(src, torch.zeros_like(src),
                                   torch.zeros(src.shape[:2], dtype=bool,
                                               device=dev))
    assert torch.isinf(d2).all() and (idx == 0).all()


def _extent_cloud(rng, dev, ends, n, holes=(), padded=True):
    """B rows of n lanes whose valid lanes end at `ends` (none for 0),
    with hole lanes; the masked lanes sit at PAD_VALUE or, unpadded, hold
    points like the valid ones. -> (points, mask)."""
    pts, _ = _cloud(rng, dev, len(ends), n)
    lanes = torch.arange(n, device=dev)
    mask = lanes[None, :] < torch.tensor(ends, device=dev)[:, None]
    for h in holes:
        mask[:, h] = False
    for r, e in enumerate(ends):
        if e:
            mask[r, e - 1] = True
    if padded:
        pts = pad_invalid(pts, mask).contiguous()
    return pts, mask


# (where the source rows' valid lanes end, the same for the targets,
# lanes, hole lanes)
_EXTENTS = [((997, 3, 0), (1, 640, 999), 1000, ()),
            ((4057,), (3783,), 8192, ()),
            ((700, 129, 257), (300, 513, 1), 800, (5, 128, 129, 255))]


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_nn_kernel_extents_match_plain(rng, dev, sext, text, n, holes,
                                       padded):
    src, smask = _extent_cloud(rng, dev, sext, n, holes, padded)
    tgt, tmask = _extent_cloud(rng, dev, text, n, holes, padded)
    d_k, i_k = nn_kernel.nn_cuda(src, tgt, smask, tmask)
    d_p, i_p = nn_kernel.nn_plain(src, tgt, smask, tmask)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.isinf(d_k[~smask]).all() and (i_k[~smask] == 0).all()


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_moments_kernel_extents_match_plain(rng, dev, sext, text, n, holes,
                                            padded):
    p, mask = _extent_cloud(rng, dev, sext, n, holes, padded)
    r2 = stats_kernel.radius_sq(0.6)
    m_k = stats_kernel.moments_cuda(p, p, r2, mask, mask)
    m_p = stats_kernel.moments_plain(p, p, r2, mask, mask)
    torch.cuda.synchronize()
    assert (m_k[~mask] == 0).all()
    c_k, mn_k, v_k = stats_kernel.moments_to_mean_cov(m_k)
    c_p, mn_p, v_p = stats_kernel.moments_to_mean_cov(m_p)
    assert torch.equal(c_k[mask], c_p[mask])
    n_max = float(c_k[mask].max())
    x = float(p[mask].abs().max())
    tol_mean = 2 * n_max * U32 * x
    assert float((mn_k - mn_p)[mask].abs().max()) <= tol_mean
    assert float((v_k - v_p)[mask].abs().max()) <= (
        2 * n_max * U32 * x * x + 2 * x * tol_mean)


@pytest.mark.parametrize("b,n", [(1, 1000), (4, 2048)])
def test_stats_kernels_match_plain(rng, dev, b, n):
    pts, mask = _cloud(rng, dev, b, n)
    p = pad_invalid(pts, mask).contiguous()
    r2 = stats_kernel.radius_sq(0.6)
    for cloud, m in ((p, None), (p, mask), (pts, mask)):
        assert torch.equal(stats_kernel.count_cuda(cloud, m, r2),
                           stats_kernel.count_plain(cloud, m, r2))
    c_k, m_k, v_k = stats_kernel.moments_to_mean_cov(
        stats_kernel.moments_cuda(p, p, r2))
    c_p, m_p, v_p = stats_kernel.moments_to_mean_cov(
        stats_kernel.moments_plain(p, p, r2))
    assert torch.equal(c_k[mask], c_p[mask])
    n_max = float(c_k[mask].max())
    x = float(pts[mask].abs().max())
    tol_mean = 2 * n_max * U32 * x
    assert float((m_k - m_p)[mask].abs().max()) <= tol_mean
    assert float((v_k - v_p)[mask].abs().max()) <= (
        2 * n_max * U32 * x * x + 2 * x * tol_mean)


def _voxel_rows(rng, b=32, n=8192):
    """The front end's count input in shape: rows of n voxel means (a
    0.3 m grid on a ground plane and on walls, jittered), every lane
    valid."""
    g = np.stack(np.meshgrid(np.arange(-100, 100), np.arange(-100, 100),
                             indexing="ij"), -1).reshape(-1, 2) * 0.3
    rows = []
    for _ in range(b):
        ground = g[rng.choice(len(g), n // 2, replace=False)]
        ground = np.concatenate([ground, np.full((n // 2, 1), -1.7)], 1)
        wall = g[rng.choice(len(g), n - n // 2, replace=False)] / 3
        wall = np.stack([np.full(len(wall), 12.0), wall[:, 0], wall[:, 1]],
                        1)
        rows.append(np.concatenate([ground, wall]))
    pts = np.stack(rows) + rng.normal(0, 0.02, (b, n, 3))
    return pts.astype(np.float32), np.ones((b, n), bool)


def _one_cell_rows(rng, b=2, n=3000):
    c, _ = stats_kernel.count_cell(stats_kernel.radius_sq(0.5))
    pts = rng.uniform(0.01, 0.3, (b, n, 3)) + 7 * c
    return pts.astype(np.float32), np.ones((b, n), bool)


def _boundary_rows(rng, b=4, n=4096):
    """Pairs about r = 0.5 m apart (within a few float32 steps of r^2 on
    either side), each crossing a cell face, at up to +-45 m."""
    c, _ = stats_kernel.count_cell(stats_kernel.radius_sq(0.5))
    k = n // 2
    v = rng.normal(size=(b, k, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    a = rng.integers(-89, 89, (b, k, 3)) * c - 0.25 * v
    s = 0.5 * (1 + rng.integers(-4, 5, (b, k, 1)) * 2.0 ** -22)
    pts = np.concatenate([a, a + s * v], 1)
    return pts.astype(np.float32), np.ones((b, n), bool)


def _uniform_rows(rng, b=2, n=8192):
    """+-45 m, exact duplicates, a masked tail and an all-masked row."""
    pts = rng.uniform(-45, 45, (b, n, 3)).astype(np.float32)
    pts[:, n // 2:n // 2 + 256] = pts[:, :256]
    mask = np.ones((b, n), bool)
    mask[:, -n // 16:] = False
    mask[-1] = False
    return pts, mask


_COUNT_CASES = {"voxel_rows": _voxel_rows, "one_cell": _one_cell_rows,
                "boundary": _boundary_rows, "uniform": _uniform_rows}


@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
def test_count_kernel_matches_plain(rng, dev, case):
    """Exact on every lane, masked lanes 0, with the row's mask and with
    None (every lane)."""
    pts, mask = (torch.from_numpy(a).to(dev)
                 for a in _COUNT_CASES[case](rng))
    r2 = stats_kernel.radius_sq(0.5)
    for m in (mask, None):
        c_k = stats_kernel.count_cuda(pts, m, r2)
        c_p = stats_kernel.count_plain(pts, m, r2)
        torch.cuda.synchronize()
        assert torch.equal(c_k, c_p)
    assert (c_k.sum() > 0) and (
        stats_kernel.count_cuda(pts, mask, r2)[~mask] == 0).all()


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("sext,text,n,holes", _EXTENTS)
def test_count_kernel_masks_match_plain(rng, dev, sext, text, n, holes,
                                        padded):
    p, mask = _extent_cloud(rng, dev, sext, n, holes, padded)
    r2 = stats_kernel.radius_sq(0.5)
    assert torch.equal(stats_kernel.count_cuda(p, mask, r2),
                       stats_kernel.count_plain(p, mask, r2))


@pytest.mark.parametrize("n", [8192, 8193, 32768])
def test_count_kernel_long_rows_match_plain(rng, dev, n):
    """Rows at the edge of a block's shared memory (8192 lanes bin there,
    8193 in global memory) and at the port's default capacity
    (`PrefilterConfig.capacity_filtered_points`, 32768), through
    `knn.radius_count` as prefilter calls it: exact, with a masked tail."""
    from mrg_slam_tpu_torch.config import PrefilterConfig

    assert PrefilterConfig().capacity_filtered_points == 32768
    pts, mask = _voxel_rows(rng, b=2, n=n)
    mask[:, -n // 8:] = False
    pts, mask = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    launches = stats_kernel.count_cuda.launches
    got = knn.radius_count(pts, mask, 0.5)
    assert stats_kernel.count_cuda.launches == launches + 1
    want = stats_kernel.count_plain(pts, mask, stats_kernel.radius_sq(0.5))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert want.sum() > 0


# -- the back end's pair program and tick ---------------------------------

def test_nn_kernel_pair_program_rows_match_plain(rng, dev):
    """64 rows as the pair program hands them over: ragged source and
    target masks, a quarter of the rows frozen (every source lane masked)
    and a row with no valid target; bitwise on every lane."""
    b, n = 64, 4096
    src, smask = _cloud(rng, dev, b, n)
    tgt, tmask = _cloud(rng, dev, b, n)
    ends = torch.from_numpy(rng.integers(1, n, size=(b, 2))).to(dev)
    lanes = torch.arange(n, device=dev)
    smask = smask & (lanes < ends[:, :1])
    tmask = tmask & (lanes < ends[:, 1:])
    smask[::4] = False
    tmask[5] = False
    tgt = pad_invalid(tgt, tmask).contiguous()
    d_k, i_k = nn_kernel.nn_cuda(src, tgt, smask, tmask)
    d_p, i_p = nn_kernel.nn_plain(src, tgt, smask, tmask)
    torch.cuda.synchronize()
    assert torch.equal(i_k, i_p)
    assert torch.equal(d_k.view(torch.int32), d_p.view(torch.int32))
    assert torch.isinf(d_k[::4]).all() and torch.isinf(d_k[5]).all()


def _small_world(n_frames):
    """Clouds (256 lanes), covariances and drifting odometry of 1.2 laps
    of a small world, as tests/test_torch_backend.py builds them."""
    from mrg_slam_tpu_torch.config import PrefilterConfig, RegistrationConfig
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
    from mrg_slam_tpu_torch.utils import se3np

    w = SyntheticWorld.build(seed=5, extent=30.0, n_ground=25000,
                             n_pillars=25, n_walls=10,
                             max_points_per_scan=4096, noise=0.02)
    traj = circle_trajectory(66, radius=12.0, laps=1.2)[:n_frames]
    pre = PrefilterConfig(downsample_resolution=0.5,
                          capacity_filtered_points=256,
                          outlier_removal_method="NONE")
    regc = RegistrationConfig(
        reg_transformation_epsilon=1e-3, reg_maximum_iterations=16,
        reg_covariance_radius=1.0, reg_stall_epsilon=0.01,
        reg_coarse_stride=2, reg_coarse_iterations=6)
    rng = np.random.default_rng(3)
    start_inv = se3np.pose_inverse(traj[0])
    drift = se3np.pose_identity()
    clouds, covs, odom = [], [], []
    for i, p in enumerate(traj):
        step = np.concatenate([rng.normal(0, 0.01, 3), [1.0],
                               rng.normal(0, 0.002, 3)]).astype(np.float32)
        step[3:] /= np.linalg.norm(step[3:])
        if i:
            drift = se3np.pose_compose(drift, step)
        odom.append(se3np.pose_compose(se3np.pose_compose(start_inv, p),
                                       drift))
        c = prefilter(PointCloud.from_array(w.scan(p, seed=i), 4096,
                                            device="cpu"), pre)
        clouds.append((c.points.numpy(), c.mask.numpy()))
        covs.append(reg.make_source(c, regc).covs.numpy())
    return regc, clouds, covs, odom


def test_pair_program_on_the_card_matches_the_cpu(dev):
    """The batched pair program on the card against the port on the CPU,
    on the same rows: evaluate-only, registration, disjoint and budget-1
    rows. Iterations and converged equal, poses within 1e-4."""
    from mrg_slam_tpu_torch.ops import registration as reg
    from mrg_slam_tpu_torch.ops.covariance import GICPCloud
    from mrg_slam_tpu_torch.utils import se3np

    regc, clouds, covs, odom = _small_world(56)
    pairs = [(10, 12, 0), (20, 22, 16), (30, 31, 16), (5, 17, 16),
             (44, 46, 1), (50, 52, 3), (0, 40, 16), (10, 12, 16)]
    inits = np.stack([se3np.pose_between(odom[a], odom[b])
                      for a, b, _ in pairs])
    inits[6, 0] += 100.0  # disjoint

    def run(device):
        def g(i):
            return GICPCloud(*(torch.from_numpy(np.array(x)).to(device)
                               for x in (*clouds[i], covs[i])))
        return reg.align_pairs_packed(
            regc, [g(a) for a, _, _ in pairs], [g(b) for _, b, _ in pairs],
            inits, [m for _, _, m in pairs], [2.0] * len(pairs)).cpu()

    got, want = run(dev), run("cpu")
    assert torch.equal(got[:, 7:10], want[:, 7:10])
    torch.testing.assert_close(got[:, :7], want[:, :7], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[:, 10:], want[:, 10:], rtol=1e-4,
                               atol=0)
    assert (got[:, 8] > 0).sum() >= 6


def test_tick_on_the_card_matches_the_cpu(dev):
    """Two ticks of MrgSlam on the card against the same on the CPU, from
    the same clouds, covariances and odometry: the same keyframes and
    loops, chi2 within rel 1e-3, keyframe poses within 1e-3 m."""
    import dataclasses

    from mrg_slam_tpu_torch.config import (LoopClosureConfig,
                                           OptimizerConfig, SlamConfig)
    from mrg_slam_tpu_torch.models.backend import MrgSlam
    from mrg_slam_tpu_torch.ops.cloud import PointCloud

    regc, clouds, covs, odom = _small_world(66)
    cfg = SlamConfig(
        own_name="atlas", multi_robot_names=("atlas",),
        keyframe_delta_trans=2.0, capacity_keyframes=16, capacity_edges=32,
        capacity_keyframe_points=256, registration=regc,
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=64),
        loop=dataclasses.replace(LoopClosureConfig(), capacity_candidates=4,
                                 fitness_score_max_range=2.0),
        robot_remove_points_radius=0.0)

    def run(device):
        slam = MrgSlam(cfg, device=device)
        chi2 = []
        for i in range(66):
            slam.process_scan(i * 0.1, odom[i], PointCloud(
                *(torch.from_numpy(x).to(device) for x in clouds[i])),
                source_covs=torch.from_numpy(covs[i]).to(device))
            if (i + 1) % 33 == 0:
                st = slam.optimization_tick(now=i * 0.1)
                chi2.append((st.chi2_before, st.chi2_after))
        return slam, np.asarray(chi2)

    (gpu, c_gpu), (cpu, c_cpu) = run(dev), run("cpu")
    assert gpu.db.graph.cap["nodes"] > 16  # the store grew on the card
    assert len(gpu.db.keyframes) == len(cpu.db.keyframes)
    loops = [sorted((e.from_readable, e.to_readable) for e in s.db.edges
                    if e.type == "loop") for s in (gpu, cpu)]
    assert loops[0] and loops[0] == loops[1]
    np.testing.assert_allclose(c_gpu, c_cpu, rtol=1e-3, atol=1e-6)
    assert np.abs(gpu.trajectory()[:, :3]
                  - cpu.trajectory()[:, :3]).max() < 1e-3


def test_run_batch_multi_on_the_card_matches_the_cpu(dev):
    """Two robots' six-frame blocks through run_batch_multi on the card
    and on the CPU (tests/test_torch_multirobot.py holds the CPU to the
    JAX package): the same keyframe flags, every solve converged within
    16 of its 32 iterations, and poses within the end-to-end odometry
    tolerance of tests/test_torch_odometry.py, 2.5 cm and 0.01 on
    quaternion components. Iterations are not compared: the card's
    batched products sum in another order than the CPU's, so a solve may
    stop a step apart at the 1e-3 epsilon exit and the chain carries the
    difference into the next frames' guesses and targets. The inputs are
    frames on which every solve converges quickly, because a slow one
    does not agree across devices in this small world (256-point
    clouds): on an H100, frames 30 -> 31 crawled to the exit in 24
    iterations, the CPU in 25, 15 cm apart, and frames 0 -> 1 at a
    16-iteration budget oscillated and ended 4 cm apart."""
    import dataclasses

    from mrg_slam_tpu_torch.config import ScanMatchingOdometryConfig
    from mrg_slam_tpu_torch.models import odometry_fused as fused

    regc, clouds, _, _ = _small_world(44)
    cfg = ScanMatchingOdometryConfig(
        keyframe_delta_translation=2.0,
        registration=dataclasses.replace(regc, reg_stall_epsilon=0.0,
                                         reg_coarse_stride=1,
                                         reg_maximum_iterations=32))
    frames = [list(range(4, 16, 2)), list(range(32, 44, 2))]
    pts = np.stack([np.stack([clouds[f][0] for f in fr]) for fr in frames])
    masks = np.stack([np.stack([clouds[f][1] for f in fr]) for fr in frames])

    def run(device):
        carries = fused.stack_carries([fused.init_carry(256, device=device)
                                       for _ in frames])
        _, out = fused.run_batch_multi(
            cfg, carries, torch.from_numpy(pts).to(device),
            torch.from_numpy(masks).to(device),
            torch.arange(6, dtype=torch.float32, device=device).expand(2, 6))
        return out

    got, want = run(dev), run("cpu")
    assert want.iterations.max() <= 16 and got.iterations.max() <= 16
    assert torch.equal(got.is_new_keyframe.cpu(), want.is_new_keyframe)
    pose, ref = got.pose.cpu(), want.pose
    torch.testing.assert_close(pose[..., :3], ref[..., :3], rtol=0,
                               atol=2.5e-2)
    sign = torch.sign((pose[..., 3:] * ref[..., 3:]).sum(-1, keepdim=True))
    torch.testing.assert_close(pose[..., 3:] * sign, ref[..., 3:], rtol=0,
                               atol=1e-2)


def test_shared_graph_ticks_on_the_card_match_the_cpu(dev):
    """Two robots in one SharedGraphSlam, two ticks, on the card and on
    the CPU from the same clouds, covariances and odometry: the same
    keyframes and loops (inter-robot ones among them), chi2 within rel
    1e-3, keyframe poses within 1e-3 m."""
    import dataclasses

    from mrg_slam_tpu_torch.config import (LoopClosureConfig,
                                           OptimizerConfig, SlamConfig)
    from mrg_slam_tpu_torch.models.shared_graph import SharedGraphSlam
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.utils import se3np

    regc, clouds, covs, odom = _small_world(66)
    names, windows = ("alpha", "bravo"), ((0, 36), (30, 66))
    cfg = SlamConfig(
        own_name="alpha", multi_robot_names=names,
        keyframe_delta_trans=2.0, capacity_keyframes=64, capacity_edges=128,
        capacity_keyframe_points=256, registration=regc,
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=64),
        loop=dataclasses.replace(LoopClosureConfig(), capacity_candidates=2,
                                 fitness_score_max_range=2.0,
                                 accum_distance_thresh_other_robot=2.0),
        robot_remove_points_radius=0.0)

    def run(device):
        # each robot starts at its first odometry pose (bench.py's
        # placement), so both chains share one map frame
        starts = {n: odom[lo] for n, (lo, _) in zip(names, windows)}
        group = SharedGraphSlam(cfg, names, {
            n: (*p[:3], 2.0 * np.arctan2(p[6], p[3]), 0.0, 0.0)
            for n, p in starts.items()}, device=device)
        chi2 = []
        for i in range(36):
            for name, (lo, _) in zip(names, windows):
                rel = se3np.pose_between(odom[lo], odom[lo + i])
                group.process_scan(name, i * 0.1, rel, PointCloud(
                    *(torch.from_numpy(x).to(device)
                      for x in clouds[lo + i])),
                    source_covs=torch.from_numpy(covs[lo + i]).to(device))
            if (i + 1) % 18 == 0:
                st = group.optimization_tick(now=i * 0.1)
                chi2.append((st.chi2_before, st.chi2_after))
        return group, np.asarray(chi2)

    (gpu, c_gpu), (cpu, c_cpu) = run(dev), run("cpu")

    def loops(g):
        kfs = g.db.uuid_keyframe_map
        return sorted((kfs[e.from_uuid].readable_id,
                       kfs[e.to_uuid].readable_id)
                      for e in g.db.edges if e.type == "loop")

    assert len(gpu.db.keyframes) == len(cpu.db.keyframes)
    assert loops(gpu) == loops(cpu)
    assert any(a.split(".")[0] != b.split(".")[0] for a, b in loops(cpu))
    np.testing.assert_allclose(c_gpu, c_cpu, rtol=1e-3, atol=1e-6)
    for name in names:
        assert np.abs(gpu.trajectory(name)[:, :3]
                      - cpu.trajectory(name)[:, :3]).max() < 1e-3


def _solver_ring(device, n=256):
    """bench.py's solver graph at n nodes: build_ring_graph(seed 0) and
    n/128 Huber chords across it."""
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph
    from mrg_slam_tpu_torch.utils import se3np

    gs = build_ring_graph(n_nodes=n, capacity_nodes=n, capacity_edges=2 * n,
                          seed=0, device=device)
    info = np.diag([100.0] * 3 + [400.0] * 3).astype(np.float32)
    for i in range(0, n - n // 2, 64):
        j = i + n // 2
        gs.add_se3_edge(i, j, se3np.pose_between(gs.poses[i], gs.poses[j]),
                        info * 0.25, kernel="Huber", kernel_delta=1.0)
    return gs


@pytest.mark.parametrize("backend", ["cg", "chain"])
def test_large_graph_lm_on_the_card_matches_the_cpu(dev, backend):
    """The cg and chain LM backends on the card against the CPU port
    (tests/test_torch_cg.py and test_torch_chain.py hold the CPU to the
    JAX package) on a 256-node ring with chords: chi2 within rel 1e-3,
    the ROADMAP's solver gate, and poses within 1e-2 m (the two devices'
    float32 rounding moves a 40-iteration LM on a 20 m ring by mm)."""
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph import solve

    cfg = OptimizerConfig(solver_backend=backend,
                          g2o_solver_num_iterations=40)
    gpu = solve.optimize(_solver_ring(dev).snapshot(), cfg)
    cpu = solve.optimize(_solver_ring("cpu").snapshot(), cfg)
    np.testing.assert_allclose(float(gpu.chi2_initial),
                               float(cpu.chi2_initial), rtol=1e-5)
    np.testing.assert_allclose(float(gpu.chi2_final), float(cpu.chi2_final),
                               rtol=1e-3)
    assert float(gpu.chi2_final) < 0.01 * float(gpu.chi2_initial)
    assert np.abs(gpu.poses.cpu().numpy()[:, :3]
                  - cpu.poses.numpy()[:, :3]).max() < 1e-2


def test_chain_marginals_on_the_card_match_the_cpu(dev):
    """chain_marginals (float64 inside) on the card against the CPU port
    on the same ring: within 1e-4 of the largest entry (the float32
    linearizations of the two devices round differently), the fixed node
    zero."""
    from mrg_slam_tpu_torch.graph import chain_solver, solve

    out = []
    for device in (dev, "cpu"):
        g = _solver_ring(device).snapshot()
        out.append(chain_solver.chain_marginals(
            g, solve.chain_aux_for(g), 64).cpu().numpy())
    gpu, cpu = out
    assert np.isfinite(gpu).all() and (gpu[0] == 0).all()
    assert np.abs(gpu - cpu).max() <= 1e-4 * np.abs(cpu).max()


# ---------------------------------------------------------------------------
# the per-frame front end's plain-torch ops (top-k kNN and what uses it,
# deskew) on the card against the same on the CPU, at the acceptance rows'
# width (1024 filtered lanes) and bench's (8192 filtered, 131072 raw)
# ---------------------------------------------------------------------------

def _scan_rows(rng, n):
    """A voxelized LiDAR-like cloud 5-40 m out (ground, a wall, clutter),
    its last eighth masked and at PAD_VALUE."""
    g = np.stack([rng.uniform(5, 40, n // 2), rng.uniform(-15, 15, n // 2),
                  rng.normal(-1.5, 0.02, n // 2)], 1)
    w = np.stack([rng.uniform(5, 40, n // 4), 9 + rng.normal(0, 0.02, n // 4),
                  rng.uniform(-1.5, 2, n // 4)], 1)
    c = rng.uniform([5, -15, -1.5], [40, 15, 4], (n - n // 2 - n // 4, 3))
    pts = np.concatenate([g, w, c]).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-n // 8:] = False
    pts[~mask] = 1e6
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.mark.parametrize("n,k", [(1024, 11), (8192, 31)])
def test_knn_on_the_card_matches_the_cpu(rng, dev, n, k):
    """Top-k kNN: indices and d2 bitwise (the same elementwise float32
    ops, unique int64 keys for the top-k), ties to the lowest index."""
    pts, mask = _scan_rows(rng, n)
    pts[7] = pts[3]  # a duplicate: a tie at distance 0
    d_c, i_c = knn.knn(pts, pts, mask, k)
    d_g, i_g = knn.knn(pts.to(dev), pts.to(dev), mask.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(i_g.cpu(), i_c)
    assert torch.equal(d_g.cpu(), d_c)
    assert i_c[3, 0] == 3 and i_c[3, 1] == 7 and i_c[7, 0] == 3


@pytest.mark.parametrize("n", [1024, 8192])
def test_knn_covariances_and_statistical_mask_on_the_card(rng, dev, n):
    """kNN covariances against the CPU's, the same neighbours (knn is
    bitwise) summed in another order: the mean of k terms up to X differs
    by at most tol_mean = 2 (k - 1) u X between two orders, the covariance
    of the centred neighbours (up to D from their mean) by tol_cov =
    2 D tol_mean + 2 (k - 1) u D^2, and the regularized matrix, which
    turns with the normal, by 12 tol_cov / gap (Davis-Kahan; gap = the two
    smallest eigenvalues' distance), as tests/test_torch_ops.py bounds the
    radius covariances. The STATISTICAL mask equal."""
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.covariance import estimate_covariances
    from mrg_slam_tpu_torch.ops.prefilter import statistical_outlier_mask
    from mrg_slam_tpu_torch.runtime import pin_numerics

    pin_numerics()
    k = 10
    pts, mask = _scan_rows(rng, n)
    cpu = PointCloud(pts, mask)
    gpu = PointCloud(pts.to(dev), mask.to(dev))
    c_c = estimate_covariances(cpu, k=k).covs
    c_g = estimate_covariances(gpu, k=k).covs.cpu()
    _, idx = knn.knn(pts, pts, mask, k)
    nb = pts.double()[idx]
    cen = nb - nb.mean(1, keepdim=True)
    ev = torch.linalg.eigvalsh(cen.transpose(1, 2) @ cen / k)
    gap = (ev[:, 1] - ev[:, 0]).clamp(min=1e-12)
    x = float(pts[mask].abs().max())
    d = cen.norm(dim=-1).max(-1).values
    tol_mean = 2 * (k - 1) * U32 * x
    tol_cov = 2 * d * tol_mean + 2 * (k - 1) * U32 * d * d
    diff = (c_g - c_c).abs().amax((1, 2)).double()
    assert (diff <= (12 * tol_cov / gap).clamp(max=2.0) + 1e-5)[mask].all()
    assert (diff[mask & (gap > 0.05)] < 1e-3).all()
    assert torch.equal(c_g[~mask], c_c[~mask])
    m_c = statistical_outlier_mask(cpu, 30, 1.2)
    m_g = statistical_outlier_mask(gpu, 30, 1.2).cpu()
    assert torch.equal(m_g, m_c)
    assert 0 < (mask & ~m_c).sum() < n // 4


@pytest.mark.parametrize("n", [8192, 131072])
def test_deskew_on_the_card_matches_the_cpu(rng, dev, n):
    """Deskew at raw coordinates up to 45 m. sin, cos and the 3x3 products
    round differently on the two devices, a few ulps of each rotation
    entry, so a point moves by at most 8 u |p|_1 (6e-5 m at 45 m a
    coordinate); with no angular velocity the points stay bit for bit."""
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import deskew
    from mrg_slam_tpu_torch.runtime import pin_numerics

    pin_numerics()
    pts = torch.from_numpy(rng.uniform(-45, 45, (n, 3)).astype(np.float32))
    mask = torch.ones(n, dtype=torch.bool)
    mask[-100:] = False
    frac = torch.linspace(0.0, 1.0, n)
    w = torch.tensor([0.3, -0.2, 1.5])
    out_c = deskew(PointCloud(pts, mask), frac, w, 0.1)
    out_g = deskew(PointCloud(pts.to(dev), mask.to(dev)), frac.to(dev),
                   w.to(dev), 0.1)
    err = (out_g.points.cpu() - out_c.points).abs().amax(-1)
    assert (err <= 8 * U32 * pts.abs().sum(-1))[mask].all()
    assert (out_g.points.cpu()[~mask] == 1e6).all()
    assert torch.equal(out_g.mask.cpu(), mask)
    ident = deskew(PointCloud(pts.to(dev), mask.to(dev)), frac.to(dev),
                   torch.zeros(3, device=dev), 0.1)
    assert torch.equal(ident.points.cpu()[mask], pts[mask])


def test_scan_matching_odometry_on_the_card_matches_the_cpu(dev):
    """Per-frame odometry over 12 frames of tests/test_torch_scan_odometry
    .py's world (512 lanes, 1 m a frame) on the card and the CPU: keyframe
    flags equal and ATE within 1 cm. The moments kernel and its plain
    version sum in other orders, and the ~1e-4 of float32 noise that
    leaves in a covariance moves a solve by up to ~1 cm, which the chain
    carries on (ROADMAP.md §3, "Covariance noise"), so poses are not held
    one by one."""
    from mrg_slam_tpu_torch.config import (PrefilterConfig,
                                           RegistrationConfig,
                                           ScanMatchingOdometryConfig)
    from mrg_slam_tpu_torch.io.synthetic import (SyntheticWorld,
                                                 circle_trajectory)
    from mrg_slam_tpu_torch.models.odometry import ScanMatchingOdometry
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.prefilter import prefilter
    from mrg_slam_tpu_torch.utils.metrics import ate_rmse

    w = SyntheticWorld.build(seed=9, extent=30.0, n_ground=20000,
                             max_points_per_scan=2048, noise=0.01)
    traj = circle_trajectory(30, radius=12.0, laps=0.4)[:12]
    pre = PrefilterConfig(downsample_resolution=0.6,
                          capacity_filtered_points=512,
                          outlier_removal_method="NONE")
    clouds = [prefilter(PointCloud.from_array(w.scan(p, seed=i), 2048,
                                              device="cpu"), pre)
              for i, p in enumerate(traj)]
    cfg = ScanMatchingOdometryConfig(
        keyframe_delta_translation=2.0,
        registration=RegistrationConfig(reg_transformation_epsilon=1e-3,
                                        reg_maximum_iterations=32))
    outs = {}
    for d in ("cpu", dev):
        odo = ScanMatchingOdometry(cfg)
        outs[str(d)] = [odo.step(PointCloud(c.points.to(d), c.mask.to(d)),
                                 stamp=i * 0.1)
                        for i, c in enumerate(clouds)]
    a, b = outs["cpu"], outs[str(dev)]
    assert [o.is_new_keyframe for o in a] == [o.is_new_keyframe for o in b]
    assert sum(o.is_new_keyframe for o in a) >= 3
    ate = [ate_rmse(np.stack([o.pose for o in r])[:, :3], traj[:, :3])
           for r in (a, b)]
    assert abs(ate[0] - ate[1]) < 0.01 and max(ate) < 0.1


def test_floor_detection_on_the_card_matches_the_cpu(rng, dev):
    """FloorDetection on a filtered-scan-sized cloud (a floor 1.5 m down,
    a wall, clutter) on the card and the CPU with the same RANSAC
    triplets (drawn on the CPU from the same seed): the same verdict and
    coefficients within 1e-4; the card's own generator draws on the card
    and finds the floor too."""
    from mrg_slam_tpu_torch.config import FloorDetectionConfig
    from mrg_slam_tpu_torch.models.floor_detection import FloorDetection
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.ops.ransac import sample_triplets

    g = np.stack([rng.uniform(-25, 25, 700), rng.uniform(-25, 25, 700),
                  rng.normal(-1.5, 0.02, 700)], 1)
    w = np.stack([rng.uniform(-20, 20, 200), np.full(200, 12.0),
                  rng.uniform(-1.5, 1.5, 200)], 1)
    c = rng.uniform([-20, -20, -1.5], [20, 20, 1.0], (100, 3))
    pts = np.concatenate([g, w, c]).astype(np.float32)
    cfg = FloorDetectionConfig(enable_floor_detection=True,
                               sensor_height=1.5, floor_pts_thresh=150)

    def sampler():
        gen = torch.Generator()
        gen.manual_seed(3)
        return lambda mask, num: sample_triplets(mask.cpu(), num, gen).to(
            mask.device)

    out = [FloorDetection(cfg, sampler=sampler()).detect(
        PointCloud.from_array(pts, 1024, device=d), 0.5)
        for d in ("cpu", dev)]
    assert out[0] is not None and out[1] is not None
    np.testing.assert_allclose(out[1].coeffs, out[0].coeffs, atol=1e-4)
    own = FloorDetection(cfg, seed=1).detect(
        PointCloud.from_array(pts, 1024, device=dev), 0.5)
    assert own is not None and own.coeffs[2] > 0.99
    assert abs(own.coeffs[3] - 1.5) < 0.05


def test_floor_detection_reads_the_card_once(rng, dev):
    """A warm FloorDetection.detect on the card, with normal filtering
    and a tilt, makes one synchronizing call: its packed read."""
    import warnings

    from mrg_slam_tpu_torch.config import FloorDetectionConfig
    from mrg_slam_tpu_torch.models.floor_detection import FloorDetection
    from mrg_slam_tpu_torch.ops.cloud import PointCloud

    pts = np.stack([rng.uniform(-25, 25, 900), rng.uniform(-25, 25, 900),
                    rng.normal(-1.5, 0.02, 900)], 1).astype(np.float32)
    cfg = FloorDetectionConfig(enable_floor_detection=True,
                               sensor_height=1.5, floor_pts_thresh=150,
                               enable_normal_filtering=True, tilt_deg=2.0)
    det = FloorDetection(cfg, seed=1)
    cloud = PointCloud.from_array(pts, 1024, device=dev)
    det.detect(cloud, 0.0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            det.detect(cloud, 0.1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    reads = [w for w in seen
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(reads) == 1, [(str(w.message), w.filename, w.lineno)
                             for w in seen]


@pytest.mark.parametrize("backend", ["dense", "cg", "chain"])
def test_family_graph_on_the_card_matches_the_cpu(dev, backend):
    """Every prior and plane family on one ring (family_graph_spec(64)),
    40 LM iterations on the card and the CPU: chi2 within rel 1e-3 (the
    ROADMAP's solver gate) and the planes within 1e-3."""
    from mrg_slam_tpu_torch.config import OptimizerConfig
    from mrg_slam_tpu_torch.graph.builder import GraphSLAM
    from mrg_slam_tpu_torch.pipeline import baseline_runs as bl

    spec = bl.family_graph_spec(64, 0)
    out = []
    for d in ("cpu", dev):
        gs = bl.fill_family_graph(GraphSLAM(
            OptimizerConfig(solver_backend=backend,
                            g2o_solver_num_iterations=40), device=d,
            **bl.family_graph_capacities(spec)), spec)
        gs.optimize()
        out.append(gs)
    np.testing.assert_allclose(out[1].chi2_final, out[0].chi2_final,
                               rtol=1e-3)
    np.testing.assert_allclose(out[1].planes, out[0].planes, atol=1e-3)
    assert out[1].last_marginals is not None
    assert np.isfinite(out[1].last_marginals).all()


def test_optimize_many_on_the_card_matches_the_cpu(dev):
    """Three rings (build_ring_graph(48) in stores of 64) in one batched
    LM on the card and on the CPU: chi2 within rel 1e-4 of each other
    and of each graph's own solve on the card, poses within 5e-3 m and
    marginals within 2e-3 + 5 % (tests/test_torch_coordinator.py's bars
    for poses and marginals). The batched product rounds otherwise than
    one product and the card otherwise than the CPU, and on these rings
    LM's stop falls on rounding noise: chi2 moved by 1.04e-5 relative
    between the card and the CPU, so 1e-5 does not hold across
    devices."""
    from mrg_slam_tpu_torch.graph.builder import optimize_many
    from mrg_slam_tpu_torch.pipeline.baseline_runs import build_ring_graph

    def rings(d):
        return [build_ring_graph(n_nodes=48, capacity_nodes=64,
                                 capacity_edges=128, backend="dense",
                                 seed=s, device=d) for s in (0, 1, 2)]

    cpu, gpu, alone = rings("cpu"), rings(dev), rings(dev)
    optimize_many(cpu)
    optimize_many(gpu)
    for g in alone:
        g.optimize()
    for g, c, a in zip(gpu, cpu, alone):
        for other in (c, a):
            assert abs(g.chi2_final - other.chi2_final) <= \
                1e-4 * other.chi2_final
            np.testing.assert_allclose(g.poses, other.poses, atol=5e-3)
            np.testing.assert_allclose(g.last_marginals,
                                       other.last_marginals, rtol=0.05,
                                       atol=2e-3)


def test_two_robot_exchange_on_the_card_matches_the_cpu(dev):
    """Two MrgSlams exchanging delta graphs through SharedTick, on the
    card and on the CPU from the same clouds, covariances and odometry
    (tests/test_torch_exchange.py's drive, its windows and gates): the
    same exchange decisions, keyframes merged and loops, trajectories and
    the other robot's odom->map within 1e-2 m."""
    import dataclasses

    from mrg_slam_tpu_torch.config import (GraphExchangeConfig,
                                           LoopClosureConfig,
                                           OptimizerConfig, SlamConfig)
    from mrg_slam_tpu_torch.models.backend import MrgSlam
    from mrg_slam_tpu_torch.models.coordinator import SharedTick
    from mrg_slam_tpu_torch.ops.cloud import PointCloud
    from mrg_slam_tpu_torch.utils import se3np

    regc, clouds, covs, odom = _small_world(66)
    names, windows = ("alpha", "bravo"), ((0, 36), (30, 66))
    base = SlamConfig(
        multi_robot_names=names, keyframe_delta_trans=2.0,
        capacity_keyframes=64, capacity_edges=128,
        capacity_keyframe_points=256, registration=regc,
        optimizer=OptimizerConfig(solver_backend="dense",
                                  g2o_solver_num_iterations=64),
        loop=dataclasses.replace(LoopClosureConfig(), capacity_candidates=2,
                                 fitness_score_max_range=2.0,
                                 accum_distance_thresh_other_robot=2.0),
        exchange=GraphExchangeConfig(graph_request_min_accum_dist=1.0,
                                     graph_request_min_time_delay=2.0,
                                     graph_request_max_robot_dist=30.0),
        robot_remove_points_radius=0.0)

    def run(device):
        slams = {}
        for n, (lo, _) in zip(names, windows):
            p = odom[lo]
            slams[n] = MrgSlam(dataclasses.replace(
                base, own_name=n, init_pose=(
                    *p[:3], 2.0 * np.arctan2(p[6], p[3]), 0.0, 0.0)),
                device=device)
        ticker = SharedTick(list(slams.values()))
        decisions = []
        for i in range(36):
            for n, (lo, _) in zip(names, windows):
                rel = se3np.pose_between(odom[lo], odom[lo + i])
                bc = slams[n].process_scan(i * 0.1, rel, PointCloud(
                    *(torch.from_numpy(x).to(device)
                      for x in clouds[lo + i])),
                    source_covs=torch.from_numpy(covs[lo + i]).to(device))
                for o in names:
                    if o != n:
                        slams[o].on_odom_broadcast(bc)
            if (i + 1) % 12 == 0:
                ticker.tick_all(now=i * 0.1)
                for n in names:
                    sp = slams[n].slam_pose_broadcast(i * 0.1)
                    for o in names:
                        if o != n and sp is not None:
                            decisions.append(slams[o].on_slam_pose_broadcast(
                                sp, now=i * 0.1, request_fn=lambda p, r:
                                slams[p].handle_publish_graph(r)))
        ticker.tick_all(now=3.6)
        return slams, decisions

    (gpu, d_gpu), (cpu, d_cpu) = run(dev), run("cpu")
    assert d_gpu == d_cpu and any(d_gpu)

    def loops(slam):
        kfs = slam.db.uuid_keyframe_map
        return sorted((kfs[e.from_uuid].readable_id,
                       kfs[e.to_uuid].readable_id)
                      for e in slam.db.edges if e.type == "loop")

    for n in names:
        g, c = gpu[n], cpu[n]
        assert (len(g.db.keyframes) + len(g.db.new_keyframes)
                == len(c.db.keyframes) + len(c.db.new_keyframes))
        assert loops(g) == loops(c)
        assert g.received_graph_bytes == c.received_graph_bytes
        assert np.abs(g.trajectory()[:, :3]
                      - c.trajectory()[:, :3]).max() < 1e-2
        other = [o for o in names if o != n][0]
        np.testing.assert_allclose(g.others_odom2map[other],
                                   c.others_odom2map[other], atol=1e-2)
