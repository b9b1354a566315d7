"""Whether an episode's outputs are correct, against the plain reference.

The window's answers for one episode, drawn from the seed among those it
finished, are held to `plain.py` recomputed in float64 from the same raw
scans:

- `prefilter_lanes_off`: the share of the filtered clouds' lanes (every
  row of every block) where the program's cloud and the reference's
  differ: the mask differs, or the point is more than 1 mm away;
- `odometry_gap_m`: over each chain's first frame (the identity) and a
  sample of its other frames drawn from the seed, on which the
  reference's scan-to-keyframe GICP meets its exit within the budget, the
  largest pose gap (`plain.pose_gap`) between the program's odometry pose
  and the reference's, from the state the program's earlier outputs give
  (keyframe, last pose, last motion). A frame whose reference solve runs
  out of its budget has no settled answer (both sides stop mid-way, where
  rounding sends them) and is counted, not compared. It reads BIG when
  the odometry's keyframe switches are not those its keyframe gate gives
  on its own poses (every frame; a frame within 1e-4 of a threshold is
  left to either side);
- `tick_gap_m`: the largest of two gaps of what the ticks produced, or
  BIG. Over every loop edge, the gap between the program's measurement
  and where the reference's GICP, started from it with the cell's
  registration settings (the full clouds), ends: a right measurement is a
  fixed point. And the largest gap between the program's final keyframe
  estimates and the reference's LM optimum of the graph the reference
  builds itself: the program's keyframes, anchors, odometry edges between
  the keyframes' odometry poses and the program's loop measurements,
  every edge weighted by the reference's own fitness of its clouds at its
  measurement. BIG when the keyframes are not those the keyframe gate
  gives on the program's odometry, or when a judged new keyframe's loop
  (none, or the keyframe it closed to) differs from the reference's
  where the reference's decision was clear. For every tick the reference
  rebuilds each new keyframe's candidates from the program's state
  before the tick (its estimates after the previous tick, the new
  keyframes placed by the odom->map of their chain's latest keyframe, the
  accumulated distances of the keyframe gate, the loops of earlier ticks)
  with the configuration's gates, and decides, by its own GICP from the
  same guesses, the candidate with the best gated fitness under the
  threshold that the consistency check (a cycle through one of the
  candidate's odometry neighbours) accepts. Judged: a sample of the new
  keyframes with candidates drawn from the seed, and every new keyframe
  without candidates that the program closed a loop from. A decision
  within a margin of a threshold (LOOP_MARGIN_*) is left to either side.
  (Neither the graph's gap nor the loop choices alone separate the
  control from sound runs: TF32 moves neither the LM's optimum nor a
  clear choice; so they are compared inside the tick's number, where the
  loop measurements separate the two, and still catch an LM that does
  not run or a tick that closes no loop.)

With `control=True` the answers are the reference's own, computed in
float32 with TF32 matmuls from the same state, in the program's place.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import plain as P

BIG = 1.0e3
LANE_TOL_M = 1.0e-3
ODOMETRY_SAMPLE = 48   # frames a judged episode, over all its chains
LOOP_SAMPLE = 32       # new keyframes with candidates a judged episode
GATE_MARGIN = 1.0e-4   # a keyframe switch this close to a threshold
# a loop decision this close to one of its thresholds (metres of a gate
# or a cycle, a share of a fitness, radians of a cycle) is left to
# either side: rounding, not a fault, can turn it
LOOP_MARGIN_M, LOOP_MARGIN_SHARE, LOOP_MARGIN_RAD = 1.0e-2, 1.0e-2, 1.0e-3
# the port's loop-closure defaults (mrg_slam.yaml:167-180) for keys a
# configuration file leaves out
LOOP_DEFAULTS = {"candidate_max_xy_distance": 15.0,
                 "accum_distance_thresh_same_robot": 15.0,
                 "accum_distance_thresh_other_robot": 5.0,
                 "fitness_score_max_range": math.inf,
                 "fitness_score_thresh": 1.25,
                 "enable_loop_closure_consistency_check": True,
                 "loop_closure_consistency_max_delta_trans": 0.3,
                 "loop_closure_consistency_max_delta_angle": 0.0523599,
                 "capacity_candidates": 8}


@contextlib.contextmanager
def precision(control: bool):
    """float64 for the reference; float32 with TF32 matmuls for its
    control."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    torch.set_float32_matmul_precision("high" if control else "highest")
    try:
        yield torch.float32 if control else torch.float64
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


class Clouds:
    """The reference's filtered clouds and covariances of episode frames,
    made from the raw scans on demand, in one dtype."""

    def __init__(self, episode, pre: dict, dtype):
        self.ep, self.pre, self.dtype = episode, pre, dtype
        rows = episode.rows
        self.where = {}
        for b in range(rows.shape[0]):
            for i in range(rows.shape[1]):
                self.where.setdefault(int(rows[b, i]), (b, i))
        self._f, self._g = {}, {}

    def filtered(self, frame: int) -> P.Filtered:
        if frame not in self._f:
            b, i = self.where[frame]
            self._f[frame] = P.prefilter(self.ep.raw[b, i], self.ep.mask[b, i],
                                         self.pre, self.dtype)
        return self._f[frame]

    def gicp(self, frame: int, radius: float) -> P.Gicp:
        if (frame, radius) not in self._g:
            self._g[(frame, radius)] = P.covariances(self.filtered(frame),
                                                     radius)
        return self._g[(frame, radius)]


def _lanes_off(pts, msk, ref: P.Filtered) -> Tuple[int, int]:
    both = msk & ref.mask
    far = torch.linalg.vector_norm(pts.double() - ref.points.double(),
                                   dim=-1) > LANE_TOL_M
    off = (msk != ref.mask) | (both & far)
    return int(off.sum()), int(msk.numel())


def _rel_state(poses: np.ndarray, flags: np.ndarray, f: int, dev):
    """(keyframe pose, guess, previous relative pose) of frame f from the
    program's outputs of frames < f, as the odometry carries them."""
    k = max(j for j in range(f) if flags[j])
    T = P.mat(poses[:f], device=dev)
    kf = T[k]
    prev_rel = P.inv(kf) @ T[f - 1]
    delta = (P.inv(T[f - 2]) @ T[f - 1] if f >= 2
             else torch.eye(4, dtype=T.dtype, device=dev))
    return k, kf, prev_rel @ delta, prev_rel


def _odometry(robot, frame0, clouds, odo, f, dev, dtype):
    """The reference's odometry pose of the robot's frame f, and whether
    its solve met an exit within the budget."""
    reg = odo["registration"]
    k, kf, guess, prev_rel = _rel_state(robot["poses"],
                                        robot["new_keyframe"], f, dev)
    src = clouds.gicp(frame0 + f, reg["reg_covariance_radius"])
    tgt = clouds.gicp(frame0 + k, reg["reg_covariance_radius"])
    T, _, n_in, settled = P.align(src, tgt, guess.to(dtype), reg)
    T = T.double()
    rel = T if (n_in > 0 and bool(torch.isfinite(T).all())) else prev_rel
    jd = P.inv(prev_rel) @ rel
    jump = (float(torch.linalg.vector_norm(jd[:3, 3]))
            > odo["max_acceptable_translation"]
            or float(P.angle(jd[:3, :3])) > odo["max_acceptable_angle"])
    if odo.get("enable_transform_thresholding") and jump:
        rel = prev_rel
    return kf @ rel, settled


def _anchor(cfg: dict, robot: dict, truth: np.ndarray, dev) -> torch.Tensor:
    """The measurement of a chain's anchor edge: the robot's initial map
    pose, planar, as a float32 [t, q] pose."""
    if cfg["robots"] == 1:
        return torch.eye(4, dtype=torch.float64, device=dev)
    p = truth[robot["window"][0]]
    yaw = 2.0 * math.atan2(float(p[6]), float(p[3]))
    q = np.array([math.cos(yaw / 2), 0, 0, math.sin(yaw / 2)], np.float32)
    return P.mat(np.concatenate([np.float32(p[:3]), q]), device=dev)


def _flags_off(robot: dict, odo: dict, dt: float) -> int:
    """Frames whose keyframe switch differs from the odometry's gate on
    the program's own poses: a switch where the pose relative to the
    last keyframe moved more than `keyframe_delta_translation`, turned
    more than `keyframe_delta_angle` or is older than
    `keyframe_delta_time`; the first frame switches. Frames within
    GATE_MARGIN of a threshold count for neither side."""
    T = P.mat(robot["poses"])
    flags = robot["new_keyframe"]
    off, k = int(not flags[0]), 0
    for f in range(1, len(flags)):
        rel = P.inv(T[k]) @ T[f]
        tr = float(torch.linalg.vector_norm(rel[:3, 3]))
        an = float(P.angle(rel[:3, :3]))
        age = (f - k) * dt
        want = (tr > odo["keyframe_delta_translation"]
                or an > odo["keyframe_delta_angle"]
                or age > odo.get("keyframe_delta_time", math.inf))
        near = (abs(tr - odo["keyframe_delta_translation"]) < GATE_MARGIN
                or abs(an - odo["keyframe_delta_angle"]) < GATE_MARGIN)
        if bool(flags[f]) != want and not near:
            off += 1
        if flags[f]:
            k = f
    return off


def loop_jobs(cfg: dict, episode, out: dict, dev) -> list:
    """Each tick's new keyframes with their candidates, rebuilt from the
    program's state before the tick by the configuration's gates, in the
    order the program's loop detector takes them. A job is a dict: the
    new keyframe, its estimate, its candidates (keyframe, estimate)
    closest first, the keyframes a chosen candidate is checked through,
    the tick, the program's choice (the node it closed to, or None), and
    whether a gate or the cut to the closest candidates lay within
    LOOP_MARGIN_M of deciding otherwise."""
    loop = dict(LOOP_DEFAULTS, **cfg["port"]["slam"]["loop"])
    kfs, chains = [], []
    for r, rb in enumerate(out["robots"]):
        chain, acc = [], 0.0
        odom = np.asarray(rb["keyframe_odom"], np.float64)
        for j, (f, node) in enumerate(zip(rb["keyframe_frames"],
                                          rb["keyframe_nodes"])):
            if j:
                acc += float(np.linalg.norm(odom[j, :3] - odom[j - 1, :3]))
            k = dict(r=r, f=f, frame=rb["window"][0] + f, node=node, j=j,
                     accum=acc, odom=P.mat(odom[j], device=dev))
            chain.append(k)
            kfs.append(k)
        chains.append(chain)
    by_rf = {(k["r"], k["f"]): k for k in kfs}
    counts = [len(s) for s in out["snaps"]]
    made = [(by_rf[a], by_rf[c]) for a, c, _ in out["loops"]]
    choice = {a["node"]: c["node"] for a, c in made}

    def tick_of(node):
        return next(t for t, n in enumerate(counts) if node < n)

    last = {}  # (new robot, candidate robot) -> accum of the last loop
    jobs = []
    max_xy = loop["candidate_max_xy_distance"]
    for t, hi in enumerate(counts):
        lo = counts[t - 1] if t else 0
        snap = (P.mat(out["snaps"][t - 1], device=dev) if t else None)
        o2m = []
        for r, chain in enumerate(chains):
            old = [k for k in chain if k["node"] < lo]
            # odom->map after the last tick; before a chain's first, its
            # initial map pose (the anchor's measurement)
            o2m.append(snap[old[-1]["node"]] @ P.inv(old[-1]["odom"])
                       if old else _anchor(cfg, out["robots"][r],
                                           episode.truth, dev))

        def est(k):
            return (snap[k["node"]] if k["node"] < lo
                    else o2m[k["r"]] @ k["odom"])

        new = sorted((k for k in kfs if lo <= k["node"] < hi),
                     key=lambda k: k["node"])
        old = [k for k in kfs if k["node"] < lo and k["j"] > 0]
        for k in new:
            e_new = est(k)
            cands, near = [], False
            for c in old:
                e_c = est(c)
                d = float(torch.linalg.vector_norm(e_c[:2, 3] - e_new[:2, 3]))
                same = c["r"] == k["r"]
                thresh = (loop["accum_distance_thresh_same_robot"] if same
                          else loop["accum_distance_thresh_other_robot"])
                prev = last.get((k["r"], c["r"]))
                gaps = [(d, max_xy, -1)]
                if same:
                    gaps.append((k["accum"] - c["accum"], thresh, 1))
                if prev is not None:
                    gaps.append((k["accum"] - prev, thresh, 1))
                near |= any(abs(v - t) < LOOP_MARGIN_M for v, t, _ in gaps)
                if all((v - t) * sign >= 0 for v, t, sign in gaps):
                    cands.append((d, c["node"], c, e_c))
            cands.sort(key=lambda x: (x[0], x[1]))
            cap = loop["capacity_candidates"]
            if len(cands) > cap:  # the cut between the kept and the next
                near |= cands[cap][0] - cands[cap - 1][0] < LOOP_MARGIN_M
            cands = [(c, e_c) for _, _, c, e_c in cands[:cap]]
            checks = {}
            for c, _ in cands:
                chain = chains[c["r"]]
                nbs = []
                if c["j"] > 0:
                    nbs.append((chain[c["j"] - 1], "prev"))
                if c["j"] + 1 < len(chain) and chain[c["j"] + 1]["node"] < hi:
                    nbs.append((chain[c["j"] + 1], "next"))
                checks[c["node"]] = [(nb, est(nb), kind) for nb, kind in nbs]
            jobs.append(dict(tick=t, new=k, est=e_new, cands=cands,
                             checks=checks, program=choice.get(k["node"]),
                             near=near))
        for a, c in made:
            if tick_of(a["node"]) == t:
                last[(a["r"], c["r"])] = a["accum"]
    return jobs


def choose(job: dict, clouds: "Clouds", cfg: dict, dtype):
    """The reference's loop of a job -> (the node of the candidate it
    closes to, or None; whether its decision lay within a margin of
    going otherwise: a gate, a fitness near the threshold or near the
    runner-up's, a solve that ran out of its budget with a better
    fitness, a cycle near the consistency check's thresholds)."""
    slam = cfg["port"]["slam"]
    loop = dict(LOOP_DEFAULTS, **slam["loop"])
    reg = slam["registration"]
    radius = reg["reg_covariance_radius"]
    tgt = clouds.gicp(job["new"]["frame"], radius)
    inv_new = P.inv(job["est"])
    fits, unsettled = [], []
    for c, e_c in job["cands"]:
        src = clouds.gicp(c["frame"], radius)
        T, _, n_in, done = P.align(src, tgt, (inv_new @ e_c).to(dtype), reg)
        if n_in == 0 or not bool(torch.isfinite(T).all()):
            continue
        fit = P.fitness(src, tgt, T, loop["fitness_score_max_range"])
        if math.isfinite(fit):
            (fits if done else unsettled).append((fit, c, T.double()))
    fits.sort(key=lambda x: x[0])
    near = job["near"]
    if not fits:
        return None, near
    best_score, best, best_T = fits[0]
    edge = 1.0 + LOOP_MARGIN_SHARE
    near |= any(f < best_score * edge for f, _, _ in unsettled)
    near |= len(fits) > 1 and fits[1][0] < best_score * edge
    thr = loop["fitness_score_thresh"]
    near |= abs(best_score - thr) < thr * LOOP_MARGIN_SHARE
    if best_score > thr:
        return None, near
    if not loop["enable_loop_closure_consistency_check"]:
        return best["node"], near
    dt_max = loop["loop_closure_consistency_max_delta_trans"]
    da_max = loop["loop_closure_consistency_max_delta_angle"]
    for nb, e_nb, kind in job["checks"][best["node"]]:
        src = clouds.gicp(nb["frame"], radius)
        Tn, _, _, _ = P.align(src, tgt, (inv_new @ e_nb).to(dtype), reg)
        Tn = Tn.double()
        if kind == "prev":
            cyc = P.inv(Tn) @ best_T @ (P.inv(best["odom"]) @ nb["odom"])
        else:
            cyc = P.inv(best_T) @ Tn @ (P.inv(nb["odom"]) @ best["odom"])
        dt = float(torch.linalg.vector_norm(cyc[:3, 3]))
        da = float(P.angle(cyc[:3, :3]))
        near |= (abs(dt - dt_max) < LOOP_MARGIN_M
                 or abs(da - da_max) < LOOP_MARGIN_RAD)
        if dt <= dt_max and da <= da_max:
            return best["node"], near
    return None, near


def _graph(cfg, episode, out, clouds, loop_meas, dev, dtype):
    """The reference's pose graph of the program's keyframes, initialized
    at the program's final estimates."""
    slam = cfg["port"]["slam"]
    radius = slam["registration"]["reg_covariance_radius"]
    inf_cfg = slam["inf_matrix"]
    std = np.asarray(slam["custom_inf_matrix_first_node_stddev"])
    poses, fixed, frm, to, meas, info, huber = [], [], [], [], [], [], []
    node = {}
    for r, rb in enumerate(out["robots"]):
        f0 = rb["window"][0]
        anchor = len(poses)
        poses.append(torch.eye(4, dtype=torch.float64, device=dev))
        fixed.append(True)
        for j, f in enumerate(rb["keyframe_frames"]):
            node[(r, f)] = len(poses)
            poses.append(P.mat(rb["keyframe_estimate"][j], device=dev))
            fixed.append(False)
        first = node[(r, rb["keyframe_frames"][0])]
        frm.append(anchor)
        to.append(first)
        meas.append(_anchor(cfg, rb, episode.truth, dev))
        info.append(torch.diag(torch.as_tensor(1.0 / (std * std))))
        huber.append(0.0)
        odom = P.mat(rb["keyframe_odom"], device=dev)
        for j in range(1, len(rb["keyframe_frames"])):
            a, c = rb["keyframe_frames"][j], rb["keyframe_frames"][j - 1]
            m = P.inv(odom[j]) @ odom[j - 1]
            fit = P.fitness(clouds.gicp(f0 + c, radius),
                            clouds.gicp(f0 + a, radius), m.to(dtype))
            frm.append(node[(r, a)])
            to.append(node[(r, c)])
            meas.append(m)
            info.append(P.information(fit, inf_cfg))
            huber.append(0.0)
    width = slam["loop"].get("loop_closure_edge_robust_kernel_size", 1.0)
    for (a, c, _), (m, fit) in zip(out["loops"], loop_meas):
        frm.append(node[a])
        to.append(node[c])
        meas.append(m.double())
        info.append(P.information(fit, inf_cfg))
        huber.append(width)
    return P.Graph(
        torch.stack(poses).to(dtype), torch.tensor(fixed, device=dev),
        torch.tensor(frm, device=dev), torch.tensor(to, device=dev),
        torch.stack(meas).to(dtype), torch.stack(info).to(dev, dtype),
        torch.tensor(huber, dtype=dtype, device=dev))


def judge(cfg: dict, episode, out: dict, device, seed: int,
          control: bool = False) -> Tuple[Dict[str, float], dict]:
    """-> (the compared numbers, details to print). `seed` draws the
    sampled frames and new keyframes."""
    dev = torch.device(device)
    rng = np.random.default_rng([int(seed) % 2 ** 63, 7])
    pre = cfg["port"]["prefilter"]
    odo = cfg["port"]["odometry"]
    slam = cfg["port"]["slam"]
    with precision(False) as f64:
        ref = Clouds(episode, pre, f64)
    with precision(control) as adt:
        ans = Clouds(episode, pre, adt) if control else None
    nums, info = {}, {}

    # prefilter: every row of every block the program ran
    off = total = 0
    for b, (pts, msk) in enumerate(out["clouds"]):
        for i in range(pts.shape[0]):
            frame = int(episode.rows[b, i])
            with precision(False):
                r = ref.filtered(frame)
            if control:
                with precision(True):
                    a = ans.filtered(frame)
                o, t = _lanes_off(a.points, a.mask, r)
            else:
                o, t = _lanes_off(pts[i], msk[i], r)
            off, total = off + o, total + t
    nums["prefilter_lanes_off"] = off / max(total, 1)
    info["prefilter_rows"] = total // max(cfg["filtered_points"], 1)

    # odometry: the keyframe switches of every frame, the poses of a
    # sample of frames
    flags_off = sum(_flags_off(rb, odo, cfg["frame_period_s"])
                    for rb in out["robots"])
    info["odometry_flags_off"] = flags_off
    gap = max(float(P.pose_gap(P.mat(rb["poses"][0], device=dev),
                               torch.eye(4, dtype=torch.float64,
                                         device=dev)))
              for rb in out["robots"])  # each chain starts at the identity
    frames = [(r, f) for r, rb in enumerate(out["robots"])
              for f in range(1, len(rb["poses"]))]
    pick = rng.choice(len(frames), min(ODOMETRY_SAMPLE, len(frames)),
                      replace=False)
    judged = unsettled = 0
    for r, f in sorted(frames[i] for i in pick):
        rb = out["robots"][r]
        f0 = rb["window"][0]
        with precision(False):
            want, settled = _odometry(rb, f0, ref, odo, f, dev,
                                      torch.float64)
        if not settled:
            unsettled += 1
            continue
        if control:
            with precision(True):
                got, _ = _odometry(rb, f0, ans, odo, f, dev, torch.float32)
        else:
            got = P.mat(rb["poses"][f], device=dev)
        g = float(P.pose_gap(got, want))
        if g > gap:
            info["odometry_worst"] = [r, f, int(rb["iterations"][f]), g]
        gap = max(gap, g)
        judged += 1
    nums["odometry_gap_m"] = BIG if flags_off else gap
    info["odometry_frames"] = judged
    info["odometry_unsettled"] = unsettled

    # loop choices: a sample of the new keyframes with candidates, and
    # every loop from a new keyframe without any
    jobs = loop_jobs(cfg, episode, out, dev)
    with_c = [j for j in jobs if j["cands"]]
    pick = rng.choice(len(with_c), min(LOOP_SAMPLE, len(with_c)),
                      replace=False)
    sample = [with_c[i] for i in sorted(pick)]
    stray = [j for j in jobs if not j["cands"] and j["program"] is not None]
    differ = [int(not j["near"]) for j in stray]
    for job in sample:
        with precision(False) as f64:
            want, near = choose(job, ref, cfg, f64)
        if control:
            with precision(True) as f32:
                got, _ = choose(job, ans, cfg, f32)
        else:
            got = job["program"]
        if got != want:
            differ.append(int(not near))
    # [new keyframes, with candidates, judged, choices that differ, of
    # them where the reference's decision was clear]
    info["loop_choices"] = [len(jobs), len(with_c), len(sample) + len(stray),
                            len(differ), sum(differ)]

    # loops: the reference's optimum from each measurement
    reg = slam["registration"]
    radius = reg["reg_covariance_radius"]
    loops = out["loops"]
    gap, ref_meas, ans_meas = 0.0, [], []
    fine = dict(reg, reg_coarse_stride=1)
    for (ra, fa), (rc, fc), m in loops:
        fa0 = out["robots"][ra]["window"][0] + fa
        fc0 = out["robots"][rc]["window"][0] + fc
        M = P.mat(m, device=dev)
        with precision(False):
            src, tgt = ref.gicp(fc0, radius), ref.gicp(fa0, radius)
            T, _, _, _ = P.align(src, tgt, M, fine)
            ref_meas.append((M, P.fitness(src, tgt, M)))
        if control:
            with precision(True):
                s32, t32 = ans.gicp(fc0, radius), ans.gicp(fa0, radius)
                A, _, _, _ = P.align(s32, t32, M.float(), reg)
                ans_meas.append((M, P.fitness(s32, t32, M.float())))
            got = A.double()
        else:
            got = M
        gap = max(gap, float(P.pose_gap(got, T)))
    info["loops"] = len(loops)
    info["loop_gap_m"] = gap

    # keyframes and the graph
    mismatch = 0
    for rb in out["robots"]:
        want = P.keyframe_frames(rb["poses"], slam["keyframe_delta_trans"],
                                 slam["keyframe_delta_angle"])
        mismatch += len(set(want) ^ set(rb["keyframe_frames"]))
    info["keyframes"] = sum(len(rb["keyframe_frames"])
                            for rb in out["robots"])
    info["keyframes_off_gate"] = mismatch
    if mismatch or info["loop_choices"][4]:
        nums["tick_gap_m"] = BIG
        return nums, info
    with precision(False) as f64:
        g = _graph(cfg, episode, out, ref, ref_meas, dev, f64)
        want = P.optimize(g)
    if control:
        with precision(True) as f32:
            ga = _graph(cfg, episode, out, ans, ans_meas, dev, f32)
            got = P.optimize(ga).double()
    else:
        got = g.poses
    free = ~g.fixed
    info["graph_gap_m"] = float(P.pose_gap(got[free], want[free]).max())
    info["graph_nodes"] = int(free.sum())
    nums["tick_gap_m"] = max(info["loop_gap_m"], info["graph_gap_m"])
    return nums, info
