"""Kernel-vs-plain equality self-check on the card (port of
visual_odometry_tpu.utils.selfcheck).

The kernels (ops/kernels, csrc/) are held to their plain versions at full
size by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``. This module runs
the JAX package's eight backend-equality checks — the same names, seeds,
shapes and tolerances — through the kernels on the card, each against a
reference that does not go through them, so a benchmark can refuse to time
a fast-but-wrong kernel. Each check takes ``device`` (the card by default;
``"cpu"`` runs the kernels' plain versions), raises ``AssertionError`` on a
mismatch and, on a card, when a kernel of its list (:data:`LAUNCHES`) did
not launch.

Inputs are built on the host from the checks' seeds, the JAX checks' draws
bit for bit, then moved to the device. Pixels are projected by this
package's ``project_points``, within an ulp or two of the JAX package's
(XLA's CPU product rounds its sums in another order).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import default_device
from ..models import pipeline
from ..ops import matching, picp, picp_se2, se3
from ..ops.camera import project_points
from ..ops.kernels import _lib, matcher_kernel, picp_kernel
from ..parallel import multiseq
from . import synthetic
from .config import VOConfig

# The kernels each check launches on a card, checked after its kernel side ran.
LAUNCHES = {
    "check_picp_solver": ("picp_solve",),
    "check_picp_se2_solver": ("picp_solve_se2",),
    "check_frame_pipeline": ("match_pairs", "join_candidates", "gather_rows", "track_frames"),
    "check_frame_pipeline_planar": ("match_pairs", "join_candidates", "gather_rows",
                                    "track_frames_planar"),
    "check_frame_serving": ("match_pairs", "join_candidates", "gather_rows",
                            "track_frames_batched"),
    "check_matcher": ("best_match",),
    "check_matcher_fast": ("best_match_fast",),
    "check_pair_matcher": ("match_pairs",),
}
SE2_MOUNT_V = (0.1, -0.2, 0.05, 0.02, -0.01, 0.03)
PLANAR_MOUNT_V = (0.05, -0.1, 0.02, 0.01, -0.02, 0.015)
FAST_TOL = 2.0 ** -9   # the fast matcher's selection precision (ops/matching.best_match)


def _require(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _launched(check: str, device: torch.device) -> None:
    """On a card: every kernel of ``check`` launched since the counters were reset."""
    if device.type == "cuda":
        missing = [k for k in LAUNCHES[check] if _lib.launches[k] == 0]
        _require(not missing, f"{check}: kernels that never launched: {missing}")


def _mount(v) -> np.ndarray:
    return se3.v2t_euler(torch.tensor(v, dtype=torch.float32)).numpy()


def picp_inputs(rng: np.random.Generator, x_gt=None):
    """(world (192, 3), x_gt (4, 4), measurements, weights) on the host:
    ``check_picp_solver``'s draws, or the draws of ``world`` alone under a
    given ``x_gt``."""
    world = synthetic.generate_points3d(rng, 192)
    if x_gt is None:
        x_gt = synthetic.generate_pose(rng)
    meas, valid = project_points(synthetic.default_camera(x_gt), torch.from_numpy(world))
    return torch.from_numpy(world), x_gt, meas, valid.to(torch.float32)


def se2_inputs(seed: int):
    """``check_picp_se2_solver``'s inputs: the mount, then ``picp_inputs`` under
    a conjugated SE(2) ground truth."""
    rng = np.random.default_rng(seed)
    mount = _mount(SE2_MOUNT_V)
    x_gt = (np.linalg.inv(mount)
            @ se3.v2t_se2(torch.tensor([0.15, -0.08, 0.1])).numpy() @ mount)
    return (mount,) + picp_inputs(rng, x_gt)


def sequence_inputs(seed: int, count: int = 1):
    """``count`` stacked tracking sequences of 10 frames x 64 slots, fields
    ``seed``, ``seed + 1``, ... (points, appearances, masks) on the host; one
    unstacked for ``count=1``."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(seed + i), 10, 64)
            for i in range(count)]
    if count == 1:
        return tuple(torch.from_numpy(x) for x in seqs[0])
    return tuple(torch.from_numpy(np.stack([s[k] for s in seqs])) for k in range(3))


def matcher_inputs(seed: int):
    """``check_matcher``'s queries (near copies of rows), masks and rows."""
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, (2048, 10)).astype(np.float32)
    q = db[rng.integers(0, 2048, 256)].copy()
    q[::3] += 0.01
    db_mask = np.ones(2048, bool)
    db_mask[::5] = False
    return q, np.ones(256, bool), db, db_mask


def matcher_fast_inputs(seed: int):
    """``check_matcher_fast``'s queries (rows plus noise), masks and rows."""
    rng = np.random.default_rng(seed)
    k, q_n, d = 4096, 256, 10
    db = rng.uniform(-1, 1, (k, d)).astype(np.float32)
    q = db[rng.integers(0, k, q_n)].copy()
    q += rng.normal(0, 0.005, q.shape).astype(np.float32)
    db_mask = np.ones(k, bool)
    db_mask[::7] = False
    return q, np.ones(q_n, bool), db, db_mask


def pair_matcher_inputs(seed: int):
    """``check_pair_matcher``'s 6 frame pairs of 128 slots: a1, m1, a2, m2."""
    rng = np.random.default_rng(seed)
    b, n, d = 6, 128, 10
    a1 = rng.uniform(-1, 1, (b, n, d)).astype(np.float32)
    a2 = a1 + rng.normal(0, 0.02, (b, n, d)).astype(np.float32)
    m1 = rng.uniform(size=(b, n)) > 0.2
    m2 = rng.uniform(size=(b, n)) > 0.2
    return a1, m1, a2, m2


def _first_argmin(d: torch.Tensor, dim: int):
    """(least value, first index of it) along ``dim``."""
    least = d.amin(dim=dim, keepdim=True)
    cols = torch.arange(d.shape[dim], device=d.device).reshape(
        [-1 if i == dim % d.dim() else 1 for i in range(d.dim())])
    first = torch.where(d == least, cols, d.shape[dim]).amin(dim=dim)
    return least.squeeze(dim), first.to(torch.int32)


def _dense_best(q, q_mask, db, db_mask):
    """The top-1 from the whole (Q, K) distance matrix, the JAX check's dense
    matcher: distances summed in descriptor order, masked rows out, the
    first index on ties, masked queries at 3.4e38."""
    d = torch.where(db_mask[None, :], matcher_kernel.pairwise_sq_dists(q, db), matcher_kernel.BIG)
    dist, idx = _first_argmin(d, 1)
    return torch.where(q_mask, dist, matcher_kernel.BIG), idx


def _dense_pairs(a1, m1, a2, m2, radius: float = 0.1) -> matching.Correspondences:
    """``match_appearances_batch`` from the whole (B, N, N) distance matrices:
    the tree over the frame with more valid slots, queries from the other."""
    d = torch.where(m1[:, :, None] & m2[:, None, :], matcher_kernel.pairwise_sq_dists(a1, a2),
                    matcher_kernel.BIG)
    best1_d, best1 = _first_argmin(d, 1)
    best2_d, best2 = _first_argmin(d, 2)
    slots = torch.arange(a1.shape[1], dtype=torch.int32, device=a1.device)[None, :]
    kd_is_1 = m1.sum(dim=1, keepdim=True) >= m2.sum(dim=1, keepdim=True)
    best_d = torch.where(kd_is_1, best1_d, best2_d)
    r2 = torch.tensor(radius, dtype=a1.dtype, device=a1.device) ** 2
    return matching.Correspondences(
        idx1=torch.where(kd_is_1, best1, slots), idx2=torch.where(kd_is_1, slots, best2),
        valid=torch.where(kd_is_1, m2, m1) & (best_d < r2))


def check_picp_solver(device=None, seed: int = 0) -> Dict[str, float]:
    """K6 (``picp_kernel.solve_fused``) against ``ops/picp.solve``'s plain
    round loop (a 6x6 Cholesky where K6 solves a Jacobi-scaled Schur form),
    fixed budget and early exit: poses within 5e-4, equal inlier counts."""
    dev = _device(device)
    world, _, meas, w = picp_inputs(np.random.default_rng(seed))
    world, meas, w = world.to(dev), meas.to(dev), w.to(dev)
    cam = synthetic.default_camera(device=dev)
    diffs = {}
    for name, tol in (("fixed", 0.0), ("early_exit", 1e-12)):
        solved, st = picp.solve(cam, world, meas, w, 50, kernel_threshold=10000.0,
                                tolerance=tol, backend="torch")
        _lib.reset_launches()
        pose, st2 = picp_kernel.solve_fused(cam.camera_matrix, cam.world_in_camera, cam.params(),
                                            world, meas, w, 50, 10000.0, 1.0,
                                            tol if tol > 0 else -1.0)
        _launched("check_picp_solver", dev)
        d = float((pose - solved.world_in_camera).abs().max())
        diffs[f"picp_pose_diff_{name}"] = d
        _require(d < 5e-4, (name, d))
        _require(int(st.num_inliers) == int(st2.num_inliers), name)
    return diffs


def check_picp_se2_solver(device=None, seed: int = 4) -> Dict[str, float]:
    """The planar K6 (``solve_se2_fused``) against ``ops/picp_se2.solve_se2``
    with a non-identity mount: poses within 5e-4, equal inlier counts."""
    dev = _device(device)
    mount, world, _, meas, w = se2_inputs(seed)
    world, meas, w = world.to(dev), meas.to(dev), w.to(dev)
    mount_t = torch.from_numpy(mount).to(dev)
    cam = synthetic.default_camera(device=dev)
    diffs = {}
    for name, tol in (("fixed", 0.0), ("early_exit", 1e-12)):
        solved, st = picp_se2.solve_se2(cam, world, meas, w, 50, kernel_threshold=10000.0,
                                        tolerance=tol, cam_in_robot=mount_t)
        _lib.reset_launches()
        pose, st2 = picp_kernel.solve_se2_fused(cam.camera_matrix, cam.world_in_camera,
                                                cam.params(), mount_t, world, meas, w, 50,
                                                10000.0, 1.0, tol if tol > 0 else -1.0)
        _launched("check_picp_se2_solver", dev)
        d = float((pose - solved.world_in_camera).abs().max())
        diffs[f"picp_se2_pose_diff_{name}"] = d
        _require(d < 5e-4, (name, d))
        _require(int(st.num_inliers) == int(st2.num_inliers), name)
    return diffs


def _pipeline_pair(check: str, config: VOConfig, dev: torch.device, seed: int):
    """``run_sequence`` on the fused path (K1-K5) and in the per-frame step
    form with the plain solve: (fused trajectory, trajectory difference, fused
    map count); the two are different float32 programs, so trajectories are
    held to 2e-3 and the map counts equal."""
    pts, apps, masks = (x.to(dev) for x in sequence_inputs(seed))
    camera = synthetic.deep_camera(device=dev)
    _lib.reset_launches()
    traj_f, map_f, _ = pipeline.run_sequence(camera, config, pts, apps, masks)
    _launched(check, dev)
    traj_x, map_x, _ = pipeline.run_sequence(
        camera, config.replace(scan_backend="step", solver_backend="torch"), pts, apps, masks)
    d_traj = float((traj_x - traj_f).abs().max())
    _require(bool(torch.isfinite(traj_f).all()), f"{check}: non-finite poses")
    _require(d_traj < 2e-3, d_traj)
    _require(int(map_x.count) == int(map_f.count), (int(map_x.count), int(map_f.count)))
    return traj_f, d_traj, int(map_f.count)


def check_frame_pipeline(device=None, seed: int = 1) -> Dict[str, float]:
    """The fused pipeline (K1-K4) against the step form, 64 slots x 10 frames
    under ``deep_camera`` (at z_far=5 the rescaled map leaves the frustum and
    both sides would compare no-ops)."""
    config = VOConfig(n_slots=64, map_capacity=128, gn_iterations=30)
    _, d_traj, n = _pipeline_pair("check_frame_pipeline", config, _device(device), seed)
    return {"frame_traj_diff": d_traj, "map_size": float(n)}


def check_frame_pipeline_planar(device=None, seed: int = 5) -> Dict[str, float]:
    """The planar fused pipeline (K5) against the planar step form with a
    non-identity mount; every fused pose stays in the conjugated SE(2)
    subgroup (no z-translation, a pure z-rotation) within 1e-4."""
    mount = _mount(PLANAR_MOUNT_V)
    config = VOConfig(n_slots=64, map_capacity=128, gn_iterations=30).with_planar_mount(mount)
    traj_f, d_traj, _ = _pipeline_pair("check_frame_pipeline_planar", config, _device(device),
                                       seed)
    conj = np.einsum("ij,fjk,kl->fil", mount, traj_f.cpu().numpy(), np.linalg.inv(mount))
    planar_dev = max(float(np.abs(conj[:, 2, 3]).max()), float(np.abs(conj[:, 2, 0:2]).max()),
                     float(np.abs(conj[:, 0:2, 2]).max()))
    _require(planar_dev < 1e-4, planar_dev)
    return {"frame_planar_traj_diff": d_traj, "planar_subgroup_dev": planar_dev}


def check_frame_serving(device=None, seed: int = 7) -> Dict[str, float]:
    """The batch-aware serving program (K1-K3 over the flattened batch, one
    K8) on 4 sequences x 10 frames x 64 slots against ``backend="torch"`` (a
    loop of the single-sequence program, the JAX ``vmap`` form's counterpart)
    and against each sequence's own ``run_sequence``. Per sequence the two
    run the same arithmetic (tests/test_torch_serving.py): trajectories
    equal bit for bit, map counts equal."""
    dev = _device(device)
    tensors = tuple(x.to(dev) for x in sequence_inputs(seed, count=4))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=30)
    _lib.reset_launches()
    if dev.type == "cuda":
        traj_b, maps_b, _ = multiseq.run_sequences_batched(camera, cfg, *tensors, backend="cuda")
    else:   # the batch-aware program through the plain versions
        traj_b, maps_b, _ = multiseq._run_serving(camera, cfg, *tensors)
    _launched("check_frame_serving", dev)
    traj_v, maps_v, _ = multiseq.run_sequences_batched(camera, cfg, *tensors, backend="torch")
    worst = float((traj_b - traj_v).abs().max())
    _require(worst == 0.0, worst)
    _require(torch.equal(maps_b.count, maps_v.count), (maps_b.count, maps_v.count))
    worst_serial = 0.0
    for i in range(tensors[0].shape[0]):
        traj, _, _ = pipeline.run_sequence(camera, cfg, *(x[i] for x in tensors))
        worst_serial = max(worst_serial, float((traj - traj_b[i]).abs().max()))
    _require(worst_serial == 0.0, worst_serial)
    return {"serving_traj_diff": worst, "serving_vs_serial": worst_serial}


def check_matcher(device=None, seed: int = 2) -> Dict[str, float]:
    """K7 exact against the dense matcher: equal indices and distances (both
    sum in descriptor order from separately rounded products)."""
    dev = _device(device)
    q, q_mask, db, db_mask = (torch.from_numpy(x).to(dev) for x in matcher_inputs(seed))
    _lib.reset_launches()
    d_p, i_p = matching.best_match(q, q_mask, db, db_mask)
    _launched("check_matcher", dev)
    d_x, i_x = _dense_best(q, q_mask, db, db_mask)
    _require(torch.equal(i_x, i_p), "check_matcher: indices differ")
    d_diff = float((d_x - d_p).abs().max())
    _require(d_diff == 0.0, d_diff)
    return {"matcher_dist_diff": d_diff}


def check_matcher_fast(device=None, seed: int = 6) -> Dict[str, float]:
    """K7 fast (a bfloat16 selection re-scored exactly) against an exact host
    top-2: (1) its pick equals the exact matcher's wherever the relative
    margin between the two nearest rows exceeds 2^-9; (2) on closer ties the
    pick's exact distance is within 2^-9 of the least; (3) each returned
    distance is the exact float32 distance of the returned row, summed in
    descriptor order as the re-score sums it."""
    dev = _device(device)
    q, q_mask, db, db_mask = matcher_fast_inputs(seed)
    args = tuple(torch.from_numpy(x).to(dev) for x in (q, q_mask, db, db_mask))
    _lib.reset_launches()
    d_f, i_f = matching.best_match(*args, precision="fast")
    _launched("check_matcher_fast", dev)
    _, i_x = _dense_best(*args)
    i_x, i_f, d_f = i_x.cpu().numpy(), i_f.cpu().numpy(), d_f.cpu().numpy()

    dist = ((q[:, None, :] - db[None, :, :]) ** 2).sum(-1)
    dist[:, ~db_mask] = np.inf
    top2 = np.partition(dist, 1, axis=1)[:, :2]
    margin = (top2[:, 1] - top2[:, 0]) / np.maximum(top2[:, 0], 1e-12)
    agree = i_x == i_f
    n_sep_mismatch = int((~agree & (margin > FAST_TOL)).sum())
    _require(n_sep_mismatch == 0, n_sep_mismatch)
    exact_pick = np.take_along_axis(dist, i_f[:, None].astype(np.int64), axis=1)[:, 0]
    excess = (exact_pick - top2[:, 0]) / np.maximum(top2[:, 0], 1e-12)
    _require(float(excess.max()) <= FAST_TOL, float(excess.max()))
    diff = q - db[i_f]
    exact = diff[:, 0] * diff[:, 0]
    for k in range(1, diff.shape[1]):
        exact = exact + diff[:, k] * diff[:, k]
    d_err = float(np.abs(d_f - exact).max())
    _require(d_err == 0.0, d_err)
    return {"matcher_fast_rescore_err": d_err, "matcher_fast_tie_picks": float((~agree).sum())}


def check_pair_matcher(device=None, seed: int = 3) -> Dict[str, float]:
    """K1 (``match_appearances_batch``) against the dense form: equal
    validity, and equal indices on the valid slots."""
    dev = _device(device)
    args = tuple(torch.from_numpy(x).to(dev) for x in pair_matcher_inputs(seed))
    _lib.reset_launches()
    got = matching.match_appearances_batch(*args)
    _launched("check_pair_matcher", dev)
    ref = _dense_pairs(*args)
    _require(torch.equal(ref.valid, got.valid), "check_pair_matcher: validity differs")
    v = ref.valid
    _require(torch.equal(ref.idx1[v], got.idx1[v]) and torch.equal(ref.idx2[v], got.idx2[v]),
             "check_pair_matcher: indices differ")
    return {"pair_matcher_n_valid": float(v.sum())}


CHECKS = (check_picp_solver, check_picp_se2_solver, check_frame_pipeline,
          check_frame_pipeline_planar, check_frame_serving, check_matcher, check_matcher_fast,
          check_pair_matcher)


def run_all(device=None) -> Dict[str, float]:
    """Run every check on ``device`` (the card by default); raises
    ``AssertionError`` on the first mismatch."""
    dev = _device(device)
    out: Dict[str, float] = {}
    for check in CHECKS:
        out.update(check(dev))
    return out
