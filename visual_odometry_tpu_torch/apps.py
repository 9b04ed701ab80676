"""Command-line applications of the port (the reference's executables).

    python -m visual_odometry_tpu_torch.apps vo_complete     <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps vo_se2          <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps vo_daknown      <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps relocalize      <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps evaluation      <data_dir> [out_dir]
    python -m visual_odometry_tpu_torch.apps real_init       <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps picp_known_real <data_dir> [out_dir] [--device cuda]
    python -m visual_odometry_tpu_torch.apps compute_corr    <data_dir> [--device cuda]
    python -m visual_odometry_tpu_torch.apps read_data_test  <data_dir>
    python -m visual_odometry_tpu_torch.apps init            [seed] [--device cuda]
    python -m visual_odometry_tpu_torch.apps picp_test       [seed] [--device cuda]
    python -m visual_odometry_tpu_torch.apps whole_test      [seed] [--device cuda]
    python -m visual_odometry_tpu_torch.apps kdtree_test     [seed] [--device cuda]
    python -m visual_odometry_tpu_torch.apps plot            [out_dir]

The commands default to the CUDA card (``--device cpu`` runs the plain
versions on the CPU). real_init is initialization_real_data.cpp,
picp_known_real picp_real_data_allKnown.cpp, compute_corr compute_corr.cpp,
read_data_test read_data_test.cpp; init, picp_test, whole_test and
kdtree_test are the synthetic tests initialization_test.cpp,
picp_solver_test.cpp, essential_picp_test.cpp and eigen_kdtree_test.cpp;
plot renders the figures of an output directory (utils/plots).

Output-file contract of the reference (README.md:56-68 there): vo_complete
and vo_se2 write world.txt, map.txt, map_appearances.txt, trajectory_gt.txt,
trajectory_est_complete.txt and trajectory_est_data.txt; vo_daknown writes
trajectory_est_noWorld.txt, trajectory_est_data.txt and time_known.txt;
relocalize writes relocalization.txt; evaluation writes out_performance.txt,
map_corrected.txt, arrows.txt and world_pruned.txt; real_init writes
world.txt and triangulated.txt; picp_known_real writes trajectory_est.txt;
plot writes trajectories.png, points.png and errors.png.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from . import default_device
from .models import pipeline, refinement
from .models.landmark_map import compact
from .models.refinement import absolute_from_relative
from .ops import epipolar, matching, pca_tree, picp, se3, triangulation
from .ops.camera import Camera, project_points
from .parallel import posegraph
from .utils import evaluation as eval_mod
from .utils import io
from .utils import synthetic
from .utils.config import DEFAULT_CONFIG, VOConfig
from .utils.profiling import StageTimer


def _device(device) -> torch.device:
    """``device``, or the CUDA card when None (raises without one)."""
    return torch.device(device) if device is not None else default_device()


def _load(data_dir: str, config: VOConfig, device):
    """(camera parameters, camera on ``device``, the padded sequence as numpy)."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device=device)
    return params, camera, io.load_sequence(data_dir, config.n_slots)


def _stage(seq, device):
    """The sequence's tensors on ``device``, there before any clock starts
    (loading is set-up): points, appearances, mask, ids."""
    out = tuple(torch.from_numpy(x).to(device)
                for x in (seq.points, seq.appearances, seq.mask, seq.ids))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _check_bootstrap(config: VOConfig, pts, apps, mask, ids, use_known_da: bool = False):
    """Guard the first frame pair (pipeline.check_bootstrap): raises
    BootstrapError on < 8 correspondences and warns on a degenerate pair."""
    return pipeline.check_bootstrap(
        config, pipeline.FrameData(pts[0], apps[0], mask[0], ids[0]),
        pipeline.FrameData(pts[1], apps[1], mask[1], ids[1]), use_known_da)


def run_vo_complete(
    data_dir: str,
    out_dir: str = ".",
    config: VOConfig = DEFAULT_CONFIG,
    verbose: bool = True,
    device=None,
):
    """Full VO with appearance-based DA (vo_complete.cpp:68-186); SE(3), or
    planar when ``config.planar``. With ``config.num_chunks > 1`` the sequence
    is tracked as that many chunks, overlapping by ``config.chunk_overlap``
    frames at least, and stitched (``parallel/posegraph.run_sequence_chunked``). With
    ``config.refine_iterations > 0`` the tracked trajectory and map are
    bundle-adjusted before they are written (``models/refinement``:
    ``refine_backend`` ``dense`` or ``sparse``), outside the timed tracking.
    ``device`` defaults to the CUDA card.

    Returns (trajectory (F, 4, 4) numpy, map, per-frame outputs (the chunked
    route: ``posegraph.PoseGraphDiagnostics``), seconds).
    """
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config, device)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)
    io.save_gt_trajectory(
        os.path.join(data_dir, "trajectory.dat"), os.path.join(out_dir, "trajectory_gt.txt")
    )

    pts, apps, mask, ids = _stage(seq, device)

    t0 = time.perf_counter()
    if config.num_chunks > 1:
        trajectory, map_state, outs = posegraph.run_sequence_chunked(
            camera, config, pts, apps, mask, num_chunks=config.num_chunks,
            overlap=config.chunk_overlap)
    else:
        _check_bootstrap(config, pts, apps, mask, ids)
        trajectory, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, mask)
    trajectory = trajectory.cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0

    if config.refine_iterations > 0:
        refine = (refinement.refine_trajectory_sparse if config.refine_backend == "sparse"
                  else refinement.refine_trajectory)
        trajectory, map_pts, map_apps, _ = refine(
            params.camera_matrix, trajectory, map_state, seq.points, seq.appearances, seq.mask,
            num_iterations=config.refine_iterations, damping=config.refine_damping,
            kernel_threshold=config.kernel_threshold, device=device)
    else:
        map_pts, map_apps = compact(map_state)
    h = params.cam_in_robot
    map_robot = map_pts @ h[:3, :3].T + h[:3, 3]       # map = H * map (vo_complete.cpp:181)
    io.write_vectors(os.path.join(out_dir, "map.txt"), map_robot)
    io.write_vectors(os.path.join(out_dir, "map_appearances.txt"), map_apps)
    io.save_trajectory(os.path.join(out_dir, "trajectory_est_complete.txt"), trajectory, h)
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"), trajectory, h, save_rotation=True
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames in {elapsed:.3f}s ({f / elapsed:.1f} frames/s) on {device}")
        print(f"map landmarks: {len(map_pts)}")
    return trajectory, map_state, outs, elapsed


def run_vo_se2(data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None,
               verbose: bool = True, device=None):
    """Full VO with the estimation constrained to SE(2) in the robot plane
    (the reference's ``est_SE2`` branch): :func:`run_vo_complete` with the
    per-frame solve on the 3-DoF planar solver (kernel K5 on the card)
    conjugated by the camera mount of ``camera.dat``, and the two-view init
    planarized. Same output files, so ``evaluation`` works unchanged."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    config = (config or DEFAULT_CONFIG).with_planar_mount(params.cam_in_robot)
    return run_vo_complete(data_dir, out_dir, config, verbose, device)


def run_vo_da_known(data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None,
                    verbose: bool = True, device=None):
    """VO with ground-truth data association (vo_daKnown.cpp): the landmark
    ids of the measurement files instead of the appearance matcher, and the
    reference's 1000 GN iterations per frame (vo_daKnown.cpp:149-150). Writes
    ``trajectory_est_noWorld.txt``, ``trajectory_est_data.txt`` and the
    per-frame association times ``time_known.txt``.

    Returns (trajectory (F, 4, 4) numpy, per-frame outputs, seconds)."""
    if config is None:
        config = DEFAULT_CONFIG.replace(gn_iterations=1000)
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config, device)
    pts, apps, mask, ids = _stage(seq, device)

    _check_bootstrap(config, pts, apps, mask, ids, use_known_da=True)
    t0 = time.perf_counter()
    trajectory, _, outs = pipeline.run_sequence_known_da(camera, config, pts, apps, mask, ids)
    trajectory = trajectory.cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0

    # Per-frame DA timing (vo_daKnown.cpp:127-129, 163-164). Tracking matches
    # all pairs in one batch, so the times come from a per-frame run of the
    # id matcher.
    timer = StageTimer()
    pipeline.match_by_ids(ids[0], mask[0], ids[1], mask[1])   # warm-up
    for k in range(1, len(trajectory)):
        with timer.stage("da", sync_on=mask):
            pipeline.match_by_ids(ids[k - 1], mask[k - 1], ids[k], mask[k])
    timer.dump(os.path.join(out_dir, "time_known.txt"), "da")

    h = params.cam_in_robot
    io.save_trajectory(os.path.join(out_dir, "trajectory_est_noWorld.txt"), trajectory, h)
    io.save_trajectory(
        os.path.join(out_dir, "trajectory_est_data.txt"), trajectory, h, save_rotation=True
    )
    if verbose:
        f = len(trajectory)
        print(f"tracked {f} frames (known DA) in {elapsed:.3f}s ({f / elapsed:.1f} frames/s) "
              f"on {device}")
    return trajectory, outs, elapsed


def run_relocalize(data_dir: str, out_dir: str = ".", config: VOConfig = DEFAULT_CONFIG,
                   every: int = 10, verbose: bool = True, device=None):
    """Map-scale re-localization sweep: track the sequence (building the
    landmark map), then re-localize every ``every``-th frame against the whole
    map (pipeline.relocalize_frame: kernels K7 and K6 on the card) with the
    previous absolute pose as prior. Writes ``relocalization.txt``: frame,
    position error against the tracked absolute pose, orientation error,
    matches, inliers. Returns those rows."""
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    _, camera, seq = _load(data_dir, config, device)
    pts, apps, mask, ids = _stage(seq, device)
    _check_bootstrap(config, pts, apps, mask, ids)
    trajectory, map_state, _ = pipeline.run_sequence(camera, config, pts, apps, mask)
    absolute = absolute_from_relative(trajectory.cpu().numpy())

    rows = []
    no_ids = torch.full_like(ids[0], -1)
    for f in range(every, len(absolute), every):
        frame = pipeline.FrameData(pts[f], apps[f], mask[f], no_ids)
        pose, stats, n_matches = pipeline.relocalize_frame(
            camera, config, map_state, frame, torch.from_numpy(absolute[f - 1]).to(device))
        pose = pose.cpu().numpy()
        err_t = float(np.linalg.norm(pose[:3, 3] - absolute[f][:3, 3]))
        err_r = float(np.trace(np.eye(3) - pose[:3, :3].T @ absolute[f][:3, :3]))
        rows.append((f, err_t, err_r, int(n_matches), int(stats.num_inliers)))
    with open(os.path.join(out_dir, "relocalization.txt"), "w") as fh:
        for r in rows:
            fh.write(f"{r[0]} {r[1]:.6f} {r[2]:.6e} {r[3]} {r[4]}\n")
    if verbose:
        errs = np.array([r[1] for r in rows])
        print(f"relocalized {len(rows)} frames on {device}: median pos err "
              f"{np.median(errs):.4f}, max {errs.max():.4f}")
    return rows


def run_evaluation(data_dir: str, out_dir: str = ".", verbose: bool = True):
    """Offline metrics (evaluate.cpp), reading the files run_vo_complete wrote."""
    _, gt_xyt = io.load_trajectory(os.path.join(data_dir, "trajectory.dat"))
    gt_poses = io.gt_poses_se3(gt_xyt)
    est_poses = io.load_est_trajectory(os.path.join(out_dir, "trajectory_est_data.txt"))
    map_est = np.loadtxt(os.path.join(out_dir, "map.txt"), ndmin=2, dtype=np.float32)
    map_apps = np.loadtxt(os.path.join(out_dir, "map_appearances.txt"), ndmin=2, dtype=np.float32)
    _, world_points, world_apps = io.load_world(os.path.join(data_dir, "world.dat"))

    res = eval_mod.evaluate(est_poses, gt_poses, map_est, map_apps, world_points, world_apps)

    perf = np.stack([res.orientation_errors, res.ratios], axis=1)
    np.savetxt(os.path.join(out_dir, "out_performance.txt"), perf, fmt="%g")
    io.write_vectors(os.path.join(out_dir, "map_corrected.txt"), map_est * res.scale)
    mi, wi = eval_mod.match_map_to_world(map_est, map_apps, world_points, world_apps)
    arrows = np.concatenate([map_est[mi] * res.scale, world_points[wi]], axis=1)
    io.write_vectors(os.path.join(out_dir, "arrows.txt"), arrows)
    io.write_vectors(os.path.join(out_dir, "world_pruned.txt"), world_points[wi])

    if verbose:
        finite = np.isfinite(res.orientation_errors)
        print(f"ratio used for map correction: {res.scale}")
        print(f"orientation error mean: {np.abs(res.orientation_errors[finite]).mean()}")
        print(f"RMSE position: {res.rmse_position}")
        print(f"RMSE map: {res.rmse_map}  ({res.n_map_matched} landmarks matched)")
    return res


def run_real_init(data_dir: str, out_dir: str = ".", verbose: bool = True, device=None):
    """Two-view initialization on the first two frames
    (initialization_real_data.cpp): ground-truth correspondences by landmark
    id, the 8-point estimate, the triangulation; writes world.txt and
    triangulated.txt, both in the robot frame. Returns (the pose of camera 0
    in camera 1 (4, 4), the triangulated points (N, 3)) as numpy."""
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, DEFAULT_CONFIG, device)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    io.write_vectors(os.path.join(out_dir, "world.txt"), world_points)
    pts, apps, mask, ids = _stage(seq, device)
    _check_bootstrap(DEFAULT_CONFIG, pts, apps, mask, ids, use_known_da=True)
    corr = pipeline.match_by_ids(ids[0], mask[0], ids[1], mask[1])
    x = epipolar.estimate_transform(camera.camera_matrix, corr.idx1, corr.idx2, corr.valid,
                                    pts[0], pts[1], mask[0], mask[1])
    tri, ok = triangulation.triangulate_correspondences(
        camera.camera_matrix, x, corr.idx1, corr.idx2, corr.valid, pts[0], pts[1])
    h = params.cam_in_robot
    tri = tri[ok].cpu().numpy() @ h[:3, :3].T + h[:3, 3]
    io.write_vectors(os.path.join(out_dir, "triangulated.txt"), tri)
    x = x.cpu().numpy()
    if verbose:
        print("R estimated:\n", x[:3, :3])
        print("t estimated:", x[:3, 3])
        print(f"triangulated {len(tri)} points -> triangulated.txt (on {device})")
    return x, tri


def run_picp_known_real(data_dir: str, out_dir: str = ".", config: Optional[VOConfig] = None,
                        verbose: bool = True, device=None):
    """PICP alone with the world points and the association known
    (picp_real_data_allKnown.cpp): each frame, the world is moved into the
    previous camera (picp_real_data_allKnown.cpp:76-77), gathered by landmark
    id and solved against the frame's measurements from the identity, up to
    ``config.gn_iterations`` rounds (default 1000) with ``config.gn_tolerance``
    (kernel K6 once a frame on the card). Writes trajectory_est.txt; returns
    the poses (F, 4, 4) as numpy."""
    if config is None:
        config = DEFAULT_CONFIG.replace(gn_iterations=1000)
    device = _device(device)
    os.makedirs(out_dir, exist_ok=True)
    params, camera, seq = _load(data_dir, config, device)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    pts, _, mask, ids = _stage(seq, device)
    world = torch.from_numpy(world_points).to(device)
    x_curr = torch.from_numpy(np.linalg.inv(params.cam_in_robot).astype(np.float32)).to(device)
    cam0 = picp.with_pose(camera, se3.identity_pose(device=device))

    t0 = time.perf_counter()
    poses = []
    for f in range(pts.shape[0]):
        world = se3.transform_points(x_curr, world)       # into the previous camera
        solved, _ = picp.solve(
            cam0, world[torch.where(mask[f], ids[f], 0).long()], pts[f],
            mask[f].to(world.dtype), config.gn_iterations,
            kernel_threshold=config.kernel_threshold, damping=config.damping,
            tolerance=config.gn_tolerance)
        x_curr = solved.world_in_camera
        poses.append(x_curr)
    poses = torch.stack(poses).cpu().numpy()   # waits for the device
    elapsed = time.perf_counter() - t0
    io.save_trajectory(os.path.join(out_dir, "trajectory_est.txt"), poses, params.cam_in_robot)
    if verbose:
        print(f"picp_known_real: {len(poses)} frames in {elapsed:.3f}s on {device}")
    return poses


def run_compute_corr(data_dir: str, verbose: bool = True, device=None):
    """Appearance association against the landmark-id ground truth on the
    first two frames (compute_corr.cpp:114-118; kernel K1 on the card).
    Returns (appearance pairs, id pairs), sets of (frame-0 slot, frame-1 slot)."""
    device = _device(device)
    _, _, seq = _load(data_dir, DEFAULT_CONFIG, device)
    _, apps, mask, ids = _stage(seq, device)
    a = matching.match_appearances(apps[0], mask[0], apps[1], mask[1])
    g = pipeline.match_by_ids(ids[0], mask[0], ids[1], mask[1])

    def pairs(c):
        i, j, v = (x.cpu().numpy() for x in c)
        return {(int(p), int(q)) for p, q in zip(i[v], j[v])}

    a_set, g_set = pairs(a), pairs(g)
    if verbose:
        agree = len(a_set & g_set)
        print(f"appearance matches: {len(a_set)}, gt matches: {len(g_set)}, "
              f"agreeing: {agree} ({100.0 * agree / max(len(g_set), 1):.1f}%)")
    return a_set, g_set


def run_read_data_test(data_dir: str):
    """The dataset readers' summary (read_data_test.cpp). Returns (camera
    parameters, the padded sequence)."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    seq = io.load_sequence(data_dir, DEFAULT_CONFIG.n_slots)
    _, world_points, _ = io.load_world(os.path.join(data_dir, "world.dat"))
    print(f"frames: {len(seq.counts)}, meas per frame min/max: "
          f"{seq.counts.min()}/{seq.counts.max()}")
    print(f"world landmarks: {len(world_points)}")
    print("camera matrix:\n", params.camera_matrix)
    print("cam_in_robot:\n", params.cam_in_robot)
    print(f"z_near={params.z_near} z_far={params.z_far} "
          f"width={params.width} height={params.height}")
    return params, seq


def _print_comparison(x_est: np.ndarray, x_gt: np.ndarray, title: str = ""):
    """Estimated against true pose, as initialization_test.cpp:27-40 prints them."""
    if title:
        print(title)
    print("R estimated:\n", x_est[:3, :3])
    print("R gt:\n", x_gt[:3, :3])
    print("t ratio:", ", ".join(f"{r:g}" for r in x_est[:3, 3] / x_gt[:3, 3]))


def run_init_synthetic(seed: int = 0, num_points: int = 1000, verbose: bool = True,
                       device=None):
    """The 8-point initialization on a synthetic two-view scene
    (initialization_test.cpp:41-89): ``num_points`` random points, two random
    cameras, identity correspondences. A constant per-axis t ratio is the
    right direction (the monocular scale is free). Returns (estimate, truth)
    (4, 4) numpy."""
    device = _device(device)
    _, _, _, p1, p2, corr_valid, x_gt = synthetic.two_view_scene(
        np.random.default_rng(seed), num_points)
    cam = synthetic.default_camera(device=device)
    idx = torch.arange(num_points, dtype=torch.int32, device=device)
    valid = torch.from_numpy(corr_valid).to(device)
    x = epipolar.estimate_transform(
        cam.camera_matrix, idx, idx, valid, torch.from_numpy(p1).to(device),
        torch.from_numpy(p2).to(device), valid, valid).cpu().numpy()
    if verbose:
        _print_comparison(x, x_gt, f"epipolar init (on {device})")
    return x, x_gt


def run_picp_synthetic(seed: int = 0, num_points: int = 1000, iterations: int = 1000,
                       verbose: bool = True, device=None):
    """PICP alone on a synthetic scene (picp_solver_test.cpp:42-79): known world
    points, measurements projected under a random true pose, the solve from
    the identity with kernel threshold 10000 for exactly ``iterations`` rounds
    (kernel K6 on the card). Returns (estimate, truth) (4, 4) numpy."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    x_gt = synthetic.generate_pose(rng)
    world = torch.from_numpy(synthetic.generate_points3d(rng, num_points)).to(device)
    _, v_ref = project_points(synthetic.default_camera(device=device), world)
    p_cur, v_cur = project_points(synthetic.default_camera(x_gt, device=device), world)
    weights = (v_ref & v_cur).to(torch.float32)
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32), device=device)
    solved, stats = picp.solve(cam0, world, p_cur, weights, iterations, kernel_threshold=10000.0)
    x_est = solved.world_in_camera.cpu().numpy()
    if verbose:
        _print_comparison(x_est, x_gt, f"PICP solver (on {device})")
        print(f"inliers: {int(stats.num_inliers)}  chi inliers: {float(stats.chi_inliers):g}")
    return x_est, x_gt


def run_whole_synthetic(seed: int = 0, num_points: int = 1000, verbose: bool = True,
                        device=None):
    """The composed synthetic check (essential_picp_test.cpp:45-106): three
    random views; the 8-point init between views 1 and 2, triangulation, then
    PICP of the triangulated points against view 3 for 1000 rounds (kernel
    K6 on the card). The truth of that solve is the scale-free ``w3 w2^-1``.
    Returns (estimate, truth) (4, 4) numpy."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    world = torch.from_numpy(synthetic.generate_points3d(rng, num_points)).to(device)
    w1, w2, w3 = (synthetic.generate_pose(rng) for _ in range(3))
    cam = synthetic.default_camera(device=device)
    (p1, v1), (p2, v2), (p3, v3) = (
        project_points(synthetic.default_camera(w, device=device), world) for w in (w1, w2, w3))
    idx = torch.arange(num_points, dtype=torch.int32, device=device)
    corr12 = v1 & v2
    x12 = epipolar.estimate_transform(cam.camera_matrix, idx, idx, corr12, p1, p2, v1, v2)
    if verbose:
        _print_comparison(x12.cpu().numpy(), (w2 @ np.linalg.inv(w1)).astype(np.float32),
                          f"init (view 1 in view 2, on {device})")
    tri, ok = triangulation.triangulate_correspondences(cam.camera_matrix, x12, idx, idx,
                                                        corr12, p1, p2)
    weights = (ok & v3).to(torch.float32)
    cam0 = synthetic.default_camera(np.eye(4, dtype=np.float32), device=device)
    solved, stats = picp.solve(cam0, se3.transform_points(x12, tri), p3, weights, 1000,
                               kernel_threshold=10000.0)
    x23_est = solved.world_in_camera.cpu().numpy()
    x23_gt = (w3 @ np.linalg.inv(w2)).astype(np.float32)
    if verbose:
        print(f"triangulated in front: {int(ok.sum())}")
        _print_comparison(x23_est, x23_gt, "PICP (view 2 in view 3)")
        print(f"inliers: {int(stats.num_inliers)}")
    return x23_est, x23_gt


def run_kdtree_test(seed: int = 0, num_points: int = 500, verbose: bool = True, device=None):
    """The tree's one-sided best match against the exact dense search, per
    query (eigen_kdtree_test.cpp:42-67): ``num_points`` random points, the
    queries those points plus N(0, 0.1) noise, radius 0.5, depth
    log2(N / 10). Prints the FAST Correct tally; returns the per-query
    agreement (N,) bool numpy."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10.0, 10.0, (num_points, 3)).astype(np.float32)
    queries = (pts + rng.normal(0, 0.1, pts.shape)).astype(np.float32)
    mask = torch.ones(num_points, dtype=torch.bool, device=device)
    db, q = torch.from_numpy(pts).to(device), torch.from_numpy(queries).to(device)

    levels = max(1, int(np.log2(max(num_points / 10.0, 2.0))))
    tree = pca_tree.build_tree(db, mask, levels=levels)
    idx_fast, found_fast = pca_tree.best_match_fast(tree, db, q, mask, radius=0.5)
    d = matching.pairwise_sq_dists(q, db).cpu().numpy()
    exact_idx, exact_found = d.argmin(1), d.min(1) < 0.5 ** 2
    fast_idx, fast_found = idx_fast.cpu().numpy(), found_fast.cpu().numpy()
    correct = (fast_found == exact_found) & (~exact_found | (fast_idx == exact_idx))
    if verbose:
        print(f"FAST Correct: {int(correct.sum())}/{num_points} "
              f"(exact matches: {int(exact_found.sum())}, tree depth {levels}, on {device})")
        for i in np.flatnonzero(~correct)[:10]:
            print(f"FAST Not Correct: query {i}: fast="
                  f"{fast_idx[i] if fast_found[i] else 'NONE'} "
                  f"full={exact_idx[i] if exact_found[i] else 'NONE'}")
    return correct


# command -> (application, its positional arguments as "data" (<data_dir> [out_dir]),
# "data_only" (<data_dir>), "seed" ([seed]) or "out" ([out_dir]), takes --device)
_COMMANDS = {
    "vo_complete": (run_vo_complete, "data", True),
    "vo_se2": (run_vo_se2, "data", True),
    "vo_daknown": (run_vo_da_known, "data", True),
    "relocalize": (run_relocalize, "data", True),
    "evaluation": (run_evaluation, "data", False),
    "real_init": (run_real_init, "data", True),
    "picp_known_real": (run_picp_known_real, "data", True),
    "compute_corr": (run_compute_corr, "data_only", True),
    "read_data_test": (run_read_data_test, "data_only", False),
    "init": (run_init_synthetic, "seed", True),
    "picp_test": (run_picp_synthetic, "seed", True),
    "whole_test": (run_whole_synthetic, "seed", True),
    "kdtree_test": (run_kdtree_test, "seed", True),
    "plot": (None, "out", False),
}
_ARITY = {"data": (1, 2), "data_only": (1, 1), "seed": (0, 1), "out": (0, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m visual_odometry_tpu_torch.apps",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("command", choices=tuple(_COMMANDS))
    p.add_argument("args", nargs="*", help="<data_dir> [out_dir], [seed] or [out_dir]")
    p.add_argument("--device", default=None,
                   help="torch device of the computing commands (default: cuda, which must exist)")
    a = p.parse_args(argv)
    fn, kind, on_device = _COMMANDS[a.command]
    lo, hi = _ARITY[kind]
    if not lo <= len(a.args) <= hi:
        p.error(f"{a.command} takes {lo} to {hi} positional arguments, got {len(a.args)}")
    kw = {"device": a.device} if on_device else {}
    if kind == "seed":
        fn(seed=int(a.args[0]) if a.args else 0, **kw)
    elif kind == "out":
        from .utils import plots

        for path in plots.plot_all(a.args[0] if a.args else "."):
            print(f"wrote {path}")
    else:
        fn(*a.args, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
