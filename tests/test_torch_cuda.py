"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1-K3 and K7 are exact (the distances use the same explicitly
rounded operations in the same order, K2/K3 are selection). K4, K5 and K6 add
their lane sums in the plain versions' order, both sides use a correctly
rounded sqrt and the card's sin/cos, so their poses are held to 1e-5 (bitwise
expected).
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops import se3
from visual_odometry_tpu_torch.ops.camera import project_points
from visual_odometry_tpu_torch.ops.kernels import (
    frame_kernel, gather_kernel, matcher_kernel, picp_kernel,
)
from visual_odometry_tpu_torch.utils import synthetic
from visual_odometry_tpu_torch.utils.config import VOConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("b,n,d", [(1, 40, 10), (5, 128, 10), (3, 1024, 10), (2, 96, 7)])
def test_match_pairs_kernel_equals_plain(dev, b, n, d):
    rng = np.random.default_rng(n + d)
    a1 = rng.uniform(-1, 1, (b, n, d)).astype(np.float32)
    a2 = a1[:, rng.permutation(n)] + rng.normal(0, 0.02, (b, n, d)).astype(np.float32)
    m1 = rng.uniform(size=(b, n)) > 0.2
    m2 = rng.uniform(size=(b, n)) > 0.2
    m1[0, : n // 2] = False
    a1[~m1] = np.nan                 # garbage in masked slots never matches
    a2[:, 5] = a2[:, 3]              # ties go to the first index
    m2[:, 5] = m2[:, 3]
    args = [torch.from_numpy(x).to(dev) for x in (a1, m1, a2, m2)]
    _lib.reset_launches()
    got = matcher_kernel.match_pairs(*args)
    assert _lib.launches["match_pairs"] == 1
    ref = matcher_kernel.match_pairs_plain(*args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("f,s,depth", [(4, 40, 1), (6, 256, 2), (3, 1024, 3)])
def test_join_candidates_kernel_equals_plain(dev, f, s, depth):
    rng = np.random.default_rng(s)
    src = torch.from_numpy(rng.integers(0, s // 3, (f, s)).astype(np.int32)).to(dev)
    dst = torch.from_numpy(rng.integers(0, s // 2, (f, s)).astype(np.int32)).to(dev)
    sv = torch.from_numpy(rng.uniform(size=(f, s)) > 0.3).to(dev)
    dv = torch.from_numpy(rng.uniform(size=(f, s)) > 0.3).to(dev)
    got = frame_kernel.join_candidates(src, sv, dst, dv, depth)
    ref = frame_kernel.join_candidates_plain(src, sv, dst, dv, depth)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert bool(got.overflow.any())


def test_gather_rows_kernel_equals_plain(dev):
    rng = np.random.default_rng(0)
    for f, r, s in ((3, 4, 40), (5, 10, 1024)):
        src = torch.from_numpy(rng.normal(size=(f, r, s)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, s, (f, r, s)).astype(np.int32)).to(dev)
        assert torch.equal(gather_kernel.gather_rows(src, idx),
                           gather_kernel.gather_rows_plain(src, idx))


def _k4_args(dev, frames, slots, seed_motion=6.0):
    pts, apps, masks = synthetic.generate_tracking_sequence(
        np.random.default_rng(0), frames, slots, seed_motion=seed_motion)
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in (pts, apps, masks))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=slots, matcher_backend="torch", scan_backend="torch")
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    corr01 = pipeline._match(cfg, False, f0, f1)
    state, _ = pipeline.initialize(camera, cfg, f0, f1, corr=corr01)
    rest = pipeline.FrameData(pts[2:], apps[2:], masks[2:], ids[2:])
    prev = pipeline.FrameData(pts[1:-1], apps[1:-1], masks[1:-1], ids[1:-1])
    corr = pipeline._batched_match(cfg, False, rest, prev)
    cand = frame_kernel.join_candidates(
        torch.cat([corr01.idx2[None], corr.idx2[:-1]]).contiguous(),
        torch.cat([corr01.valid[None], corr.valid[:-1]]).contiguous(),
        corr.idx1.contiguous(), corr.valid.contiguous(), 2)
    s1 = torch.where(corr.valid, corr.idx1, 0).long()
    s2 = torch.where(corr.valid, corr.idx2, 0).long()
    prev_al = torch.stack([torch.gather(prev.points[..., c], 1, s1) for c in (0, 1)], -1)
    cur_al = torch.stack([torch.gather(rest.points[..., c], 1, s2) for c in (0, 1)], -1)
    return (camera.camera_matrix, camera.params(), state.x_curr, state.tri_points.contiguous(),
            state.tri_valid.contiguous(), cand, prev_al.contiguous(), cur_al.contiguous(),
            corr.valid.contiguous())


@pytest.mark.parametrize("slots,opts", [
    (64, dict(iterations=100, tol=1e-12)),
    (200, dict(iterations=100, tol=1e-12)),
    (64, dict(iterations=12, tol=-1.0, warm_start=True, min_iterations=3)),
    (64, dict(iterations=20, tol=1e-12, kt=2e-3, keep_outliers=True)),
])
def test_track_frames_kernel_equals_plain(dev, slots, opts):
    args = _k4_args(dev, 14, slots)
    kw = dict(keep_outliers=opts.get("keep_outliers", False),
              warm_start=opts.get("warm_start", False),
              min_iterations=opts.get("min_iterations", 1))
    call = (opts["iterations"], opts.get("kt", 1e4), 1.0, opts["tol"])
    _lib.reset_launches()
    got = frame_kernel.track_frames(*args, *call, **kw)
    assert _lib.launches["track_frames"] == 1
    ref = frame_kernel.track_frames(*args, *call, backend="torch", **kw)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K4 kernel vs plain, S={slots} {opts}: max |dpose| = {err}")
    assert err <= 1e-5
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[3][:, 2:], ref[3][:, 2:])


def test_kernels_reject_bad_inputs(dev):
    x = torch.zeros((2, 64, 10), device=dev)
    m = torch.ones((2, 64), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        matcher_kernel.match_pairs_cuda(x.double(), m, x, m)
    with pytest.raises(ValueError, match="contiguous"):
        matcher_kernel.match_pairs_cuda(x.transpose(0, 1).contiguous().transpose(0, 1), m, x, m)
    with pytest.raises(ValueError, match="shape"):
        matcher_kernel.match_pairs_cuda(x, m[:, :32], x, m)
    with pytest.raises(ValueError, match="S <= 1024"):
        frame_kernel.track_frames_cuda(
            torch.zeros(40, device=dev), torch.zeros((2048, 3), device=dev),
            torch.zeros(2048, dtype=torch.bool, device=dev),
            frame_kernel.JoinCandidates(torch.zeros((1, 2, 2048), dtype=torch.int32, device=dev),
                                        torch.zeros((1, 2, 2048), dtype=torch.bool, device=dev),
                                        torch.zeros((1, 2048), dtype=torch.bool, device=dev)),
            torch.zeros((1, 2048, 2), device=dev), torch.zeros((1, 2048, 2), device=dev),
            torch.zeros((1, 2048), dtype=torch.bool, device=dev), 10)


def test_run_sequence_cuda_equals_plain(dev):
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in
                        synthetic.generate_tracking_sequence(np.random.default_rng(1), 24, 128))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=256)
    _lib.reset_launches()
    traj, m, outs = pipeline.run_sequence(camera, cfg, pts, apps, masks)
    main_path = ("match_pairs", "join_candidates", "gather_rows", "track_frames")
    assert all(_lib.launches[k] > 0 for k in main_path), _lib.launches
    traj_p, m_p, outs_p = pipeline.run_sequence(
        camera, cfg.replace(matcher_backend="torch", scan_backend="torch"), pts, apps, masks)
    assert float((traj - traj_p).abs().max()) <= 2e-3
    assert torch.equal(m.appearances, m_p.appearances)
    assert torch.equal(outs.num_solver_corr, outs_p.num_solver_corr)


MOUNT = (0.2, -0.1, 0.3, -1.2, 0.1, 0.3)   # a non-identity camera mount, Euler chart


def _mount(dev):
    return se3.v2t_euler(torch.tensor(MOUNT)).to(dev)


@pytest.mark.parametrize("slots,opts", [
    (64, dict(iterations=100, tol=1e-12)),
    (200, dict(iterations=100, tol=1e-12)),
    (64, dict(iterations=12, tol=-1.0, warm_start=True, min_iterations=3)),
])
def test_track_frames_planar_kernel_equals_plain(dev, slots, opts):
    args = _k4_args(dev, 14, slots)
    kw = dict(warm_start=opts.get("warm_start", False),
              min_iterations=opts.get("min_iterations", 1), planar=True,
              cam_in_robot=_mount(dev))
    call = (opts["iterations"], 1e4, 1.0, opts["tol"])
    _lib.reset_launches()
    got = frame_kernel.track_frames(*args, *call, **kw)
    assert _lib.launches["track_frames_planar"] == 1 and _lib.launches["track_frames"] == 0
    ref = frame_kernel.track_frames(*args, *call, backend="torch", **kw)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K5 kernel vs plain, S={slots} {opts}: max |dpose| = {err}")
    assert bool(torch.isfinite(got[0]).all()) and err <= 1e-5
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[3][:, 2:], ref[3][:, 2:])


def _solve_case(dev, n, planar, seed=0):
    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                                       rng.uniform(2.0, 4.0, n)], 1).astype(np.float32))
    cam = synthetic.default_camera()
    if planar:
        mount = se3.v2t_euler(torch.tensor(MOUNT))
        gt = se3.inverse(mount) @ se3.v2t_se2(torch.tensor([0.1, -0.05, 0.04])) @ mount
    else:
        gt = se3.v2t_euler(torch.tensor([0.1, -0.05, 0.02, 0.01, 0.02, -0.03]))
    uv, ok = project_points(cam._replace(world_in_camera=gt), world)
    uv = uv + torch.from_numpy(rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    w = ok.float()
    w[::9] = 0.0
    world[::9] = float("nan")   # dead slots carry garbage; callers sanitize, as picp.solve does
    world = torch.where(w[:, None] > 0, world, 1.0)
    cam = synthetic.default_camera(device=dev)
    return cam, gt.to(dev), world.to(dev), uv.to(dev), w.to(dev)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [100, 1024, 1500, 8192])
@pytest.mark.parametrize("tol,min_inl", [(1e-12, 0.0), (-1.0, 0.0), (1e-12, 1e9)])
def test_picp_solve_kernel_equals_plain(dev, n, planar, tol, min_inl):
    cam, gt, world, uv, w = _solve_case(dev, n, planar)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    if planar:
        fn, head, name = picp_kernel.solve_se2_fused, head + (_mount(dev),), "picp_solve_se2"
    else:
        fn, name = picp_kernel.solve_fused, "picp_solve"
    args = head + (world, uv, w, 12, 1e4, 1.0, tol)
    _lib.reset_launches()
    pose, stats = fn(*args, min_num_inliers=min_inl)
    assert _lib.launches[name] == 1
    pose_p, stats_p = fn(*args, min_num_inliers=min_inl, backend="torch")
    err = float((pose - pose_p).abs().max())
    print(f"K6 {name} N={n} tol={tol} min_inl={min_inl}: max |dpose| = {err}")
    assert err <= 1e-5
    assert int(stats.num_inliers) == int(stats_p.num_inliers)
    assert float((stats.chi_inliers - stats_p.chi_inliers).abs()) <= 1e-5 * float(
        stats_p.chi_inliers.abs() + 1)
    if min_inl > 0:   # below the inlier floor the pose stays (planar: up to c^-1 c rounding)
        assert float((pose - cam.world_in_camera).abs().max()) <= 1e-6
    else:
        assert float((pose - gt).abs().max()) < 5e-3


def _match_case(dev, nq, nk, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, (nk, 10)).astype(np.float32)
    pick = rng.permutation(nk)[:nq]
    q = (db[pick] + rng.normal(0, 1e-3, (nq, 10))).astype(np.float32)
    dbm = rng.uniform(size=nk) > 0.1
    qm = rng.uniform(size=nq) > 0.1
    db[~dbm] = np.nan                  # garbage in masked rows never wins
    dup = pick[dbm[pick]][:8]
    db[(dup + 1) % nk] = db[dup]       # exact duplicates: the first index wins
    dbm[(dup + 1) % nk] = True
    return tuple(torch.from_numpy(x).to(dev) for x in (q, qm, db, dbm)), pick


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("nq,nk", [(100, 1000), (1024, 65536), (130, 300), (7, 1)])
def test_best_match_kernel_equals_plain(dev, nq, nk, fast):
    args, pick = _match_case(dev, nq, max(nk, 1))
    name = "best_match_fast" if fast else "best_match"
    _lib.reset_launches()
    dist, idx = matcher_kernel.best_match(*args, fast=fast)
    assert _lib.launches[name] == 1
    dist_p, idx_p = matcher_kernel.best_match_plain(*args, fast=fast)
    assert torch.equal(idx, idx_p)
    assert torch.equal(dist, dist_p)
    q, qm, db, dbm = args
    assert bool((dist[~qm] == matcher_kernel.BIG).all())
    live = qm & (dist < 1e-2)
    assert bool(dbm[idx[live].long()].all())
    if fast:   # the returned distance is the exact one of the returned index
        exact = ((q[live] - db[idx[live].long()]) ** 2).sum(-1)
        assert float((dist[live] - exact).abs().max()) <= 1e-6


def test_best_match_all_masked_database(dev):
    q = torch.zeros((5, 10), device=dev)
    db = torch.full((40, 10), float("nan"), device=dev)
    qm = torch.ones(5, dtype=torch.bool, device=dev)
    dbm = torch.zeros(40, dtype=torch.bool, device=dev)
    for fast in (False, True):
        dist, idx = matcher_kernel.best_match(q, qm, db, dbm, fast=fast)
        assert bool((dist == matcher_kernel.BIG).all()) and bool((idx == 0).all())


def test_planar_run_sequence_and_relocalize_cuda(dev):
    """The planar fused path and map-scale relocalization launch K5, K7 and K6
    and agree with their plain versions."""
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in
                        synthetic.generate_tracking_sequence(np.random.default_rng(1), 24, 128))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=256).with_planar_mount(_mount(dev).cpu().numpy())
    _lib.reset_launches()
    traj, m, _ = pipeline.run_sequence(camera, cfg, pts, apps, masks)
    assert _lib.launches["track_frames_planar"] == 1 and _lib.launches["track_frames"] == 0
    plain = cfg.replace(matcher_backend="torch", scan_backend="torch", solver_backend="torch")
    traj_p, m_p, _ = pipeline.run_sequence(camera, plain, pts, apps, masks)
    assert float((traj - traj_p).abs().max()) <= 2e-3
    ids = torch.full_like(masks[0], -1, dtype=torch.int32)
    frame = pipeline.FrameData(pts[10], apps[10], masks[10], ids)
    eye = torch.eye(4, device=dev)
    for precision in ("highest", "fast"):
        c = cfg.replace(matcher_precision=precision, gn_iterations=30)
        _lib.reset_launches()
        pose, stats, n = pipeline.relocalize_frame(camera, c, m, frame, eye)
        key = "best_match_fast" if precision == "fast" else "best_match"
        assert _lib.launches[key] == 1 and _lib.launches["picp_solve"] == 1
        pose_p, stats_p, n_p = pipeline.relocalize_frame(
            camera, c.replace(matcher_backend="torch", solver_backend="torch"), m, frame, eye)
        assert int(n) == int(n_p) and int(stats.num_inliers) == int(stats_p.num_inliers)
        assert float((pose - pose_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("planar", [False, True])
def test_step_backend_on_the_card(dev, planar):
    """``scan_backend="step"`` on CUDA tensors: the frame_step loop solves each
    tracked frame through K6 (planar: the plain picp_se2 loop on the card) and
    agrees with the fused K4/K5 launch to the repo's fused-vs-scan tolerance
    2e-3; so does continue_sequence in step form, split or in one call."""
    frames, slots = 12, 128
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in synthetic.generate_tracking_sequence(
        np.random.default_rng(2), frames, slots, seed_motion=6.0))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=slots, map_capacity=256)
    if planar:
        cfg = cfg.with_planar_mount(_mount(dev).cpu().numpy())
    step = cfg.replace(scan_backend="step")
    solves = 0 if planar else frames - 2
    traj_f, map_f, outs_f = pipeline.run_sequence(camera, cfg, pts, apps, masks)
    _lib.reset_launches()
    traj_s, map_s, outs_s = pipeline.run_sequence(camera, step, pts, apps, masks)
    assert _lib.launches["picp_solve"] == solves
    assert _lib.launches["track_frames"] == 0 and _lib.launches["track_frames_planar"] == 0
    assert traj_s.device.type == "cuda" and bool(torch.isfinite(traj_s).all())
    err = float((traj_s - traj_f).abs().max())
    print(f"step vs fused on the card, planar={planar}: max |dpose| = {err}")
    assert err <= 2e-3
    assert torch.equal(outs_s.num_solver_corr, outs_f.num_solver_corr)
    assert int(map_s.count) == int(map_f.count)

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    state0, _ = pipeline.initialize(camera, cfg, f0, f1)

    def cont(config, state, lo, hi):
        return pipeline.continue_sequence(camera, config, state, pts[lo:hi], apps[lo:hi],
                                          masks[lo:hi], ids[lo:hi])

    _lib.reset_launches()
    state_s, full_s = cont(step, state0, 2, None)
    assert _lib.launches["picp_solve"] == solves
    state_f, full_f = cont(cfg, state0, 2, None)
    assert float((full_s.pose - full_f.pose).abs().max()) <= 2e-3
    assert float((full_s.pose - traj_s[2:]).abs().max()) <= 1e-6
    state_a, out_a = cont(step, state0, 2, 7)
    state_b, out_b = cont(step, state_a, 7, None)
    assert torch.equal(full_s.pose, torch.cat([out_a.pose, out_b.pose]))
    assert torch.equal(state_s.point_lookup, state_b.point_lookup)
    assert torch.equal(state_s.map.appearances, state_b.map.appearances)
    assert int(state_s.map.count) == int(state_f.map.count)
