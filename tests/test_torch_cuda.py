"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1-K3 and K7 are exact (the distances use the same explicitly
rounded operations in the same order, K2/K3 are selection). K4, K5 and K6 add
their lane sums in the plain versions' order, both sides use a correctly
rounded sqrt and the card's sin/cos, so their poses are held to 1e-5 (bitwise
expected). K8 equals K4/K5 per sequence exactly (the same ``__global__``),
K10 is a copy and exact, K11 sums in its plain version's order (1e-5 of the
largest entry, bitwise expected), K9 adds with atomics in no fixed order
(rtol 2e-5, atol 1e-4, the JAX package's tolerance for its kernel).
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops import se3
from visual_odometry_tpu_torch.ops.camera import project_points
from visual_odometry_tpu_torch.ops.kernels import (
    frame_kernel, gather_kernel, matcher_kernel, picp_kernel, segsum_kernel,
)
from visual_odometry_tpu_torch.parallel import multiseq, sparse_ba
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


def _k8_args(dev, count, frames, slots, planar):
    """K8's packed arguments for ``count`` sequences and the per-sequence
    K4/K5 arguments they were stacked from."""
    cfg_kw = dict(kernel_threshold=1e4, damping=1.0, tolerance=1e-12)
    singles = []
    for i in range(count):
        a = _k4_args(dev, frames, slots, seed_motion=6.0 - 0.5 * i)
        params = frame_kernel.pack_params(a[0], a[1], a[2], cfg_kw["kernel_threshold"],
                                          cfg_kw["damping"], cfg_kw["tolerance"], False, False,
                                          0.0, planar, _mount(dev) if planar else None)
        singles.append((params,) + a[3:] + (100, 1, planar))
    stack = lambda k: torch.stack([a[k] for a in singles]).contiguous()   # noqa: E731
    cand = frame_kernel.JoinCandidates(
        *(torch.stack([a[3][q] for a in singles]).contiguous() for q in range(3)))
    pose0 = torch.stack([a[0][28:40] for a in singles]).contiguous()
    batched = (singles[0][0], pose0, stack(1), stack(2), cand, stack(4), stack(5), stack(6),
               100, 1, planar)
    return batched, singles


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("count,slots", [(5, 64), (3, 200)])
def test_track_frames_batched_kernel_equals_single_launches(dev, planar, count, slots):
    """K8 per sequence against K4/K5 launched alone: every output bit for bit;
    and against its plain version."""
    batched, singles = _k8_args(dev, count, 12, slots, planar)
    name = "track_frames_batched_planar" if planar else "track_frames_batched"
    _lib.reset_launches()
    got = frame_kernel.track_frames_batched_cuda(*batched)
    assert _lib.launches[name] == 1
    for i, a in enumerate(singles):
        alone = frame_kernel.track_frames_cuda(*a)
        for g, x in zip(got, alone):
            assert torch.equal(g[i], x)
    ref = frame_kernel.track_frames_batched_plain(*batched)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K8 kernel vs plain, planar={planar} N={count} S={slots}: max |dpose| = {err}")
    assert err <= 1e-5
    assert torch.equal(got[2], ref[2])


def test_track_frames_batched_dead_sequence(dev):
    """A sequence with no valid correspondence: identity poses, nothing
    triangulated, no NaN, and its neighbours untouched."""
    batched, singles = _k8_args(dev, 3, 10, 64, False)
    valid = batched[7].clone()
    valid[1] = False
    tri_ok = batched[3].clone()
    tri_ok[1] = False
    args = batched[:3] + (tri_ok,) + batched[4:7] + (valid,) + batched[8:]
    got = frame_kernel.track_frames_batched_cuda(*args)
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    assert torch.equal(got[0][1], torch.eye(4, device=dev).expand_as(got[0][1]))
    assert not got[2][1].any() and float(got[3][1].abs().max()) == 0.0
    for i in (0, 2):
        for g, x in zip(got, frame_kernel.track_frames_cuda(*singles[i])):
            assert torch.equal(g[i], x)


def test_run_sequences_batched_cuda_equals_run_sequence(dev):
    """The batch-aware program on the card: K1-K3 once a stage, K8 once, each
    sequence equal to its own run_sequence."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(7 + i), 12, 64)
            for i in range(4)]
    tensors = tuple(torch.from_numpy(np.stack([q[k] for q in seqs])).to(dev) for k in range(3))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=30)
    _lib.reset_launches()
    traj, maps, outs = multiseq.run_sequences_batched(camera, cfg, *tensors)
    assert (_lib.launches["match_pairs"], _lib.launches["join_candidates"],
            _lib.launches["gather_rows"], _lib.launches["track_frames_batched"]) == (2, 1, 2, 1)
    for i in range(4):
        t_i, m_i, o_i = pipeline.run_sequence(camera, cfg, *(x[i] for x in tensors))
        assert torch.equal(traj[i], t_i)
        assert int(maps.count[i]) == int(m_i.count)
        assert torch.equal(outs.tri_valid[i], o_i.tri_valid)
    looped = multiseq.run_sequences_batched(camera, cfg, *tensors, backend="torch")
    assert float((looped[0] - traj).abs().max()) <= 2e-3


@pytest.mark.parametrize("r,t,n", [(12, 512, 70000), (6, 40, 1000), (1, 1024, 33), (12, 1024, 5)])
def test_take_table_kernel_equals_plain(dev, r, t, n):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(r, t)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-3, t + 3, n).astype(np.int32)).to(dev)
    _lib.reset_launches()
    got = gather_kernel.take_table(table, idx)
    assert _lib.launches["take_table"] == 1
    assert torch.equal(got, gather_kernel.take_table_plain(table, idx))
    with pytest.raises(ValueError):
        gather_kernel.take_table_cuda(torch.zeros((13, 8), device=dev), idx)
    with pytest.raises(ValueError):
        gather_kernel.take_table_cuda(torch.zeros((2, 1025), device=dev), idx)


@pytest.mark.parametrize("n,r,t", [(70000, 36, 512), (5000, 6, 512), (3000, 64, 1024),
                                   (2000, 100, 1024), (10, 9, 3)])
def test_segment_sum_kernel_close_to_plain(dev, n, r, t):
    """Rows wider than the shared-memory table tile over blockIdx.y (R = 64
    and 100 at T = 1024); ids outside [0, T) add nothing."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(rng.integers(-2, t + 4, n).astype(np.int32)).to(dev)
    _lib.reset_launches()
    got = segsum_kernel.segment_sum_small(vals, seg, t)
    assert _lib.launches["segment_sum"] == 1
    ref = segsum_kernel.segment_sum_small_plain(vals, seg, t)
    print(f"K9 N={n} R={r} T={t}: max |diff| = {float((got - ref).abs().max())}")
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-4)
    with pytest.raises(ValueError):
        segsum_kernel.segment_sum_small_cuda(vals, seg, 1025)


@pytest.mark.parametrize("n", [7, 100, 1024, 1500, 8192])
@pytest.mark.parametrize("keep_outliers", [False, True])
def test_picp_linearize_kernel_equals_plain(dev, n, keep_outliers):
    cam, _, world, uv, w = _solve_case(dev, n, False)
    head, pts = (cam.camera_matrix, cam.world_in_camera, cam.params()), (world, uv, w)
    _lib.reset_launches()
    h, b, st = picp_kernel.linearize(*head, *pts, 0.5, keep_outliers)
    assert _lib.launches["picp_linearize"] == 1
    hp, bp, stp = picp_kernel.linearize_plain(*head, *pts, 0.5, keep_outliers)
    scale = float(hp.abs().max())
    print(f"K11 N={n}: max |dH| = {float((h - hp).abs().max())} of {scale}")
    assert float((h - hp).abs().max()) <= 1e-5 * scale
    assert float((b - bp).abs().max()) <= 1e-5 * max(float(bp.abs().max()), 1.0)
    assert torch.equal(h, h.T) and int(st.num_inliers) == int(stp.num_inliers)
    assert abs(float(st.chi_inliers) - float(stp.chi_inliers)) <= 1e-5 * float(stp.chi_inliers)


@pytest.mark.parametrize("pack", [False, True])
def test_sparse_ba_step_on_the_card_matches_the_cpu(dev, pack):
    """One sparse step on the card (K9 and K10: 2 + i and 4 + i launches for
    i CG iterations) against the plain run on the CPU: poses within 1e-4,
    landmarks within 5e-4 (the JAX package's own landmark tolerance between
    two solves of one system, tests/test_sparse_ba.py:108: ten float32 CG
    iterations over sums taken in another order), chi within 1e-4 relative."""
    k, problem, _ = synthetic.generate_ba_corridor(f=16, l=400)
    k = torch.from_numpy(k)
    work, degree = sparse_ba.pack_problem(problem) if pack else (problem, None)
    ref, ref_stats = sparse_ba.sparse_ba_step(k, work, cg_iterations=10, cg_tolerance=0.0,
                                              lm_degree=degree)
    on_card = sparse_ba.SparseBAProblem(*(x.to(dev) for x in work))
    _lib.reset_launches()
    got, stats = sparse_ba.sparse_ba_step(k.to(dev), on_card, cg_iterations=10, cg_tolerance=0.0,
                                          lm_degree=degree)
    assert (_lib.launches["take_table"], _lib.launches["segment_sum"]) == (12, 14)
    torch.testing.assert_close(got.poses.cpu(), ref.poses, rtol=0, atol=1e-4)
    torch.testing.assert_close(got.landmarks.cpu(), ref.landmarks, rtol=0, atol=5e-4)
    assert abs(float(stats.chi) - float(ref_stats.chi)) <= 1e-4 * float(ref_stats.chi)
    assert int(stats.num_obs) == int(ref_stats.num_obs)


SERVING_MOUNT = (0.05, -0.1, 0.02, 0.01, -0.02, 0.015)   # keeps all 128 landmarks in view


def _planar_robot_sequence(seed, frames, slots):
    """Landmark field ``seed`` seen from a planar robot's orbit through
    ``SERVING_MOUNT``: the motion lies in the subgroup the planar solver
    moves in."""
    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, slots), rng.uniform(-1.2, 1.2, slots),
                                       rng.uniform(2.0, 4.0, slots)], axis=1).astype(np.float32))
    apps = torch.from_numpy(synthetic.generate_appearances(rng, slots))
    mount = se3.v2t_euler(torch.tensor(SERVING_MOUNT))
    ph = 2.0 * np.pi * torch.arange(frames, dtype=torch.float32) / 64.0
    robot = se3.v2t_se2(torch.stack([0.3 * torch.cos(ph), 0.3 * torch.sin(ph),
                                     0.02 * torch.sin(ph)], dim=-1))
    pts, masks = zip(*(project_points(synthetic.default_camera(p), world)
                       for p in se3.inverse(mount) @ robot @ mount))
    return torch.stack(pts), apps[None].expand(frames, -1, -1).contiguous(), torch.stack(masks)


@pytest.mark.parametrize("planar", [False, True])
def test_bootstrap_keeps_every_serving_field(dev, planar):
    """The two-view bootstrap at the default width: of 80 landmark fields (128
    slots, baseline about a hundredth of the depth, the first 24 frames) every
    one tracks with all 128 inliers in every frame. With the 8-point normal
    matrix in float32 a third of the SE(3) fields lost inliers on the card."""
    seqs = []
    for seed in range(100, 180):
        if planar:
            seqs.append(_planar_robot_sequence(seed, 24, 128))
        else:
            seqs.append(tuple(torch.from_numpy(x) for x in synthetic.generate_tracking_sequence(
                np.random.default_rng(seed), 24, 128)))
    tensors = tuple(torch.stack([q[k] for q in seqs]).to(dev) for k in range(3))
    cfg = VOConfig()
    if planar:
        cfg = cfg.with_planar_mount(se3.v2t_euler(torch.tensor(SERVING_MOUNT)).numpy())
    traj, _, outs = multiseq.run_sequences_batched(synthetic.deep_camera(device=dev), cfg, *tensors)
    assert bool(torch.isfinite(traj).all())
    least = outs.num_inliers.min(dim=1).values.cpu()
    lost = [(100 + i, int(v)) for i, v in enumerate(least) if v < 128]
    assert not lost, f"fields that lost inliers (field, least of 128): {lost}"


def test_sparse_ba_frame_helpers_never_give_way_on_the_card(dev):
    """On CUDA tensors the frame-space gather and sum always launch K10 and
    K9: wide rows go through (K9 tiles any R), and past the kernels' 1,024
    segments they raise instead of running the plain version."""
    rng = np.random.default_rng(0)
    fi = torch.from_numpy(rng.integers(0, 40, 5000).astype(np.int32)).to(dev)
    wide = torch.from_numpy(rng.normal(size=(5000, 100)).astype(np.float32)).to(dev)
    _lib.reset_launches()
    got = sparse_ba._segsum_frame_rows(wide, fi, 40)
    assert _lib.launches["segment_sum"] == 1
    ref = segsum_kernel.segment_sum_small_plain(wide, fi, 40)
    torch.testing.assert_close(got, ref, rtol=2e-5, atol=1e-4)
    with pytest.raises(ValueError, match="1024"):
        sparse_ba._segsum_frame_rows(wide, fi, 1025)
    with pytest.raises(ValueError, match="1024"):
        sparse_ba._gather_frame_rows(torch.zeros((1025, 6), device=dev), fi)
    with pytest.raises(ValueError, match="12"):
        sparse_ba._gather_frame_rows(torch.zeros((40, 13), device=dev), fi)
