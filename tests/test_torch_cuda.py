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
largest entry, bitwise expected), K9 sums in one fixed order that its plain
version repeats: exact, and the same bits in every launch. utils/selfcheck's
checks hold their own tolerances (the JAX package's), and utils/roofline's
fractions lie in (0, 1].
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
from visual_odometry_tpu_torch.parallel import multiseq, posegraph, sparse_ba
from visual_odometry_tpu_torch.utils import roofline, selfcheck, synthetic
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


def test_match_pairs_kernel_ties_across_tiles(dev):
    """K1 spreads a pair over 128-row tiles and eight column splits: ties
    placed across both boundaries (duplicates at j and j + 128, and j + 97)
    keep the first index; one pair at N = 1024; an all-masked frame and NaN
    garbage in masked slots; exact against the plain version."""
    rng = np.random.default_rng(11)
    for b, n in ((1, 1024), (2, 1000)):
        a1 = rng.uniform(-1, 1, (b, n, 10)).astype(np.float32)
        a2 = a1[:, rng.permutation(n)] + rng.normal(0, 0.02, (b, n, 10)).astype(np.float32)
        for j in range(0, n - 128, 61):
            a1[:, j + 128] = a1[:, j]
            a2[:, j + 128] = a2[:, j]
            a2[:, j + 97] = a2[:, j]
        m1 = rng.uniform(size=(b, n)) > 0.1
        m2 = rng.uniform(size=(b, n)) > 0.1
        m1[-1] = False
        a1[~m1] = np.nan
        a2[~m2] = np.nan
        args = [torch.from_numpy(x).to(dev) for x in (a1, m1, a2, m2)]
        got = matcher_kernel.match_pairs_cuda(*args)
        ref = matcher_kernel.match_pairs_plain(*args)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert bool((got[2][-1] == 3.4e38).all()) and not bool(got[3][-1].any())


@pytest.mark.parametrize("f,s,depth", [(4, 40, 1), (6, 256, 2), (3, 1024, 3), (8, 128, 1),
                                       (8, 128, 4), (5, 1024, 1), (5, 1024, 4)])
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


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("s", [128, 1024])
def test_join_candidates_kernel_out_of_range_targets(dev, s, depth):
    """Targets outside [0, S) on valid and invalid lanes of both sides
    (K2 scans for them; the tables take the rest), multiplicities above the
    depth: bitwise against the plain version."""
    rng = np.random.default_rng(s + depth)
    f = 6
    src = rng.integers(-3, s // 8, (f, s)).astype(np.int32)
    dst = rng.integers(-3, s // 6, (f, s)).astype(np.int32)
    src[:, ::5] += s
    dst[:, 1::7] += s
    src[0, :] = -1                       # one frame whose sources all miss
    args = [torch.from_numpy(x).to(dev) for x in (
        src, rng.uniform(size=(f, s)) > 0.2, dst, rng.uniform(size=(f, s)) > 0.2)]
    got = frame_kernel.join_candidates_cuda(*args, depth)
    ref = frame_kernel.join_candidates_plain(*args, depth)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    far = (args[2] < 0) | (args[2] >= s)
    assert bool((far & args[3] & got.ok[:, 0]).any())   # an out-of-range chain was found
    assert bool(got.overflow.any())


@pytest.mark.parametrize("d", [2, 10])
@pytest.mark.parametrize("f,s", [(510, 1024), (7, 100)])
def test_gather_rows_kernel_equals_plain(dev, f, s, d):
    """Path B's pixel (D=2) and appearance (D=10) gathers at its shape (510
    frames x 1024 slots) and at a ragged S, with indices past both ends of
    S: clipped like the plain version's."""
    rng = np.random.default_rng(d)
    src = torch.from_numpy(rng.normal(size=(f, s, d)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-5, s + 5, (f, s)).astype(np.int32)).to(dev)
    _lib.reset_launches()
    got = gather_kernel.gather_rows(src, idx)
    assert _lib.launches["gather_rows"] == 1
    assert torch.equal(got, gather_kernel.gather_rows_plain(src, idx))


def test_gather_rows_kernel_reads_a_batch_slice(dev):
    """The serving form: a (B, F, S, D) frame slice of the batch, read in
    place through its leading strides; any other D, a misaligned source and
    records that are not contiguous take the kernel too, and equal the plain
    version."""
    rng = np.random.default_rng(0)
    for d in (2, 10, 3):
        full = torch.from_numpy(rng.normal(size=(4, 9, 128, d)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-2, 130, (4, 7, 128)).astype(np.int32)).to(dev)
        assert torch.equal(gather_kernel.gather_rows(full[:, 1:-1], idx),
                           gather_kernel.gather_rows_plain(full[:, 1:-1], idx))
    idx = idx[0]
    flat = torch.from_numpy(rng.normal(size=7 * 128 * 2 + 1).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.normal(size=(7, 2, 128)).astype(np.float32)).to(dev)
    for src in (flat[1:].view(7, 128, 2),          # 4-byte aligned only
                rows.transpose(1, 2),               # (F, S, D) view of (F, D, S) rows
                torch.from_numpy(rng.normal(size=(7, 128, 1)).astype(np.float32)).to(dev)):
        _lib.reset_launches()
        got = gather_kernel.gather_rows(src, idx)
        assert _lib.launches["gather_rows"] == 1
        assert torch.equal(got, gather_kernel.gather_rows_plain(src, idx))
    with pytest.raises(ValueError, match="float32"):
        gather_kernel.gather_rows_cuda(torch.zeros((7, 128, 2), device=dev, dtype=torch.float64),
                                       idx)
    with pytest.raises(ValueError, match="dtype"):
        gather_kernel.gather_rows_cuda(torch.zeros((7, 128, 2), device=dev), idx.long())


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
    (256, dict(iterations=100, tol=1e-12)),      # a cluster of 2 CTAs
    (1024, dict(iterations=100, tol=1e-12)),     # a cluster of 4 CTAs
    (512, dict(iterations=12, tol=-1.0, warm_start=True, min_iterations=3)),
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
    assert _lib.launches["gather_rows"] == 3   # previous pixels, current pixels, appearances
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
    (512, dict(iterations=100, tol=1e-12)),      # a cluster of 4 CTAs
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


def _k6(dev, planar):
    cam = synthetic.default_camera(device=dev)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    if planar:
        return cam, picp_kernel.solve_se2_fused, head + (_mount(dev),), "picp_solve_se2"
    return cam, picp_kernel.solve_fused, head, "picp_solve"


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# K6's launch geometry changes at 256 and 2,048 points (lanes loop over
# points above 2,048, and read them from global memory above 8,192), K11's
# at 256 (picp_kernel.solve_geometry, linearize_geometry).
@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [1, 100, 1024, 1025, 1500, 4096, 8192, 8193])
@pytest.mark.parametrize("tol,min_inl", [(1e-12, 0.0), (-1.0, 0.0), (1e-12, 1e9)])
def test_picp_solve_kernel_equals_plain(dev, n, planar, tol, min_inl):
    """K6 against its plain version, which adds in the kernel's order at the
    kernel's geometry: the same bits."""
    cam, gt, world, uv, w = _solve_case(dev, n, planar)
    cam, fn, head, name = _k6(dev, planar)
    args = head + (world, uv, w, 12, 1e4, 1.0, tol)
    _lib.reset_launches()
    pose, stats = fn(*args, min_num_inliers=min_inl)
    assert _lib.launches[name] == 1
    pose_p, stats_p = fn(*args, min_num_inliers=min_inl, backend="torch")
    err = float((pose - pose_p).abs().max())
    print(f"K6 {name} N={n} geometry {picp_kernel.solve_geometry(n)} tol={tol} "
          f"min_inl={min_inl}: max |dpose| = {err}")
    assert err <= 1e-5
    assert torch.equal(_bits(pose), _bits(pose_p))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(stats, stats_p))
    assert stats.num_inliers.dtype == torch.int32
    if min_inl > 0:   # below the inlier floor the pose stays (planar: up to c^-1 c rounding)
        assert float((pose - cam.world_in_camera).abs().max()) <= 1e-6
    elif n >= 100:
        assert float((pose - gt).abs().max()) < 5e-3


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [100, 8192, 8193])
def test_picp_solve_kernel_sanitizes_dead_slots(dev, n, planar):
    """NaN and inf in dead slots, not sanitized by the caller: K6 gives the
    bits of the sanitized call, and its plain version the same bits."""
    cam, gt, world, uv, w = _solve_case(dev, n, planar)
    cam, fn, head, name = _k6(dev, planar)
    dead = w <= 0
    bad_world = torch.where(dead[:, None], float("nan"), world)
    bad_world[::18] = torch.where(dead[::18, None], float("inf"), bad_world[::18])
    bad_uv = torch.where(dead[:, None], float("nan"), uv)
    clean = fn(*head, world, torch.where(dead[:, None], 0.0, uv), w, 12, 1e4, 1.0, 1e-12)
    got = fn(*head, bad_world, bad_uv, w, 12, 1e4, 1.0, 1e-12)
    plain = fn(*head, bad_world, bad_uv, w, 12, 1e4, 1.0, 1e-12, backend="torch")
    assert bool(torch.isfinite(got[0]).all())
    for other in (clean, plain):
        assert torch.equal(_bits(got[0]), _bits(other[0]))
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got[1], other[1]))


def test_picp_solve_launches_k6_alone(dev):
    """``picp.solve`` on the card: one K6 launch and no tensor operation that
    computes (no sanitizing ``where``, no stacked camera row, no cast); only
    the output's allocation and views of tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from visual_odometry_tpu_torch.ops import picp

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    cam, gt, world, uv, w = _solve_case(dev, 1024, False)
    world = torch.where(w[:, None] > 0, world, float("nan"))
    picp.solve(cam, world, uv, w, 12, kernel_threshold=1e4, tolerance=1e-12)   # warm
    _lib.reset_launches()
    with Ops() as ops:
        solved, stats = picp.solve(cam, world, uv, w, 12, kernel_threshold=1e4, tolerance=1e-12)
    assert _lib.launches["picp_solve"] == 1
    assert set(ops.names) <= {"empty", "view", "slice", "select", "alias", "detach"}, ops.names
    assert float((solved.world_in_camera - gt).abs().max()) < 5e-3


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


@pytest.mark.parametrize("nk", [1 << 16, 1 << 20])
def test_best_match_fast_on_match_ties(dev, nk):
    """K7's tensor-core filter on data built to trip it
    (synthetic.generate_match_ties: negative gram distances that clamp and
    tie, duplicates one tile apart, rows one bfloat16 ulp apart, NaN and inf
    in masked and live rows), then with every row masked: indices and
    distances bitwise against the plain version, both precisions; the fast
    mode reports the pairs it rescored."""
    q, qm, db, dbm = (torch.from_numpy(x).to(dev) for x in synthetic.generate_match_ties(
        np.random.default_rng(3), 1024, nk))
    for mask in (dbm, torch.zeros_like(dbm)):
        for fast in (False, True):
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            dist, idx = matcher_kernel.best_match_cuda(q, qm, db, mask, fast, survivors=counter)
            dist_p, idx_p = matcher_kernel.best_match_plain(q, qm, db, mask, fast=fast)
            assert torch.equal(idx, idx_p) and torch.equal(dist, dist_p)
            rescored = int(counter.item())
            if not fast or not bool(mask.any()):
                assert rescored == 0
            else:
                assert 1024 <= rescored <= 1024 * 256   # a seeded threshold: few a query
    assert bool((idx == 0).all())


@pytest.mark.parametrize("d", [7, 16, 24])
def test_best_match_fast_other_widths(dev, d):
    """D = 7 and 16 take the tensor-core scan's generic instance, D = 24 the
    bf16-rounded gram on the FP32 pipes: bitwise against the plain version
    on generate_match_ties' data at that width."""
    q, qm, db, dbm = (torch.from_numpy(x).to(dev) for x in synthetic.generate_match_ties(
        np.random.default_rng(d), 512, 1 << 16, dim=d))
    dist, idx = matcher_kernel.best_match_cuda(q, qm, db, dbm, True)
    dist_p, idx_p = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=True)
    assert torch.equal(idx, idx_p) and torch.equal(dist, dist_p)


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
@pytest.mark.parametrize("count,slots", [(5, 64), (3, 200), (2, 512), (4, 1024)])
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
            _lib.launches["gather_rows"], _lib.launches["track_frames_batched"]) == (2, 1, 3, 1)
    for i in range(4):
        t_i, m_i, o_i = pipeline.run_sequence(camera, cfg, *(x[i] for x in tensors))
        assert torch.equal(traj[i], t_i)
        assert int(maps.count[i]) == int(m_i.count)
        assert torch.equal(outs.tri_valid[i], o_i.tri_valid)
    looped = multiseq.run_sequences_batched(camera, cfg, *tensors, backend="torch")
    assert float((looped[0] - traj).abs().max()) <= 2e-3


def test_run_sequence_chunked_cuda_equals_loop_form(dev):
    """Chunked tracking on the card: the chunks as one batched program (K1
    for the bootstrap scores, the chunks' bootstrap pairs and their flattened
    pairs, one K2, three K3, one K8 and no K4) equal to the loop form (K4
    once a chunk) bit for bit: trajectory, map and diagnostics."""
    seq = synthetic.generate_tracking_sequence(np.random.default_rng(0), 64, 128)
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in seq)
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=512)
    _lib.reset_launches()
    got = posegraph.run_sequence_chunked(camera, cfg, pts, apps, masks, num_chunks=3, overlap=8)
    want = {"match_pairs": 3, "join_candidates": 1, "gather_rows": 3, "track_frames_batched": 1,
            "track_frames": 0}
    assert {k: _lib.launches[k] for k in want} == want
    _lib.reset_launches()
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    starts, length, _ = posegraph._plan(cfg, pts, apps, masks, ids, False, 3, 8, None)
    chunked = [posegraph._chunk(x, starts, length) for x in (pts, apps, masks, ids)]
    loop = posegraph._track_and_stitch(camera, cfg, *chunked, starts, length, pts.shape[0],
                                       False, batched=False)
    assert _lib.launches["track_frames"] == 3 and _lib.launches["track_frames_batched"] == 0
    assert bool((got[2].num_ratio_obs >= 8).all())
    for a, b in zip((got[0], *got[1], *got[2]), (loop[0], *loop[1], *loop[2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("r", range(1, 13))
def test_take_table_kernel_equals_plain(dev, r):
    """R = 1..12 at T up to 1500 (no limit on T), the table contiguous and
    as the transpose of an (F, R) tensor (strided), the output in both
    layouts; indices past both ends of T are clipped."""
    rng = np.random.default_rng(r)
    for t, n in ((1500, 9000), (1025, 5000), (1024, 70001), (512, 4096), (40, 1000), (1, 33)):
        rows = torch.from_numpy(rng.normal(size=(t, r)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(-3, t + 3, n).astype(np.int32)).to(dev)
        for table in (rows.T.contiguous(), rows.T):
            for transpose_out in (False, True):
                _lib.reset_launches()
                got = gather_kernel.take_table_cuda(table, idx, transpose_out)
                assert _lib.launches["take_table"] == 1
                assert torch.equal(got, gather_kernel.take_table_plain(table, idx, transpose_out))
    with pytest.raises(ValueError):
        gather_kernel.take_table_cuda(torch.zeros((13, 8), device=dev), idx)


@pytest.mark.parametrize("n,r,t", [(70000, 36, 512), (5000, 6, 512), (3000, 64, 1024),
                                   (2000, 100, 1024), (10, 9, 3), (9000, 36, 1025),
                                   (12000, 7, 1500), (40, 5, 3000)])
def test_segment_sum_kernel_close_to_plain(dev, n, r, t):
    """K9 equals its plain version (the same order of the sum): any R (64,
    100 and an odd 7 included), any T (past 1,024, and with most segments
    empty at T = 3000), ids outside [0, T) adding nothing; within rtol 2e-5,
    atol 1e-4 of index_add_."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32)).to(dev)
    seg = torch.from_numpy(rng.integers(-2, t + 4, n).astype(np.int32)).to(dev)
    _lib.reset_launches()
    got = segsum_kernel.segment_sum_small(vals, seg, t)
    assert _lib.launches["segment_sum"] == 1
    ref = segsum_kernel.segment_sum_small_plain(vals, seg, t)
    assert torch.equal(got, ref)
    keep = (seg >= 0) & (seg < t)
    lib = torch.zeros((t + 1, r), device=dev).index_add_(0, torch.where(keep, seg, t).long(), vals)
    torch.testing.assert_close(got, lib[:t], rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("r", [36, 6])
def test_segment_sum_kernel_is_run_to_run_identical(dev, r):
    """At the sparse-BA corridor's shapes (N ~ 6e5 observations over T = 512
    frames, masked ones dropped) two launches over one plan give the same
    bits, and equal the plain version."""
    _, problem, _ = synthetic.generate_ba_corridor(f=512, l=100_000, device=dev)
    f = problem.poses.shape[0]
    seg = torch.where(problem.obs_mask, problem.frame_idx, f).to(torch.int32)
    plan = segsum_kernel.plan_segments(seg, f)
    rng = np.random.default_rng(r)
    vals = torch.from_numpy(rng.normal(size=(seg.shape[0], r)).astype(np.float32)).to(dev)
    first = segsum_kernel.segment_sum_small_cuda(vals, seg, f, plan)
    second = segsum_kernel.segment_sum_small_cuda(vals, seg, f, plan)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert torch.equal(first, segsum_kernel.segment_sum_small_plain(vals, seg, f, plan))


@pytest.mark.parametrize("n", [1, 7, 100, 256, 257, 1024, 1025, 1500, 4096, 8192, 8193])
@pytest.mark.parametrize("keep_outliers", [False, True])
def test_picp_linearize_kernel_equals_plain(dev, n, keep_outliers):
    """K11 against its plain version, which adds in the kernel's order at the
    kernel's geometry: the same bits."""
    cam, _, world, uv, w = _solve_case(dev, n, False)
    head, pts = (cam.camera_matrix, cam.world_in_camera, cam.params()), (world, uv, w)
    _lib.reset_launches()
    h, b, st = picp_kernel.linearize(*head, *pts, 0.5, keep_outliers)
    assert _lib.launches["picp_linearize"] == 1
    hp, bp, stp = picp_kernel.linearize_plain(*head, *pts, 0.5, keep_outliers)
    scale = float(hp.abs().max())
    print(f"K11 N={n} geometry {picp_kernel.linearize_geometry(n)}: "
          f"max |dH| = {float((h - hp).abs().max())} of {scale}")
    assert float((h - hp).abs().max()) <= 1e-5 * scale
    assert float((b - bp).abs().max()) <= 1e-5 * max(float(bp.abs().max()), 1.0)
    assert torch.equal(h, h.T) and int(st.num_inliers) == int(stp.num_inliers)
    assert abs(float(st.chi_inliers) - float(stp.chi_inliers)) <= 1e-5 * float(stp.chi_inliers)
    assert torch.equal(_bits(h), _bits(hp)) and torch.equal(_bits(b), _bits(bp))
    assert all(torch.equal(_bits(x), _bits(y)) for x, y in zip(st, stp))


@pytest.mark.parametrize("n", [8192, 100_000])
def test_picp_linearize_kernel_is_run_to_run_identical(dev, n):
    """K11 folds its CTAs' partials in CTA order through per-stream scratch:
    two launches give the same bits, and the scratch's ticket is left zero."""
    cam, _, world, uv, w = _solve_case(dev, n, False)
    args = (cam.camera_matrix, cam.world_in_camera, cam.params(), world, uv, w, 0.5)
    first = picp_kernel.linearize(*args)
    second = picp_kernel.linearize(*args)
    for a, b in zip(first[:2] + tuple(first[2]), second[:2] + tuple(second[2])):
        assert torch.equal(_bits(a), _bits(b))
    ctas, _ = picp_kernel.linearize_geometry(n)
    assert int(_lib.stream_scratch(world.device, 1 + 30 * ctas)[0]) == 0


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
    K9: wide rows go through (K9 takes any R), so do 1,025 and 1,500 poses
    (the kernels' former limit was 1,024), equal to the plain versions; past
    K10's 12 rows they raise instead of running the plain version."""
    rng = np.random.default_rng(0)
    for f in (40, 1025, 1500):
        fi = torch.from_numpy(rng.integers(0, f, 5000).astype(np.int32)).to(dev)
        wide = torch.from_numpy(rng.normal(size=(5000, 100)).astype(np.float32)).to(dev)
        table = torch.from_numpy(rng.normal(size=(f, 6)).astype(np.float32)).to(dev)
        _lib.reset_launches()
        got = sparse_ba._segsum_frame_rows(wide, fi, f)
        rows = sparse_ba._gather_frame_rows(table, fi)
        assert (_lib.launches["segment_sum"], _lib.launches["take_table"]) == (1, 1)
        assert torch.equal(got, segsum_kernel.segment_sum_small_plain(wide, fi, f))
        assert torch.equal(rows, table[fi.long()])
    with pytest.raises(ValueError, match="12"):
        sparse_ba._gather_frame_rows(torch.zeros((40, 13), device=dev), fi)


def test_sparse_ba_step_past_1024_poses_on_the_card(dev):
    """One packed step at 1,536 poses through K9 and K10 (12 and 14
    launches for 10 CG iterations) against the CPU step: landmarks within
    5e-4, rotations within 1e-4, chi within 1e-4 relative, as in
    test_sparse_ba_step_on_the_card_matches_the_cpu. The translations move
    by units along this chain, where the float32 step is itself uncertain:
    they must lie within 1e-4, or within the CPU's own distance from the
    float64 step if that is larger."""
    k, problem, _ = synthetic.generate_ba_corridor(f=1536, l=20_000)
    k = torch.from_numpy(k)
    work, degree = sparse_ba.pack_problem(problem)
    kw = dict(cg_iterations=10, cg_tolerance=0.0, lm_degree=degree)
    ref, ref_stats = sparse_ba.sparse_ba_step(k, work, **kw)
    w64 = work._replace(poses=work.poses.double(), landmarks=work.landmarks.double(),
                        uv=work.uv.double())
    exact, _ = sparse_ba.sparse_ba_step(k.double(), w64, **kw)
    on_card = sparse_ba.SparseBAProblem(*(x.to(dev) for x in work))
    _lib.reset_launches()
    got, stats = sparse_ba.sparse_ba_step(k.to(dev), on_card, **kw)
    assert (_lib.launches["take_table"], _lib.launches["segment_sum"]) == (12, 14)
    poses = got.poses.cpu()
    torch.testing.assert_close(poses[:, :3, :3], ref.poses[:, :3, :3], rtol=0, atol=1e-4)
    t_tol = max(1e-4, float((ref.poses[:, :3, 3] - exact.poses[:, :3, 3]).abs().max()))
    assert float((poses[:, :3, 3] - ref.poses[:, :3, 3]).abs().max()) <= t_tol
    torch.testing.assert_close(got.landmarks.cpu(), ref.landmarks, rtol=0, atol=5e-4)
    assert abs(float(stats.chi) - float(ref_stats.chi)) <= 1e-4 * float(ref_stats.chi)


def test_pca_tree_on_the_card_matches_the_cpu(dev):
    """A tree built on the card (its node sums by K9) has the CPU tree's
    leaves, the same bits in two builds, and gives the CPU's query answers."""
    from visual_odometry_tpu_torch.ops import pca_tree

    rng = np.random.default_rng(5)
    db = rng.uniform(-1, 1, (600, 10)).astype(np.float32)
    mask = rng.uniform(size=600) > 0.1
    q = (db[rng.integers(0, 600, 128)] + rng.normal(0, 0.1, (128, 10))).astype(np.float32)
    qm = np.ones(128, bool)
    cpu = pca_tree.build_tree(torch.from_numpy(db), torch.from_numpy(mask), 5)
    args = [torch.from_numpy(x).to(dev) for x in (db, mask)]
    _lib.reset_launches()
    card = pca_tree.build_tree(*args, 5)
    assert _lib.launches["segment_sum"] == 10
    again = pca_tree.build_tree(*args, 5)
    assert torch.equal(card.axes, again.axes) and torch.equal(card.codes, again.codes)

    def leaves(codes):
        codes = codes.cpu().numpy()
        return {frozenset(np.flatnonzero(codes == c).tolist()) for c in np.unique(codes[codes >= 0])}

    assert leaves(card.codes) == leaves(cpu.codes)
    got = pca_tree.best_match_fast(card, args[0], torch.from_numpy(q).to(dev),
                                   torch.from_numpy(qm).to(dev), 0.4)
    want = pca_tree.best_match_fast(cpu, torch.from_numpy(db), torch.from_numpy(q),
                                    torch.from_numpy(qm), 0.4)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_synthetic_apps_on_the_card(dev):
    """The synthetic programs on the card meet the JAX package's guards and
    launch K6 once a solve; the PICP solve at 100 rounds lies within 1e-4 of
    the CPU's plain loop."""
    from visual_odometry_tpu_torch import apps

    _lib.reset_launches()
    x, x_gt = apps.run_picp_synthetic(num_points=1000, iterations=100, verbose=False, device=dev)
    assert _lib.launches["picp_solve"] == 1
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-3)
    xc, _ = apps.run_picp_synthetic(num_points=1000, iterations=100, verbose=False, device="cpu")
    np.testing.assert_allclose(x, xc, atol=1e-4)
    x, x_gt = apps.run_whole_synthetic(num_points=1500, verbose=False, device=dev)
    assert _lib.launches["picp_solve"] == 2
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-2)
    x, x_gt = apps.run_init_synthetic(num_points=400, verbose=False, device=dev)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=5e-3)
    assert apps.run_kdtree_test(num_points=300, verbose=False, device=dev).mean() > 0.9


@pytest.mark.parametrize("name", list(selfcheck.LAUNCHES))
def test_selfcheck_on_the_card(dev, name):
    """Each of utils/selfcheck's eight checks passes on the card, and each of
    its kernels launched (the counters are reset before its kernel side)."""
    getattr(selfcheck, name)(dev)
    assert all(_lib.launches[k] > 0 for k in selfcheck.LAUNCHES[name])


def test_selfcheck_run_all_on_the_card(dev):
    assert set(selfcheck.run_all()) >= {"map_size", "pair_matcher_n_valid", "serving_traj_diff"}


def test_roofline_spec_of_this_card(dev):
    props = torch.cuda.get_device_properties(dev)
    spec = roofline.spec_for(props)
    assert spec.name == props.name and spec.sms == props.multi_processor_count
    assert spec.fp32_ops == spec.sms * 128 * roofline.DATA_SHEETS[props.name][0]
    assert spec.hbm_bw > 1e12 and spec.tc_bf16_flops > 5e14


def test_roofline_fractions_on_the_card(dev):
    """measure() at a cut size (the fractions need no full-size run): every
    roofline fraction and mfu lies in (0, 1]."""
    out = roofline.measure(queries=256, rows=1 << 15, points=1024, gn_rounds=20, frames=16)
    shares = [v for k, v in out.items() if k.endswith(("_roofline_fraction", "_mfu"))]
    assert len(shares) == 4 and all(0.0 < v <= 1.0 for v in shares)
    assert out["spec"]["name"] == torch.cuda.get_device_name(0)
