"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1-K3 and K7 are exact (the distances use the same explicitly
rounded operations in the same order, K2/K3 are selection; K7 filters on
the tensor cores and takes the plain key on what the filter leaves). K4, K5
and K6 add their lane sums in the plain versions' order, both sides use a
correctly rounded sqrt and the card's sin/cos, so their poses are held to
1e-5 (bitwise expected). K8 equals K4/K5 per sequence exactly (the same ``__global__``),
K10 is a copy and exact, K11 sums in its plain version's order (1e-5 of the
largest entry, bitwise expected), K9 sums in one fixed order that its plain
version repeats: exact, and the same bits in every launch. P1 (both
instances, every output) is exact: its plain versions repeat its arithmetic
op for op. P2 (the map fold) selects and copies: exact. utils/selfcheck's
checks hold their own tolerances (the JAX package's), and utils/roofline's
fractions lie in (0, 1].
"""

import ast
import ctypes
import subprocess
import time
import traceback
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops import se3
from visual_odometry_tpu_torch.ops.camera import project_points
from visual_odometry_tpu_torch.models import landmark_map
from visual_odometry_tpu_torch.ops.kernels import (
    epipolar_kernel, frame_kernel, gather_kernel, matcher_kernel, picp_kernel, segsum_kernel,
)
from visual_odometry_tpu_torch.parallel import multiseq, posegraph, sparse_ba
from visual_odometry_tpu_torch.utils import profiling, roofline, selfcheck, synthetic
from visual_odometry_tpu_torch.utils.config import VOConfig
from visual_odometry_tpu_torch.utils.convert import to_device

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
    rounds = []
    got = frame_kernel.track_frames(*args, *call, rounds_out=rounds, **kw)
    assert _lib.launches["track_frames"] == 1
    ref = frame_kernel.track_frames(*args, *call, backend="torch", rounds_out=rounds, **kw)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K4 kernel vs plain, S={slots} {opts}: max |dpose| = {err}")
    assert err <= 1e-5
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[3][:, 2:], ref[3][:, 2:])
    assert rounds[0].dtype == torch.int32 and torch.equal(rounds[0], rounds[1])


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
    rounds = []
    got = frame_kernel.track_frames(*args, *call, rounds_out=rounds, **kw)
    assert _lib.launches["track_frames_planar"] == 1 and _lib.launches["track_frames"] == 0
    ref = frame_kernel.track_frames(*args, *call, backend="torch", rounds_out=rounds, **kw)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K5 kernel vs plain, S={slots} {opts}: max |dpose| = {err}")
    assert bool(torch.isfinite(got[0]).all()) and err <= 1e-5
    assert torch.equal(got[2], ref[2])
    assert torch.equal(got[3][:, 2:], ref[3][:, 2:])
    assert torch.equal(rounds[0], rounds[1])


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
    rounds = []
    pose, stats = fn(*args, min_num_inliers=min_inl, rounds_out=rounds)
    assert _lib.launches[name] == 1
    pose_p, stats_p = fn(*args, min_num_inliers=min_inl, backend="torch", rounds_out=rounds)
    assert rounds[0].dtype == torch.int32 and int(rounds[0]) == rounds[1]
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
    modes report the pairs they rescored."""
    q, qm, db, dbm = (torch.from_numpy(x).to(dev) for x in synthetic.generate_match_ties(
        np.random.default_rng(3), 1024, nk))
    for mask in (dbm, torch.zeros_like(dbm)):
        for fast in (False, True):
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            dist, idx = matcher_kernel.best_match_cuda(q, qm, db, mask, fast, survivors=counter)
            dist_p, idx_p = matcher_kernel.best_match_plain(q, qm, db, mask, fast=fast)
            assert torch.equal(idx, idx_p) and torch.equal(dist, dist_p)
            rescored = int(counter.item())
            if not bool(mask.any()):
                assert rescored == 0
            else:   # both modes filter on the tensor cores against a seeded threshold
                assert 1024 <= rescored <= 1024 * 256
    assert bool((idx == 0).all())


@pytest.mark.parametrize("route", ["filter", "scan"])
@pytest.mark.parametrize("nq,nk", [(64, 4096), (130, 300), (1024, 65536)])
def test_best_match_exact_on_exact_ties(dev, monkeypatch, nq, nk, route):
    """K7's exact mode on both routes at each shape: the tensor-core filter
    (the bf16-split gram, its proven interval, the plain key on the
    survivors) and the FP32 scan (matcher_kernel.fp32_scan; forced either way
    through EXACT_SCAN_PAIRS), on synthetic.generate_exact_match_ties: rows
    one ulp apart, negative keys that differ, duplicates a tile and a split
    apart, bf16's subnormal edge, norms that overflow, NaN and inf rows; then
    with every row masked. Indices and distances bitwise against the plain
    version, one launch a call, the filter's rescored pairs counted (the
    scan rescores none)."""
    monkeypatch.setattr(matcher_kernel, "EXACT_SCAN_PAIRS", 0 if route == "filter" else 1 << 62)
    q, qm, db, dbm = (torch.from_numpy(x).to(dev) for x in synthetic.generate_exact_match_ties(
        np.random.default_rng(nq), nq, nk))
    for mask in (dbm, torch.zeros_like(dbm)):
        counter = torch.zeros(1, dtype=torch.int64, device=dev)
        _lib.reset_launches()
        dist, idx = matcher_kernel.best_match_cuda(q, qm, db, mask, False, survivors=counter)
        assert _lib.launches["best_match"] == 1
        dist_p, idx_p = matcher_kernel.best_match_plain(q, qm, db, mask)
        assert torch.equal(idx, idx_p) and torch.equal(dist, dist_p)
        rescored = int(counter.item())
        if bool(mask.any()) and route == "filter":
            assert nq <= rescored <= nq * max(256, nk // 16)
        else:
            assert rescored == 0
        assert bool(mask.any()) or bool((idx == 0).all())


@pytest.mark.parametrize("d", [1, 3, 10, 16, 17, 32])
def test_best_match_exact_widths(dev, monkeypatch, d):
    """The exact mode's tensor-core filter at every width it takes: D = 10
    its own instance, the others the run-time instance (KC = ceil(3 D / 16)
    k-chunks, up to six at D = 32, with the shared-memory opt-in above five),
    bitwise against the plain version on generate_exact_match_ties at that
    width."""
    monkeypatch.setattr(matcher_kernel, "EXACT_SCAN_PAIRS", 0)
    q, qm, db, dbm = (torch.from_numpy(x).to(dev) for x in synthetic.generate_exact_match_ties(
        np.random.default_rng(d), 512, 1 << 16, dim=d))
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    dist, idx = matcher_kernel.best_match_cuda(q, qm, db, dbm, False, survivors=counter)
    dist_p, idx_p = matcher_kernel.best_match_plain(q, qm, db, dbm)
    assert torch.equal(idx, idx_p) and torch.equal(dist, dist_p)
    assert int(counter.item()) >= 512


@pytest.fixture(scope="module")
def split_gram_probe(tmp_path_factory):
    """tests/csrc/split_gram_probe.cu built with the package's nvcc flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = Path(__file__).parent / "csrc" / "split_gram_probe.cu"
    lib = tmp_path_factory.mktemp("split_gram_probe") / "probe.so"
    res = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", str(src), "-o", str(lib)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr
    fn = ctypes.CDLL(str(lib)).vo_split_gram_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _adversarial_gram_rows(rng, blocks: int, d: int):
    """(16 blocks, d) queries and (8 blocks, d) rows, a third of the blocks
    each: components spread over 2^-30 .. 2^30; one large product and the
    rest 2^-24 .. 2^-14 of it with one sign, which the accumulator's
    alignment truncates; products of about one alternating in sign, which
    cancel."""
    def unit(shape):
        return rng.uniform(1.0, 2.0, shape) * rng.choice([-1.0, 1.0], shape)

    q, k = unit((blocks, 16, d)), unit((blocks, 8, d))
    third = blocks // 3
    spread = slice(0, third)
    q[spread] *= 2.0 ** rng.uniform(-30, 30, q[spread].shape)
    k[spread] *= 2.0 ** rng.uniform(-30, 30, k[spread].shape)
    tail = slice(third, 2 * third)
    q[tail] = np.abs(q[tail])
    k[tail] = np.abs(k[tail]) * 2.0 ** rng.uniform(-24, -14, k[tail].shape)
    k[tail, :, 0] = 16.0 * rng.uniform(1.0, 2.0, k[tail, :, 0].shape)
    cancel = slice(2 * third, blocks)
    q[cancel] *= 2.0 ** rng.uniform(-4, 4, q[cancel].shape)
    sign = np.where(np.arange(d) % 2 == 0, 1.0, -1.0)
    k[cancel] = (sign * rng.uniform(1.0, 2.0, k[cancel].shape)
                 / np.abs(q[cancel][:, :8]) * 2.0 ** rng.uniform(-2, 2, k[cancel].shape))
    return q.reshape(-1, d).astype(np.float32), k.reshape(-1, d).astype(np.float32)


@pytest.mark.parametrize("d", [10, 16, 32])
def test_split_gram_accumulation_within_the_bound(dev, split_gram_probe, d):
    """The premise of csrc/best_match.cu's exact-mode interval, on this card:
    the ceil(3 D / 16) chained m16n8k16 MMAs of the split-bf16 gram
    (hi.hi + mid.hi + hi.mid) end within 96 KC u P_G (1 + 576 u) of the
    exact sum G of the packed products (float64), P_G their absolute sum,
    u = 2^-24, on rows built to trip the accumulation
    (_adversarial_gram_rows)."""
    blocks = 768
    q, k = _adversarial_gram_rows(np.random.default_rng(d), blocks, d)
    out = torch.empty(blocks * 128, dtype=torch.float32, device=dev)
    qd, kd = torch.from_numpy(q).to(dev), torch.from_numpy(k).to(dev)
    code = split_gram_probe(qd.data_ptr(), kd.data_ptr(), out.data_ptr(), blocks, d,
                            torch.cuda.current_stream(dev).cuda_stream)
    assert code == 0
    acc = out.cpu().double().reshape(blocks, 16, 8)

    def terms(x):
        x = torch.from_numpy(x)
        hi = x.to(torch.bfloat16).to(torch.float32)
        mid = (x - hi).to(torch.bfloat16).to(torch.float32)
        return hi.double().reshape(blocks, -1, d), mid.double().reshape(blocks, -1, d)

    (hq, mq), (hk, mk) = terms(q), terms(k)
    prods = [a[:, :, None, :] * b[:, None, :, :] for a, b in ((hq, hk), (mq, hk), (hq, mk))]
    g = sum(p.sum(-1) for p in prods)
    p_g = sum(p.abs().sum(-1) for p in prods)
    u, kc = 2.0 ** -24, -(-3 * d // 16)
    ratio = (acc - g).abs() / (u * p_g)
    print(f"D = {d}, KC = {kc}: max |acc - G| / (u P_G) {float(ratio.max()):.3f}, "
          f"allowed {96 * kc * (1 + 576 * u):.3f}")
    assert bool(torch.isfinite(acc).all())
    assert float(ratio.max()) <= 96 * kc * (1 + 576 * u)


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


def _first_nonfinite(traj):
    """The first frame whose pose has a non-finite entry, or None."""
    bad = torch.nonzero(~torch.isfinite(traj).flatten(1).all(1))
    return int(bad[0, 0]) if bad.numel() else None


@pytest.mark.parametrize("motion", ["six_dof", "planar_robot"])
def test_planar_run_sequence_and_relocalize_cuda(dev, motion):
    """The planar fused path launches K5 and agrees with its plain version;
    on a planar robot's motion map-scale relocalization launches K7 and K6
    and agrees with their plain versions too. On 6-DoF motion, outside the
    subgroup the planar model moves in, the monocular scale collapses and
    the poses may turn non-finite at a frame set by the bootstrap's last
    bits, as in the JAX package from the same bootstrap pose
    (test_torch_planar.py::test_planar_model_on_6dof_motion_collapses_in_both_packages):
    K5 and its plain version agree frame by frame up to their first
    non-finite frame, and it is the same frame."""
    if motion == "six_dof":
        pts, apps, masks = (torch.from_numpy(x).to(dev) for x in synthetic.generate_tracking_sequence(
            np.random.default_rng(1), 24, 128))
        mount = _mount(dev).cpu()
    else:
        pts, apps, masks = (x.to(dev) for x in _planar_robot_sequence(1, 24, 128))
        mount = se3.v2t_euler(torch.tensor(SERVING_MOUNT))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=256).with_planar_mount(mount.numpy())
    _lib.reset_launches()
    traj, m, _ = pipeline.run_sequence(camera, cfg, pts, apps, masks)
    assert _lib.launches["track_frames_planar"] == 1 and _lib.launches["track_frames"] == 0
    plain = cfg.replace(matcher_backend="torch", scan_backend="torch", solver_backend="torch")
    traj_p, m_p, _ = pipeline.run_sequence(camera, plain, pts, apps, masks)
    first = _first_nonfinite(traj)
    assert first == _first_nonfinite(traj_p)
    assert float((traj[:first] - traj_p[:first]).abs().max()) <= 2e-3
    if motion == "six_dof":
        return
    assert first is None
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
    """K8 per sequence against K4/K5 launched alone: every output bit for bit,
    GN rounds included; and against its plain version, whose rounds it counts."""
    batched, singles = _k8_args(dev, count, 12, slots, planar)
    name = "track_frames_batched_planar" if planar else "track_frames_batched"
    _lib.reset_launches()
    got = frame_kernel.track_frames_batched_cuda(*batched)
    assert _lib.launches[name] == 1
    for i, a in enumerate(singles):
        alone = frame_kernel.track_frames_cuda(*a)
        for g, x in zip(got, alone):
            assert torch.equal(g[i], x)
    rounds = []
    ref = frame_kernel.track_frames_batched_plain(*batched, rounds_out=rounds)
    err = float((got[0] - ref[0]).abs().max())
    print(f"K8 kernel vs plain, planar={planar} N={count} S={slots}: max |dpose| = {err}")
    assert err <= 1e-5
    assert torch.equal(got[2], ref[2])
    assert got[4].tolist() == rounds


def test_fleet_gn_rounds_equal_the_plain_loops(dev):
    """At the fleet cell's shape (64 sequences of 128 slots, here 8 frames),
    ``FrameOutput.gn_rounds`` of the batch-aware program from K8 equals the
    plain K8's count (``scan_backend="torch"``) frame by frame."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(100 + i), 8, 128,
                                                 seed_motion=1.0 + 0.05 * i)
            for i in range(64)]
    tensors = tuple(torch.from_numpy(np.stack([q[k] for q in seqs])).to(dev) for k in range(3))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=1024)
    _lib.reset_launches()
    _, _, outs = multiseq.run_sequences_batched(camera, cfg, *tensors)
    assert _lib.launches["track_frames_batched"] == 1
    _, _, plain = multiseq.run_sequences_batched(camera, cfg.replace(scan_backend="torch"),
                                                 *tensors)
    assert _lib.launches["track_frames_batched"] == 1
    assert outs.gn_rounds.shape == (64, 6) and outs.gn_rounds.dtype == torch.int32
    assert torch.equal(outs.gn_rounds, plain.gn_rounds)
    assert float((outs.pose - plain.pose).abs().max()) <= 1e-5


def _host_wait_blocks():
    """(file, first line, last line) of every ``with host_wait(...)`` block
    of the package's sources."""
    blocks = []
    for path in Path(pipeline.__file__).resolve().parents[1].rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.With) and any(
                    isinstance(i.context_expr, ast.Call)
                    and getattr(i.context_expr.func, "id", None) == "host_wait"
                    for i in node.items):
                blocks.append((str(path), node.lineno, node.end_lineno))
    return blocks


@pytest.mark.parametrize("cell", ["ref128.fleet64", "dense1024.seq512", "ref128.single"])
def test_every_sync_of_the_main_path_is_a_host_wait(dev, cell):
    """A benchmark cell's call (``vobench/``: its entry, configuration and
    traffic) under ``torch.cuda.set_sync_debug_mode("warn")``: every
    synchronizing call that ``run_sequence`` / ``run_sequences_batched`` make
    lies in a ``profiling.host_wait`` block of the package, and the host-wait
    counter is the warnings: 7 a single-sequence call, 6 a batch call, none in
    the map fold (P2 waits for nothing; the plain fold's ``torch.unique``
    waited unflagged, test_unique_waits_for_the_card)."""
    from vobench import harness

    c = harness.cell(cell)
    c.traffic["pool_calls"] = 2
    pool = harness.make_pool(c, 3_000_000_019, dev)
    entry = harness.make_entry(c, pool, dev)
    entry(0)
    torch.cuda.synchronize()
    blocks = _host_wait_blocks()
    package = str(Path(pipeline.__file__).resolve().parents[1])
    seen, outside = [], []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frame = [f for f in traceback.extract_stack()[:-1]
                 if f.filename.startswith(package)][-1]
        seen.append(f"{Path(frame.filename).name}:{frame.lineno}")
        if not any(frame.filename == p and lo <= frame.lineno <= hi for p, lo, hi in blocks):
            outside.append(seen[-1])

    profiling.reset_host_waits()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            entry(1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    waits = dict(profiling.host_waits)
    print(f"{cell}: {len(seen)} synchronizing calls {sorted(seen)}; host waits {waits}")
    assert seen and not outside
    assert sum(waits.values()) == len(seen) == (6 if cell == "ref128.fleet64" else 7)
    assert not [site for site in waits if site.startswith("map_fold.")]


def test_unique_waits_for_the_card(dev):
    """``torch.unique(dim=0)`` reads its group count back through a stream
    sync of its own, which the sync debug mode does not flag: the host leaves
    it only after the work queued before it, as it leaves an elementwise op
    at once."""
    keys = torch.randint(0, 50, (4096, 3), dtype=torch.int32, device=dev)
    torch.unique(keys, dim=0, return_inverse=True)
    torch.cuda.synchronize()
    cycles = 100_000_000
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    sleep_s = time.perf_counter() - t0

    def after_sleep(fn):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host_s

    assert after_sleep(lambda: keys + 1) < 0.2 * sleep_s
    assert after_sleep(lambda: torch.unique(keys, dim=0, return_inverse=True)) > 0.8 * sleep_s
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.unique(keys, dim=0, return_inverse=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "called a synchronizing" in str(w.message)]


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
    """The batch-aware program on the card: K1-K3 once a stage, K8 once, P1
    once for the batch's bootstraps, each sequence equal to its own
    run_sequence."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(7 + i), 12, 64)
            for i in range(4)]
    tensors = tuple(torch.from_numpy(np.stack([q[k] for q in seqs])).to(dev) for k in range(3))
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=30)
    _lib.reset_launches()
    traj, maps, outs = multiseq.run_sequences_batched(camera, cfg, *tensors)
    assert (_lib.launches["match_pairs"], _lib.launches["join_candidates"],
            _lib.launches["gather_rows"], _lib.launches["track_frames_batched"],
            _lib.launches["eight_point"]) == (2, 1, 3, 1, 1)
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
    pairs, one K2, three K3, one K8, one P1 and no K4) equal to the loop form
    (K4 and P1 once a chunk) bit for bit: trajectory, map and diagnostics."""
    seq = synthetic.generate_tracking_sequence(np.random.default_rng(0), 64, 128)
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in seq)
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=128, map_capacity=512)
    _lib.reset_launches()
    got = posegraph.run_sequence_chunked(camera, cfg, pts, apps, masks, num_chunks=3, overlap=8)
    want = {"match_pairs": 3, "join_candidates": 1, "gather_rows": 3, "track_frames_batched": 1,
            "track_frames": 0, "eight_point": 1}
    assert {k: _lib.launches[k] for k in want} == want
    _lib.reset_launches()
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    starts, length, _ = posegraph._plan(cfg, pts, apps, masks, ids, False, 3, 8, None)
    chunked = [posegraph._chunk(x, starts, length) for x in (pts, apps, masks, ids)]
    loop = posegraph._track_and_stitch(camera, cfg, *chunked, starts, length, pts.shape[0],
                                       False, batched=False)
    assert _lib.launches["track_frames"] == 3 and _lib.launches["track_frames_batched"] == 0
    assert _lib.launches["eight_point"] == 3
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


# --------------------------------------------------------------------------
# The multi-device forms on the card (parallel/mesh): each rank imports this
# module to find its body.
# --------------------------------------------------------------------------


def _mesh_match_inputs(nq: int = 256, nk: int = 1 << 16):
    """Queries near rows of a random database (a tenth of the rows masked, NaN
    in them), with an exact duplicate of row 5 in the last block."""
    rng = np.random.default_rng(3)
    db = rng.uniform(-1.0, 1.0, (nk, 10)).astype(np.float32)
    q = (db[rng.permutation(nk)[:nq]] + rng.normal(0, 1e-3, (nq, 10))).astype(np.float32)
    db_mask = rng.uniform(size=nk) > 0.1
    db_mask[[5, nk - 1]] = True
    db[nk - 1] = db[5]
    q[0] = db[5]
    db[~db_mask] = np.nan
    return q, rng.uniform(size=nq) > 0.05, db, db_mask


def _mesh_serving_inputs():
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(7 + i), 12, 64)
            for i in range(4)]
    return tuple(np.stack([s[k] for s in seqs]) for k in range(3))


def _sharded_match(mesh, q, qm, db, dbm):
    from visual_odometry_tpu_torch.parallel import matcher

    return matcher.sharded_best_match(
        mesh, *(matcher.shard_rows(mesh, torch.from_numpy(x)) for x in (db, dbm)),
        *(matcher.replicate(mesh, torch.from_numpy(x)) for x in (q, qm)))


def _world_of_one_rank(match, serving):
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(1, device="cuda")
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=30)
    cam = synthetic.deep_camera(device=mesh.device)
    served = multiseq.run_sequences_batched(
        cam, cfg, *(torch.from_numpy(x).to(mesh.device) for x in serving), mesh=mesh)
    return dict(backend=mesh.backend, staged=mesh.staged_bytes, served=served,
                match=_sharded_match(mesh, *match))


def _shared_card_rank(match):
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.single_axis_mesh(name="lm", device="cuda", backend="gloo")
    _lib.reset_launches()
    out = _sharded_match(mesh, *match)
    return dict(match=out, staged=mesh.staged_bytes, launches=_lib.launches["best_match"])


def _unsharded_match(dev, q, qm, db, dbm):
    from visual_odometry_tpu_torch.ops import matching

    dist, idx = matching.best_match(*(torch.from_numpy(x).to(dev) for x in (q, qm, db, dbm)))
    accept = torch.from_numpy(qm).to(dev) & (dist < torch.tensor(0.1, device=dev) ** 2)
    return torch.where(accept, idx, -1).cpu(), dist.cpu()


def test_world_of_one_nccl_rank_equals_unsharded(dev):
    """A one-rank NCCL world: the sharded matcher (K7) and dp serving (K1-K3,
    K8) on a 1 x 1 mesh equal their unsharded calls bit for bit."""
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod

    _lib.library()            # built here once; the rank only loads it
    match, serving = _mesh_match_inputs(), _mesh_serving_inputs()
    res, = mesh_mod.run_local(_world_of_one_rank, 1, match, serving, device="cuda",
                              timeout=300.0)
    assert res["backend"] == "nccl" and res["staged"] == 0
    idx, dist = _unsharded_match(dev, *match)
    assert torch.equal(res["match"][0], idx) and torch.equal(res["match"][1], dist)
    assert int(idx[0]) == 5
    cfg = VOConfig(n_slots=64, map_capacity=256, gn_iterations=30)
    ref = multiseq.run_sequences_batched(synthetic.deep_camera(device=dev), cfg,
                                         *(torch.from_numpy(x).to(dev) for x in serving))
    got = [res["served"][0], *res["served"][1], *res["served"][2]]
    want = [ref[0], *ref[1], *ref[2]]
    assert all(torch.equal(a, b.cpu()) for a, b in zip(got, want))


def test_two_gloo_ranks_share_the_card_for_the_matcher(dev):
    """Two ranks on one card over gloo (NCCL refuses two ranks a card): each
    launches K7 on its half of the rows, the collectives run on host copies,
    and the result equals one unsharded call bit for bit."""
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod

    _lib.library()
    match = _mesh_match_inputs()
    ranks = mesh_mod.run_local(_shared_card_rank, 2, match, backend="gloo", device="cuda",
                               timeout=300.0)
    idx, dist = _unsharded_match(dev, *match)
    for res in ranks:
        assert res["launches"] == 1 and res["staged"] > 0
        assert torch.equal(res["match"][0], idx) and torch.equal(res["match"][1], dist)


# parallel/scaling and the graft entry on the card.


def test_scaling_in_two_gloo_ranks_on_the_card(dev):
    """dp, sp and lm in a world of one and a world of two gloo ranks sharing
    the card: dp partitions exactly, sp within its overlap bound, lm at 0.9 or
    more; every rank returns the same dp and sp results, and dp's equal the
    world of one's bit for bit. The rows count K8 on the card (the CPU's
    loop form counts K4)."""
    from visual_odometry_tpu_torch.parallel import scaling

    _lib.library()
    ws = [scaling.workload(scaling.DP, seqs_total=4, frames=12, n_slots=64, gn_iterations=10,
                           reps=1),
          scaling.workload(scaling.SP, frames=64, n_slots=64, overlap=6, gn_iterations=10, reps=1),
          scaling.workload(scaling.LM, frames=32, num_landmarks=4096, cg_iterations=8, reps=1,
                           packed=True)]
    rows = scaling.measure_workloads((1, 2), ws, device="cuda")
    by = {(r["metric"], r["n_devices"]): r for r in rows}
    assert len(by) == 6
    assert by[(scaling.DP, 2)]["partition_efficiency"] >= 0.95
    assert by[(scaling.LM, 2)]["partition_efficiency"] >= 0.9
    sp1, sp2 = by[(scaling.SP, 1)], by[(scaling.SP, 2)]
    assert sp2["work_per_device"] <= 1.4 * sp1["work_per_device"] * sp2["chunk_len"] / 64
    assert by[(scaling.DP, 1)]["output_sha256"] == by[(scaling.DP, 2)]["output_sha256"]
    for row in rows:
        assert row["transport"] == "gloo" and row["device"] == torch.cuda.get_device_name(dev)
        assert row.get("ranks_agree", True)
    for tally in by[(scaling.DP, 2)]["tally_by_rank"]:
        assert tally["track_frames_batched"][0] == 1 and "track_frames" not in tally
    assert all(s > 0 for s in by[(scaling.DP, 2)]["staged_bytes"])


def test_work_tally_on_the_card_equals_the_cpu(dev):
    from visual_odometry_tpu_torch.parallel import scaling

    card = scaling.small_call_tally(dev)
    assert card == scaling.small_call_tally("cpu")
    assert {"match_pairs", "join_candidates", "gather_rows", "track_frames", "best_match",
            "segment_sum", "take_table", "picp_solve"} <= set(card)


def _step_on_the_card_and_the_cpu(fn, fn_cpu, state, frame):
    """``fn``'s step on the card's ``state`` and ``fn_cpu``'s (the plain
    versions) on the same state moved to the CPU, K1 and K6 launched once
    each: the pose within K6's 1e-5 and the same inlier count. Returns the
    triangulations' largest difference and the inlier count."""
    _lib.reset_launches()
    pose, tri, inl = fn(state, frame)
    assert _lib.launches["match_pairs"] == 1 and _lib.launches["picp_solve"] == 1
    pose_c, tri_c, inl_c = fn_cpu(to_device(state, "cpu"), to_device(frame, "cpu"))
    assert float((pose.cpu() - pose_c).abs().max()) <= 1e-5
    assert int(inl) == int(inl_c)
    assert bool(torch.isfinite(tri).all())
    return float((tri.cpu() - tri_c).abs().max()), int(inl)


def test_graft_entry_on_the_card_matches_the_cpu(dev):
    """``entry()`` runs on the card by default; its step on the card's state
    equals the plain versions' step on the same state moved to the CPU, the
    triangulations within the parity bound 5e-4."""
    from visual_odometry_tpu_torch import graft_entry

    fn, (state, frame) = graft_entry.entry()
    assert state.x_curr.is_cuda
    fn_cpu, _ = graft_entry.entry(device="cpu")
    tri_err, _ = _step_on_the_card_and_the_cpu(fn, fn_cpu, state, frame)
    assert tri_err <= 5e-4


def test_tracking_step_on_the_card_matches_the_cpu(dev):
    """The entry's step on ``graft_entry.tracking_state``, whose frame tracks
    every slot as an inlier (the entry's own state tracks none, so K6's pose
    there is the identity start on both sides). Its triangulations are not
    held: points near the focus of expansion amplify the pose's last bits
    (tests/test_torch_graft_entry.py::test_tracking_step_matches_jax)."""
    from visual_odometry_tpu_torch import graft_entry

    camera, cfg, state, frame = graft_entry.tracking_state(device=dev)
    cam_c, cfg_c, _, _ = graft_entry.tracking_state(device="cpu")
    _, inliers = _step_on_the_card_and_the_cpu(graft_entry.step_fn(camera, cfg),
                                               graft_entry.step_fn(cam_c, cfg_c), state, frame)
    assert inliers == cfg.n_slots


def _eight_point_batch(dev, count, frames, slots, seed=0):
    """P1's arguments for the bootstrap pairs of ``count`` sequences of
    ``generate_tracking_sequence`` (K1 matches them), and the frames and
    correspondences ``initialize_batched`` takes."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(seed + i), frames, slots)
            for i in range(count)]
    pts, apps, masks = (torch.from_numpy(np.stack([q[k] for q in seqs])).to(dev)
                        for k in range(3))
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    f0, f1 = (pipeline.FrameData(*(x[:, i].contiguous() for x in (pts, apps, masks, ids)))
              for i in (0, 1))
    cfg = VOConfig(n_slots=slots, map_capacity=2 * slots)
    corr = pipeline._batched_match(cfg, False, f1, f0)
    camera = synthetic.deep_camera(device=dev)
    args = (camera.camera_matrix.contiguous(), corr.idx1.contiguous(), corr.idx2.contiguous(),
            corr.valid.contiguous(), f0.points, f1.points, f0.mask, f1.mask)
    return args, (camera, cfg, f0, f1, corr)


def _p1_degenerate(args):
    """Row 0 dead (every mask false), row 1 a NaN in a valid slot, row 2 one
    correspondence on every valid slot, row 3 fewer than 8 correspondences."""
    k, i1, i2, v, p1, p2, m1, m2 = (x.clone() for x in args)
    m1[0], m2[0], v[0] = False, False, False
    live = torch.nonzero(v[1])[:, 0]
    p1[1, i1[1, live[0]]] = float("nan")
    i1[2] = i1[2, torch.nonzero(v[2])[0, 0]]
    i2[2] = i2[2, torch.nonzero(v[2])[0, 0]]
    v[3, torch.nonzero(v[3])[5:, 0]] = False
    return k, i1, i2, v, p1, p2, m1, m2


@pytest.mark.parametrize("count,slots,degenerate", [(64, 128, False), (1, 1024, False),
                                                    (4, 1024, False), (8, 128, True)])
def test_eight_point_kernel_equals_plain(dev, count, slots, degenerate):
    """P1 bit for bit against its plain version at path E's, B's and H's
    shapes and on degenerate pairs (dead: the identity, a NaN in a valid
    slot: the identity, one repeated correspondence, fewer than 8); one
    launch a call, two launches with the same bits."""
    args, _ = _eight_point_batch(dev, count, 2, slots)
    if degenerate:
        args = _p1_degenerate(args)
    _lib.reset_launches()
    got = epipolar_kernel.estimate_transform_batched(*args)
    assert _lib.launches["eight_point"] == 1
    again = epipolar_kernel.estimate_transform_batched(*args)
    ref = epipolar_kernel.estimate_transform_batched_plain(*args)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(_bits(got), _bits(again))
    assert bool(torch.isfinite(got).all())
    if degenerate:
        eye = torch.eye(4, device=dev)
        assert torch.equal(got[0], eye) and torch.equal(got[1], eye)


def test_eight_point_batch_invariance(dev):
    """A pair's P1 pose has the same bits alone, in blocks of 16 and 32 and in
    the batch of 64."""
    args, _ = _eight_point_batch(dev, 64, 2, 128, seed=100)
    full = epipolar_kernel.estimate_transform_batched(*args)
    for size in (1, 16, 32):
        parts = [epipolar_kernel.estimate_transform_batched(
            args[0], *(a[i:i + size] for a in args[1:])) for i in range(0, 64, size)]
        assert torch.equal(_bits(torch.cat(parts)), _bits(full)), size


def _seed_args(dev, count, slots, case):
    """P1 bootstrap-instance arguments (the pose's, the second frames'
    appearances, the map capacity, the mount) for ``count`` bootstrap pairs:
    ``plain`` as initialize_batched builds them, ``degenerate`` with
    _p1_degenerate's rows, ``duplicate`` with slot 9 of every pair a copy of
    slot 3 and slot 20 on slot 11's second-frame measurement, ``truncated``
    with a capacity of a quarter of the slots, ``planar`` with a mount."""
    args, (_, cfg, _, f1, _) = _eight_point_batch(dev, count, 2, slots)
    if case == "degenerate":
        args = _p1_degenerate(args)
    if case == "duplicate":
        k, i1, i2, v, *rest = args
        i1, i2, v = i1.clone(), i2.clone(), v.clone()
        i1[:, 9], i2[:, 9], v[:, 9] = i1[:, 3], i2[:, 3], v[:, 3]
        i2[:, 20], v[:, 20] = i2[:, 11], v[:, 11]
        args = (k, i1, i2, v, *rest)
    capacity = slots // 4 if case == "truncated" else cfg.map_capacity
    mount = _mount(dev).cpu().numpy() if case == "planar" else None
    return args + (f1.appearances, capacity, mount)


def _seed_flat(t):
    return [t] if isinstance(t, torch.Tensor) else [y for x in t for y in _seed_flat(x)]


def _same_seed_bits(a, b):
    for x, y in zip(_seed_flat(a), _seed_flat(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x) if x.is_floating_point() else x,
                           _bits(y) if y.is_floating_point() else y)


@pytest.mark.parametrize("count,slots,case", [
    (64, 128, "plain"), (1, 1024, "plain"), (4, 1024, "plain"), (8, 128, "degenerate"),
    (8, 128, "duplicate"), (8, 128, "truncated"), (8, 128, "planar"), (2, 1024, "truncated")])
def test_eight_point_seed_equals_plain(dev, count, slots, case):
    """P1's bootstrap instance bit for bit against its plain version on every
    output (pose, history, triangulation, map, lookup) at path E's, B's and
    H's shapes and on degenerate pairs, duplicate second-frame measurements,
    a truncated map and a planar mount; one launch a call, two launches with
    the same bits; its pose equals the pose-only instance's without a mount."""
    args = _seed_args(dev, count, slots, case)
    _lib.reset_launches()
    got = epipolar_kernel.bootstrap_batched(*args)
    assert _lib.launches["eight_point"] == 1
    again = epipolar_kernel.bootstrap_batched(*args)
    ref = epipolar_kernel.bootstrap_batched_plain(*args)
    _same_seed_bits(got, ref)
    _same_seed_bits(got, again)
    assert bool(torch.isfinite(got.x_init).all()) and bool(torch.isfinite(got.history).all())
    if case != "planar":
        assert torch.equal(_bits(got.x_init), _bits(epipolar_kernel.estimate_transform_batched(
            *args[:8])))
    if case == "truncated":
        assert bool((got.map.count == args[9]).all())
    if case == "duplicate":
        rows = torch.arange(count, device=dev)
        live = got.tri_valid[:, 3] & got.tri_valid[:, 9]
        assert bool(live.any())
        assert bool((got.point_lookup[rows, args[2][:, 3].long()][live] == 3).all())


def test_eight_point_seed_batch_invariance(dev):
    """A pair's bootstrap (every output) has the same bits alone, in blocks
    of 16 and 32 and in the batch of 64."""
    *args, apps2, capacity, mount = _seed_args(dev, 64, 128, "plain")
    full = epipolar_kernel.bootstrap_batched(*args, apps2, capacity, mount)
    for size in (1, 16, 32):
        parts = [epipolar_kernel.bootstrap_batched(
            args[0], *(a[i:i + size] for a in args[1:]), apps2[i:i + size], capacity, mount)
            for i in range(0, 64, size)]
        flat = [_seed_flat(p) for p in parts]
        for j, w in enumerate(_seed_flat(full)):
            assert torch.equal(torch.cat([p[j] for p in flat]), w), (size, j)


def test_initialize_batched_makes_no_host_sync(dev):
    """The bootstrap stage on the card is one P1 launch and nothing else, with
    no device-to-host sync (torch.cuda.set_sync_debug_mode("error")), on
    frames cut from (B, F, ...) stacks as the serving path cuts them."""
    seqs = [synthetic.generate_tracking_sequence(np.random.default_rng(i), 3, 128)
            for i in range(16)]
    pts, apps, masks = (torch.from_numpy(np.stack([q[k] for q in seqs])).to(dev)
                        for k in range(3))
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=dev)
    f0, f1 = (pipeline.FrameData(*(x[:, i] for x in (pts, apps, masks, ids))) for i in (0, 1))
    cfg = VOConfig(n_slots=128, map_capacity=256)
    camera = synthetic.deep_camera(device=dev)
    corr = pipeline._batched_match(cfg, False, f1, f0)
    torch.cuda.synchronize()
    _lib.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, x_init = pipeline.initialize_batched(camera, cfg, f0, f1, corr=corr)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _lib.launches["eight_point"] == 1
    assert sum(_lib.launches.values()) == 1
    contiguous = [pipeline.FrameData(*(x.contiguous() for x in f)) for f in (f0, f1)]
    want = pipeline.initialize_batched(camera, cfg, *contiguous, corr=corr)
    _same_seed_bits((state, x_init), want)


def test_initialize_batched_and_fold_batch_invariant(dev):
    """``initialize_batched`` (every state tensor) and the batched
    ``merge_stream`` give each sequence the same bits alone, in blocks of 16
    and 32 and in the batch of 64; ``initialize`` of one pair equals its row."""
    _, (camera, cfg, f0, f1, corr) = _eight_point_batch(dev, 64, 2, 128, seed=100)
    state, x_init = pipeline.initialize_batched(camera, cfg, f0, f1, corr=corr)

    def flat(t):
        return [t] if isinstance(t, torch.Tensor) else [y for x in t for y in flat(x)]

    want = flat((state, x_init))
    for size in (1, 16, 32):
        parts = []
        for i in range(0, 64, size):
            cut = [type(t)(*(x[i:i + size] for x in t)) for t in (f0, f1, corr)]
            parts.append(flat(pipeline.initialize_batched(camera, cfg, *cut[:2], corr=cut[2])))
        for j, w in enumerate(want):
            assert torch.equal(torch.cat([p[j] for p in parts]), w), (size, j)
    alone, x0 = pipeline.initialize(camera, cfg, *(type(t)(*(x[5] for x in t)) for t in (f0, f1)),
                                    corr=type(corr)(*(x[5] for x in corr)))
    assert torch.equal(x0, x_init[5])
    assert all(torch.equal(a, b[5]) for a, b in zip(flat(alone), flat(state)))

    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, (64, 160, 10)).astype(np.float32)
    apps = np.take_along_axis(table, rng.integers(0, 160, (64, 4000))[..., None], axis=1)
    streams = [torch.from_numpy(x).to(dev) for x in (
        rng.normal(size=(64, 4000, 3)).astype(np.float32), apps,
        rng.uniform(size=(64, 4000)) > 0.2)]
    folded = landmark_map.merge_stream(*streams, 128)
    for size in (1, 16, 32):
        parts = [landmark_map.merge_stream(*(x[i:i + size] for x in streams), 128)
                 for i in range(0, 64, size)]
        for j, w in enumerate(folded):
            assert torch.equal(torch.cat([p[j] for p in parts]), w), (size, j)


def _fold_streams(dev, b, t, keys, seed=0, live=0.8):
    """B streams of T rows, each re-observing a field of ``keys`` appearance
    keys of its own (an entry's point changes with every observation), a row
    in five masked: (points, appearances, mask) on the card, one stream
    without its batch axis at B = 1 (as ``run_sequence`` folds it)."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (b, keys, 10)).astype(np.float32)
    apps = np.take_along_axis(table, rng.integers(0, keys, (b, t))[..., None], axis=1)
    streams = [torch.from_numpy(x).to(dev) for x in (
        rng.normal(size=(b, t, 3)).astype(np.float32), apps, rng.uniform(size=(b, t)) < live)]
    return [x[0] for x in streams] if b == 1 else streams


def _same_fold(got, want):
    """The four outputs hold the same bits (float outputs compared as int32,
    so NaN keys compare too)."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.is_floating_point():
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,t,h,keys,capacity", [
    (1, 15_360, 128, 1_000, 1024),      # ref128.single: 128 + 119 x 128 rows
    (64, 15_360, 128, 1_000, 1024),     # ref128.fleet64
    (1, 523_264, 1024, 7_500, 2048),    # dense1024.seq512: 1,024 + 510 x 1,024 rows, overflows
])
def test_map_fold_kernel_equals_plain_at_the_cells_shapes(dev, b, t, h, keys, capacity):
    """P2 (``merge_stream`` on the card) against the plain fold on the same
    card tensors at the benchmark cells' stream shapes, the stream whole and
    as the pipeline hands it over (the bootstrap's H rows as its head): one
    launch, the same bits in all four outputs, every call alike."""
    streams = _fold_streams(dev, b, t, keys)
    axis = streams[2].dim() - 1
    head = tuple(x.narrow(axis, 0, h).contiguous() for x in streams)
    body = [x.narrow(axis, h, t - h).contiguous() for x in streams]
    _lib.reset_launches()
    got = landmark_map.merge_stream(*body, capacity, head=head)
    assert _lib.launches["map_fold"] == 1 and sum(_lib.launches.values()) == 1
    want = landmark_map.merge_stream(*streams, capacity, backend="torch")
    _same_fold(got, want)
    _same_fold(landmark_map.merge_stream(*streams, capacity, backend="cuda"), want)
    _same_fold(landmark_map.merge_stream(*body, capacity, backend="torch", head=head), want)
    assert int(got.count.min()) == min(keys, capacity)   # every key seen; dense overflows


def _fold_case(dev, case):
    """(points, appearances, mask, capacity) of an edge case of the fold."""
    rng = np.random.default_rng(7)
    b, t, keys, capacity = 4, 3000, 200, 128
    table = rng.uniform(-1, 1, (keys, 10)).astype(np.float32)
    idx = rng.integers(0, keys, (b, t))
    mask = rng.uniform(size=(b, t)) < 0.8
    if case == "capacity_reached":     # every key is seen: exactly `capacity` groups
        keys = capacity = 64
        idx %= keys
    elif case == "capacity_1":
        capacity = 1
    elif case == "all_masked":
        mask[:] = False
    elif case == "one_sequence_masked":
        mask[2] = False
    elif case == "tile_edges":         # rows 1,023-1,025 straddle two tiles
        t, idx, mask = 1025, idx[:, :1025], mask[:, :1025]
    elif case == "one_row":
        t, idx, mask = 1, idx[:, :1], np.ones((b, 1), bool)
    elif case == "repeat_in_frame":    # room for all 201 groups
        capacity = 256
    apps = table[idx]
    if case == "repeat_in_frame":      # a new key ten times in a 128-row frame: the last wins
        apps[:, 256:266] = rng.uniform(2, 3, 10).astype(np.float32)
        mask[:, 256:266] = True
    elif case == "signed_zero":
        table[:8, :5] = 0.0
        apps = table[idx]
        apps[:, ::3, :5] = -0.0
    elif case == "nan_keys":
        nans = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7FFFFFFF, 0xFF800001],
                        np.uint32).view(np.float32)
        rows = rng.random((b, t)) < 0.3
        apps[rows, rng.integers(0, 10, int(rows.sum()))] = nans[rng.integers(0, 5, int(rows.sum()))]
    elif case == "last_bit":           # keys 2k and 2k + 1 differ in the last word's low bit
        table[1::2] = table[0::2]
        table[1::2, 9] = (table[1::2, 9].view(np.uint32) ^ 1).view(np.float32)
        apps = table[idx]
    pts = rng.normal(size=(b, t, 3)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (pts, apps, mask)], capacity


@pytest.mark.parametrize("case", ["all_masked", "one_sequence_masked", "capacity_reached",
                                  "capacity_1", "repeat_in_frame", "signed_zero", "nan_keys",
                                  "last_bit", "tile_edges", "one_row"])
def test_map_fold_kernel_edge_cases(dev, case):
    """P2 against the plain fold on the card, bit for bit, on the fold's edge
    cases: batched, with a third of the rows as the head segment, and each
    sequence alone."""
    streams, capacity = _fold_case(dev, case)
    got = landmark_map.merge_stream(*streams, capacity)
    _same_fold(got, landmark_map.merge_stream(*streams, capacity, backend="torch"))
    h = streams[2].shape[1] // 3       # a third of the rows as the head (none for one row)
    _same_fold(landmark_map.merge_stream(*(x[:, h:] for x in streams), capacity,
                                         head=tuple(x[:, :h] for x in streams)), got)
    for i in range(streams[0].shape[0]):
        alone = landmark_map.merge_stream(*(x[i] for x in streams), capacity)
        _same_fold(alone, [x[i] for x in got])
    if case in ("all_masked", "one_sequence_masked"):
        gone = slice(None) if case == "all_masked" else 2
        assert not got.valid[gone].any() and int(got.count[gone].max()) == 0
        assert bool(torch.isinf(got.appearances[gone]).all())
        assert not bool(got.points[gone].abs().max())
    if case == "capacity_reached":
        assert got.count.tolist() == [capacity] * 4 and bool(got.valid.all())
    if case == "repeat_in_frame":
        slot = (got.appearances == streams[1][:, 256:257]).all(-1) & got.valid
        assert slot.sum(1).tolist() == [1] * 4
        assert torch.equal(got.points[slot], streams[0][:, 265])


def test_map_fold_makes_no_host_wait(dev):
    """A card ``merge_stream`` makes no synchronizing call (the sync debug
    mode raises on one) and counts no host wait."""
    streams = _fold_streams(dev, 64, 15_360, 1_000)
    landmark_map.merge_stream(*streams, 1024)      # the library is built and loaded
    torch.cuda.synchronize()
    profiling.reset_host_waits()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = landmark_map.merge_stream(*streams, 1024)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not profiling.host_waits
    _same_fold(out, landmark_map.merge_stream(*streams, 1024, backend="torch"))
