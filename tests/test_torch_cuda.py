"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Every test here needs the card and skips without one. The file imports
neither JAX nor tests/conftest.py's fixtures, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1-K3 are exact (K1's distances use the same explicitly rounded
operations in the same order, K2/K3 are selection). K4 adds its lane sums in
the plain version's order, both use a correctly rounded sqrt and the card's
sin/cos, so its poses are held to 1e-5 over a dozen frames (bitwise expected).
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops.kernels import frame_kernel, gather_kernel, matcher_kernel
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
    corr01 = pipeline._match(cfg, f0, f1)
    state, _ = pipeline.initialize(camera, cfg, f0, f1, corr=corr01)
    rest = pipeline.FrameData(pts[2:], apps[2:], masks[2:], ids[2:])
    prev = pipeline.FrameData(pts[1:-1], apps[1:-1], masks[1:-1], ids[1:-1])
    corr = pipeline._batched_match(cfg, rest, prev)
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
    assert all(n > 0 for n in _lib.launches.values()), _lib.launches
    traj_p, m_p, outs_p = pipeline.run_sequence(
        camera, cfg.replace(matcher_backend="torch", scan_backend="torch"), pts, apps, masks)
    assert float((traj - traj_p).abs().max()) <= 2e-3
    assert torch.equal(m.appearances, m_p.appearances)
    assert torch.equal(outs.num_solver_corr, outs_p.num_solver_corr)
