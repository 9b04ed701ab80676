"""The plain PyTorch versions of kernels K1-K4 against the JAX package's Pallas
kernels run through the Pallas interpreter, on the CPU.

Tolerances: exact for match indices, join candidates and gathers (pure
selection); 1e-5 relative (1e-5 absolute floor) for K1 distances (same gram
formula, different summation order); 1e-4 for K4 poses (the fused interpreter runs the same
per-frame arithmetic with other f32 reduction orders). K4 runs on a
wide-orbit sequence (seed_motion=6): at the default motion the per-frame
baseline is so short that the monocular triangulation chain amplifies
ulp-level differences to ~1e-3 within ten frames, in either package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.ops.pallas import frame_kernel as jfk
from visual_odometry_tpu.ops.pallas import gather_kernel as jgk
from visual_odometry_tpu.ops.pallas import matcher_kernel as jmk
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops.kernels import frame_kernel as tfk
from visual_odometry_tpu_torch.ops.kernels import gather_kernel as tgk
from visual_odometry_tpu_torch.ops.kernels import matcher_kernel as tmk


def T(x):
    return torch.from_numpy(np.array(x))


def test_match_pairs_plain_matches_pallas(rng):
    """Both directions, with NaN garbage in masked slots, duplicate rows
    (first-index tie-break) and one all-masked frame (index 0, 3.4e38)."""
    b, n, d = 7, 64, 10
    a1 = rng.uniform(-1, 1, (b, n, d)).astype(np.float32)
    a2 = a1[:, rng.permutation(n)] + rng.normal(0, 0.02, (b, n, d)).astype(np.float32)
    m1 = rng.uniform(size=(b, n)) > 0.2
    m2 = rng.uniform(size=(b, n)) > 0.2
    m1[3] = False
    a1[~m1] = np.nan
    a2[~m2] = np.nan
    a2[:, 5] = a2[:, 3]
    m2[:, 5] = m2[:, 3]
    ref = jmk.match_pairs_pallas(jnp.asarray(a1), jnp.asarray(m1), jnp.asarray(a2),
                                 jnp.asarray(m2), interpret=True)
    got = tmk.match_pairs(T(a1), T(m1), T(a2), T(m2))
    for r, g in zip(ref[1::2], got[1::2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # The gram form cancels: the error scales with |a|^2 + |b|^2 (~3 here),
    # not with the distance, hence an absolute floor.
    for r, g in zip(ref[0::2], got[0::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    assert (got[1][3] == 0).all() and (got[0][3] == np.float32(3.4e38)).all()


def test_join_candidates_plain_matches_pallas(rng):
    """Duplicate targets up to multiplicity 4 against depth 2: the chains and
    the overflow flag are exact."""
    f, s, depth = 6, 128, 2
    src = rng.integers(0, 40, (f, s)).astype(np.int32)
    dst = rng.integers(0, 48, (f, s)).astype(np.int32)
    sv = rng.uniform(size=(f, s)) > 0.3
    dv = rng.uniform(size=(f, s)) > 0.3
    ref = jfk.join_candidates(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst),
                              jnp.asarray(dv), depth, interpret=True)
    got = tfk.join_candidates(T(src), T(sv), T(dst), T(dv), depth)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.lo + 128 * ref.hi))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(ref.overflow))
    assert got.overflow.any() and got.ok[:, 1].any()


def test_gather_rows_plain_matches_pallas(rng):
    """Indices come pre-sanitized to [0, S) (the pipeline maps invalid lanes to 0)."""
    for f, r, s in ((5, 4, 64), (2, 10, 256)):
        src = rng.normal(size=(f, r, s)).astype(np.float32)
        idx = rng.integers(0, s, (f, r, s)).astype(np.int32)
        ref = jgk.gather_rows(jnp.asarray(src), jnp.asarray(idx), interpret=True)
        np.testing.assert_array_equal(tgk.gather_rows(T(src), T(idx)).numpy(), np.asarray(ref))
    a = rng.integers(0, 1000, (4, 128)).astype(np.int32)
    i = rng.integers(0, 128, (4, 128)).astype(np.int32)
    (ga,) = tgk.take_lanes([T(a)], [T(i)])
    assert ga.dtype == torch.int32
    np.testing.assert_array_equal(ga.numpy(), np.take_along_axis(a, i, 1))


def _k4_inputs(frames, slots, seed_motion=6.0):
    """The fused path's K4 inputs, built by the JAX pipeline's own stages."""
    pts, apps, masks = jsyn.generate_tracking_sequence(
        np.random.default_rng(0), frames, slots, seed_motion=seed_motion)
    cam = jsyn.deep_camera()
    cfg = JaxConfig(n_slots=slots, matcher_backend="pairs_pallas_interpret")
    P, A, M = jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(masks)
    ids = jnp.full(masks.shape, -1, jnp.int32)
    f0 = jpipe.FrameData(P[0], A[0], M[0], ids[0])
    f1 = jpipe.FrameData(P[1], A[1], M[1], ids[1])
    corr01 = jpipe._match(cfg, False, f0, f1)
    state, _ = jpipe.initialize(cam, cfg, f0, f1, corr=corr01)
    rest = jpipe.FrameData(P[2:], A[2:], M[2:], ids[2:])
    prev = jpipe.FrameData(P[1:-1], A[1:-1], M[1:-1], ids[1:-1])
    corr = jpipe._batched_match(cfg, False, rest, prev)
    cand = jfk.join_candidates(
        jnp.concatenate([corr01.idx2[None], corr.idx2[:-1]]),
        jnp.concatenate([corr01.valid[None], corr.valid[:-1]]),
        corr.idx1, corr.valid, 2, interpret=True)
    s1 = jnp.where(corr.valid, corr.idx1, 0)
    s2 = jnp.where(corr.valid, corr.idx2, 0)
    prev_al = jnp.stack([jnp.take_along_axis(prev.points[..., c], s1, 1) for c in (0, 1)], -1)
    cur_al = jnp.stack([jnp.take_along_axis(rest.points[..., c], s2, 1) for c in (0, 1)], -1)
    cp = jnp.stack([cam.z_near, cam.z_far, cam.cols, cam.rows])
    jax_args = (cam.camera_matrix, cp, state.x_curr, state.tri_points, state.tri_valid, cand,
                prev_al, cur_al, corr.valid)
    torch_args = tuple(T(x) for x in jax_args[:5]) + (
        tfk.JoinCandidates(T(cand.lo + 128 * cand.hi).to(torch.int32), T(cand.ok),
                           T(cand.overflow)),
    ) + tuple(T(x) for x in jax_args[6:])
    return jax_args, torch_args


@pytest.mark.parametrize(
    "frames,slots,opts",
    [
        (12, 64, dict(iterations=100, tol=1e-12)),
        (6, 128, dict(iterations=100, tol=1e-12)),
        (5, 64, dict(iterations=12, tol=-1.0, warm_start=True, min_iterations=3)),
        (5, 64, dict(iterations=20, tol=1e-12, kt=2e-3, keep_outliers=True)),
        (4, 64, dict(iterations=20, tol=1e-12, min_inliers=1e6)),
    ],
)
def test_track_frames_plain_matches_pallas(frames, slots, opts):
    """The plain K4 against track_frames_fused(interpret=True): poses within
    1e-4, per-frame inlier counts and solver correspondence counts exact,
    triangulation validity exact. Options: fixed budget with warm start, a
    tight kernel threshold with kept outliers, an inlier floor above S."""
    jax_args, torch_args = _k4_inputs(frames, slots)
    kw = dict(keep_outliers=opts.get("keep_outliers", False),
              warm_start=opts.get("warm_start", False),
              min_num_inliers=opts.get("min_inliers", 0.0),
              min_iterations=opts.get("min_iterations", 1))
    kt = opts.get("kt", 1e4)
    ref = jfk.track_frames_fused(*jax_args, opts["iterations"], jnp.float32(kt),
                                 jnp.float32(1.0), jnp.float32(opts["tol"]), interpret=True, **kw)
    got = tfk.track_frames(*torch_args, opts["iterations"], kt, 1.0, opts["tol"], **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3][:, 2:].numpy(), np.asarray(ref[3])[:, 2:])
    np.testing.assert_allclose(got[3][:, :2].numpy(), np.asarray(ref[3])[:, :2],
                               rtol=1e-2, atol=1e-3)
    tri_ref = np.asarray(ref[1])
    assert (np.abs(got[1].numpy() - tri_ref) <= 1e-3 * (1.0 + np.abs(tri_ref))).all()


def test_block_sum_matches_a_float64_sum(rng):
    rows = torch.from_numpy(rng.normal(size=(30, 1000)).astype(np.float32))
    np.testing.assert_allclose(tfk._block_sum(rows).numpy(), rows.double().sum(1).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_wrappers_never_fall_back():
    """A CPU tensor reaches the plain version only under auto/torch; the
    cuda backend and the kernel entry points raise instead of falling back."""
    x = torch.zeros((1, 32, 10))
    m = torch.ones((1, 32), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tmk.match_pairs(x, m, x, m, backend="cuda")
    with pytest.raises(ValueError):
        tmk.match_pairs(x, m, x, m, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tmk.match_pairs_cuda(x, m, x, m)
    i = torch.zeros((2, 32), dtype=torch.int32)
    b = torch.zeros((2, 32), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.join_candidates(i, b, i, b, 2, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tgk.gather_rows_cuda(torch.zeros((1, 1, 4)), torch.zeros((1, 1, 4), dtype=torch.int32))
    _lib.reset_launches()
    tmk.match_pairs(x, m, x, m)
    assert all(v == 0 for v in _lib.launches.values())
