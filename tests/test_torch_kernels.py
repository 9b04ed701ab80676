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


def _wild_join_inputs(rng, f, s):
    """Targets in [-3, S + 3) on both sides, so some valid and some invalid
    lanes point outside [0, S); multiplicities up to ~8 over S / 12 targets."""
    src = rng.integers(0, s // 12, (f, s)).astype(np.int32)
    dst = rng.integers(-3, s // 10, (f, s)).astype(np.int32)
    src[:, ::9] = rng.integers(s, s + 3, src[:, ::9].shape)
    src[:, 4::11] = -2
    dst[:, 2::13] = rng.integers(s, s + 3, dst[:, 2::13].shape)
    return src, rng.uniform(size=(f, s)) > 0.25, dst, rng.uniform(size=(f, s)) > 0.25


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_join_candidates_plain_matches_pallas_out_of_range(rng, depth):
    """Targets outside [0, S) on valid and invalid lanes, at depth 1, 2 and
    4: the port's plain version compares them as the Pallas kernel does."""
    src, sv, dst, dv = _wild_join_inputs(rng, 5, 128)
    ref = jfk.join_candidates(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst),
                              jnp.asarray(dv), depth, interpret=True)
    got = tfk.join_candidates(T(src), T(sv), T(dst), T(dv), depth)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.lo + 128 * ref.hi))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(ref.overflow))
    far = (dst < 0) | (dst >= 128)
    assert (got.ok[:, 0].numpy() & far).any() and got.overflow.any()


def _join_tables(src, sv, dst, dv, depth):
    """csrc/join_candidates.cu's algorithm in numpy: per-target level tables
    built by minima over the valid source lanes above the previous level, a
    lookup per current lane, and a scan for targets outside [0, S)."""
    f, s = src.shape
    idx = np.zeros((f, depth, s), np.int32)
    ok = np.zeros((f, depth, s), bool)
    over = np.zeros((f, s), bool)
    for i in range(f):
        inside = sv[i] & (src[i] >= 0) & (src[i] < s)
        prev = np.full(s, -1)
        for k in range(depth + 1):
            level = np.full(s, s)
            for j in np.flatnonzero(inside):
                t = src[i, j]
                if j > prev[t]:
                    level[t] = min(level[t], j)
            for jp in range(s):
                t = dst[i, jp]
                if not dv[i, jp] or t < 0 or t >= s or level[t] == s:
                    continue
                if k < depth:
                    idx[i, k, jp], ok[i, k, jp] = level[t], True
                else:
                    over[i, jp] = True
            prev = level
        for jp in np.flatnonzero(dv[i] & ((dst[i] < 0) | (dst[i] >= s))):
            hits = np.flatnonzero(sv[i] & (src[i] == dst[i, jp]))
            idx[i, :min(depth, hits.size), jp] = hits[:depth]
            ok[i, :min(depth, hits.size), jp] = True
            over[i, jp] = hits.size > depth
    return idx, ok, over


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_join_tables_equal_plain(rng, depth):
    """The card kernel's table algorithm, emulated, gives the plain version's
    chains and flags exactly (the kernel itself is held to the plain version
    on the card, tests/test_torch_cuda.py)."""
    args = _wild_join_inputs(rng, 4, 96)
    got = _join_tables(*args, depth)
    ref = tfk.join_candidates_plain(*(T(x) for x in args), depth)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


@pytest.mark.parametrize("f,s,d", [(5, 64, 2), (2, 256, 10), (3, 100, 2), (4, 100, 10),
                                   (3, 50, 3)])
def test_gather_rows_plain_matches_pallas(rng, f, s, d):
    """Records (F, S, D) gathered by one index row a frame, against the JAX
    kernel given the same data as (F, D, S) rows and the index repeated over
    D. S = 100 is ragged (under one 128-lane tile); D = 3 is a width the
    pipeline does not use, which the port takes all the same. The port clips
    indices to [0, S - 1]; the JAX kernel needs them pre-sanitized, so it
    gets the clipped ones. Exact."""
    src = rng.normal(size=(f, s, d)).astype(np.float32)
    idx = rng.integers(-4, s + 4, (f, s)).astype(np.int32)
    safe = np.clip(idx, 0, s - 1)
    ref = jgk.gather_rows(jnp.asarray(src.transpose(0, 2, 1)),
                          jnp.asarray(np.repeat(safe[:, None, :], d, axis=1)), interpret=True)
    got = tgk.gather_rows(T(src), T(idx))
    assert got.shape == (f, s, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).transpose(0, 2, 1))


def test_gather_rows_reads_a_batch_slice_in_place(rng):
    """(B, F, S, D) with strided leading axes (the serving batch's frame
    slice) gives what the contiguous copy gives, frame by frame."""
    full = T(rng.normal(size=(3, 7, 64, 10)).astype(np.float32))
    idx = T(rng.integers(0, 64, (3, 5, 64)).astype(np.int32))
    got = tgk.gather_rows(full[:, 1:-1], idx)
    ref = tgk.gather_rows(full[:, 1:-1].reshape(15, 64, 10).contiguous(), idx.reshape(15, 64))
    assert got.shape == (3, 5, 64, 10)
    np.testing.assert_array_equal(got.reshape(15, 64, 10).numpy(), ref.numpy())


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


def _transposed_warp_sums(terms: np.ndarray) -> np.ndarray:
    """csrc/gn_loop.cuh warp_sum_terms in numpy float32: terms (32, NPAD) of
    one warp's lanes, NPAD = 32 or 16; returns what lane q holds at the end."""
    t = terms.astype(np.float32).copy()
    lanes = np.arange(32)
    npad = t.shape[1]
    if npad == 16:
        t = t + t[lanes ^ 16]
    o = npad // 2
    while o:
        upper = (lanes & o) != 0
        send = np.where(upper[:, None], t[:, :o], t[:, o:2 * o])
        keep = np.where(upper[:, None], t[:, o:2 * o], t[:, :o])
        t = keep + send[lanes ^ o]
        o //= 2
    return t[:, 0]


@pytest.mark.parametrize("n", [1024, 128, 100])
@pytest.mark.parametrize("nred", [30, 12])
def test_transposed_warp_sum_keeps_the_block_sum_order(rng, n, nred):
    """K4-K6's warp sum is transposed (recursive halving, 31 shuffles a warp
    instead of a shuffle-down tree a term); lane q ends with the tree's sum
    of term q bit for bit, so the kernels' block sum is still _block_sum's:
    the emulation, folded over the warps in warp order, equals it exactly.
    Rows span many magnitudes and hold zeros, as dead lanes do."""
    rows = (rng.normal(size=(nred, n)) * 10.0 ** rng.integers(-6, 7, (nred, n))).astype(np.float32)
    rows[:, ::9] = 0.0
    lanes = min(1024, max(64, -(-n // 32) * 32))
    npad = 32 if nred > 16 else 16
    padded = np.zeros((npad, lanes), np.float32)
    padded[:nred, :n] = rows
    acc = None
    for w in range(lanes // 32):
        part = _transposed_warp_sums(padded[:, 32 * w:32 * w + 32].T)[:nred]
        acc = part if acc is None else (acc + part).astype(np.float32)
    ref = tfk._block_sum(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(acc.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("n,ctas,threads", [
    (300, 2, 256), (1024, 4, 256), (2049, 3, 1024), (8192, 8, 1024), (9000, 8, 1024),
    (8192, 32, 256), (100, 1, 128)])
@pytest.mark.parametrize("nred", [30, 12])
def test_transposed_warp_sum_keeps_the_fold_sum_order(rng, n, ctas, threads, nred):
    """K6 and K11 spread their lanes over CTAs (csrc/picp_solve.cu,
    csrc/picp_linearize.cu): each lane adds its points l, l + L, ... in turn,
    each warp sums transposed, each CTA folds its warps in warp order and the
    CTA partials are folded in CTA order. The emulation of that, in numpy,
    equals frame_kernel._block_sum at that geometry bit for bit."""
    rows = (rng.normal(size=(nred, n)) * 10.0 ** rng.integers(-6, 7, (nred, n))).astype(np.float32)
    rows[:, ::9] = 0.0
    lanes = ctas * threads
    npad = 32 if nred > 16 else 16
    per_lane = -(-n // lanes)
    lane_sums = np.zeros((npad, lanes), np.float32)
    lane_sums[:nred, :min(n, lanes)] = rows[:, :lanes]
    for k in range(1, per_lane):
        chunk = rows[:, k * lanes:(k + 1) * lanes]
        lane_sums[:nred, :chunk.shape[1]] = (lane_sums[:nred, :chunk.shape[1]] + chunk)
    total = None
    for c in range(ctas):
        cta = None
        for w in range(threads // 32):
            lo = c * threads + 32 * w
            part = _transposed_warp_sums(lane_sums[:, lo:lo + 32].T)[:nred]
            cta = part if cta is None else (cta + part).astype(np.float32)
        total = cta if total is None else (total + cta).astype(np.float32)
    ref = tfk._block_sum(torch.from_numpy(rows), ctas, threads).numpy()
    np.testing.assert_array_equal(total.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("n", [1, 7, 100, 1024, 1500, 8193])
def test_fold_sum_on_one_cta_is_block_sum(rng, n):
    """_block_sum's default geometry is the frame kernels' one block of
    min(1024, max(64, N in whole warps)) threads (K4, K5, K8): the same bits
    as at that one-CTA geometry given explicitly, and as a numpy float32
    emulation of that block's order (each thread's points in ascending order,
    a shuffle-down tree a warp, the warps in warp order)."""
    rows = (rng.normal(size=(30, n)) * 10.0 ** rng.integers(-6, 7, (30, n))).astype(np.float32)
    rows[:, ::9] = 0.0
    threads = min(1024, max(64, -(-n // 32) * 32))
    per_thread = -(-n // threads)
    x = np.zeros((30, per_thread * threads), np.float32)
    x[:, :n] = rows
    x = x.reshape(30, per_thread, threads)
    acc = x[:, 0]
    for i in range(1, per_thread):
        acc = acc + x[:, i]
    acc = acc.reshape(30, threads // 32, 32)
    for o in (16, 8, 4, 2, 1):
        acc = acc[..., :o] + acc[..., o:2 * o]
    ref = acc[..., 0, 0]
    for w in range(1, threads // 32):
        ref = ref + acc[:, w, 0]
    got = tfk._block_sum(torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    explicit = tfk._block_sum(torch.from_numpy(rows), 1, threads)
    assert torch.equal(got.view(torch.int32), explicit.view(torch.int32))


def _k1_by_tiles(app1, mask1, app2, mask2, splits=8):
    """K1's scan order in numpy (csrc/match_pairs.cu): each direction's rows
    against column splits in ascending order with a strict '<' from (inf, 0),
    the splits' results met in ascending order, a masked row (3.4e38, 0)."""
    d = tmk.pairwise_sq_dists(torch.from_numpy(app1), torch.from_numpy(app2)).numpy()
    d = np.where(mask1[:, :, None] & mask2[:, None, :], d, np.float32(tmk.BIG))
    outs = []
    for dist, rmask in ((np.swapaxes(d, 1, 2), mask2), (d, mask1)):
        b, n, _ = dist.shape
        chunk = -(-n // splits)
        best = np.full((b, n), np.inf, np.float32)
        arg = np.zeros((b, n), np.int64)
        for w in range(splits):
            sb = np.full((b, n), np.inf, np.float32)
            sa = np.zeros((b, n), np.int64)
            for j in range(w * chunk, min(n, (w + 1) * chunk)):
                take = dist[:, :, j] < sb
                sb = np.where(take, dist[:, :, j], sb)
                sa = np.where(take, j, sa)
            take = sb < best
            best = np.where(take, sb, best)
            arg = np.where(take, sa, arg)
        best = np.where(rmask, best, np.float32(tmk.BIG))
        outs += [best, np.where(rmask, arg, 0)]
    return outs


def test_k1_tiles_and_splits_keep_the_first_index(rng):
    """The split-and-meet order of the redesigned K1 gives the plain version's
    first argmin: ties placed across split and tile boundaries (j and j + 128,
    j and j + 25), an all-masked frame, NaN garbage in masked slots."""
    b, n = 3, 200
    a1 = rng.uniform(-1, 1, (b, n, 10)).astype(np.float32)
    a2 = a1[:, rng.permutation(n)] + rng.normal(0, 0.02, (b, n, 10)).astype(np.float32)
    for j, k in ((3, 131), (10, 35), (60, 188)):
        a1[:, k] = a1[:, j]
        a2[:, k] = a2[:, j]
    m1 = rng.uniform(size=(b, n)) > 0.1
    m2 = rng.uniform(size=(b, n)) > 0.1
    m2[2] = False
    a1[~m1] = np.nan
    a2[~m2] = np.nan
    got = _k1_by_tiles(a1, m1, a2, m2)
    ref = tmk.match_pairs_plain(*(torch.from_numpy(x) for x in (a1, m1, a2, m2)))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())


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
        tgk.gather_rows_cuda(torch.zeros((1, 4, 2)), torch.zeros((1, 4), dtype=torch.int32))
    _lib.reset_launches()
    tmk.match_pairs(x, m, x, m)
    assert all(v == 0 for v in _lib.launches.values())
