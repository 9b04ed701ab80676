"""Sparse bundle adjustment of the port (kernels K9 and K10 through their
plain versions) against the JAX package, on the CPU.

Scenes: the 4-pose, 64-landmark scene of tests/test_sparse_ba.py and the
corridor ``generate_ba_corridor(f=16, l=400)``.

Tolerances: ``take_table`` is a copy, so exact. ``segment_sum_small``: rtol
2e-5, atol 1e-4, the JAX package's own for its kernel (another order of the
float32 sum); against its own documented order, bit for bit. ``generate_ba_corridor``: every field exact except the noisy
poses, within 1e-6 (the two frameworks' float32 sin/cos may differ by an ulp).
One ``sparse_ba_step`` with a fixed CG budget (``cg_tolerance=0``, 10
iterations: both packages run the same matvecs): poses and landmarks within
1e-4, chi within 1e-4 relative. ``build_observations_coo`` equals JAX's
output exactly (a pure join).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import refinement as jref
from visual_odometry_tpu.ops.pallas import gather_kernel as jgk
from visual_odometry_tpu.ops.pallas import segsum_kernel as jsk
from visual_odometry_tpu.parallel import sparse_ba as jsba
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu_torch.models import refinement as tref
from visual_odometry_tpu_torch.ops.kernels import _lib
from visual_odometry_tpu_torch.ops.kernels import gather_kernel as tgk
from visual_odometry_tpu_torch.ops.kernels import segsum_kernel as tsk
from visual_odometry_tpu_torch.parallel import sparse_ba as tsba
from visual_odometry_tpu_torch.utils import convert
from visual_odometry_tpu_torch.utils import synthetic as tsyn

from test_sparse_ba import _problems


def T(x):
    return torch.from_numpy(np.array(x))


def _to_port(jproblem):
    return convert.sparse_ba_problem_from_arrays(
        **{k: np.asarray(v) for k, v in jproblem._asdict().items()})


@pytest.mark.parametrize("r,t,n", [(6, 512, 5000), (3, 100, 257), (8, 1024, 4096)])
def test_take_table_plain_matches_pallas(rng, r, t, n):
    """The three shapes of tests/test_pallas_kernels.py: exact."""
    table = rng.normal(size=(r, t)).astype(np.float32)
    idx = rng.integers(0, t, n).astype(np.int32)
    ref = jgk.take_table(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    got = tgk.take_table(T(table), T(idx))
    assert got.shape == (r, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_take_table_clips_and_takes_twelve_rows(rng):
    """Indices outside [0, T) are clipped to the table's ends, as the TPU
    kernel clips them at a whole-tile T (for a ragged T it clips to its zero
    padding instead, which no caller relies on); 12 rows go in one call (the
    JAX caller needs two of 8 + 4)."""
    table = rng.normal(size=(12, 128)).astype(np.float32)
    idx = np.array([-5, 0, 127, 128, 1000, 7], np.int32)
    got = tgk.take_table(T(table), T(idx)).numpy()
    np.testing.assert_array_equal(got, table[:, np.clip(idx, 0, 127)])
    top = jgk.take_table(jnp.asarray(table[:8]), jnp.asarray(idx), interpret=True)
    bot = jgk.take_table(jnp.asarray(table[8:]), jnp.asarray(idx), interpret=True)
    np.testing.assert_array_equal(got, np.concatenate([np.asarray(top), np.asarray(bot)]))


@pytest.mark.parametrize("r,t,n,transpose_out", [(6, 512, 5000, True), (12, 512, 3000, False),
                                                 (3, 1024, 257, True), (8, 128, 700, False)])
def test_take_table_strided_plain_matches_pallas(rng, r, t, n, transpose_out):
    """The table as the sparse-BA step hands it over: the transpose of an
    (F, R) tensor, a strided view, with out-of-range indices (clipped at a
    whole-tile T by both packages); the output in either layout. Exact."""
    rows = rng.normal(size=(t, r)).astype(np.float32)
    idx = rng.integers(-3, t + 3, n).astype(np.int32)
    ref = np.concatenate([np.asarray(jgk.take_table(jnp.asarray(rows.T[i:i + 8]), jnp.asarray(idx),
                                                    interpret=True)) for i in range(0, r, 8)])
    table = T(rows).T
    assert not table.is_contiguous()
    got = tgk.take_table(table, T(idx), transpose_out=transpose_out)
    assert got.shape == ((n, r) if transpose_out else (r, n))
    np.testing.assert_array_equal(got.numpy(), ref.T if transpose_out else ref)


@pytest.mark.parametrize("n,r,t", [(5000, 6, 512), (3000, 36, 16), (700, 9, 1024)])
def test_segment_sum_small_plain_matches_pallas(rng, n, r, t):
    """With dropped rows (id T) and ids below 0: rtol 2e-5, atol 1e-4."""
    vals = rng.normal(size=(n, r)).astype(np.float32)
    seg = rng.integers(0, t, n).astype(np.int32)
    seg[::17] = t
    seg[5::41] = -1
    ref = jsk.segment_sum_small(jnp.asarray(vals), jnp.asarray(seg), t, interpret=True)
    got = tsk.segment_sum_small(T(vals), T(seg), t)
    assert got.shape == (t, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("n,r,t", [(5000, 6, 512), (4000, 36, 1500), (300, 9, 2048),
                                   (20000, 12, 1025), (0, 6, 3)])
def test_segment_sum_plain_close_to_index_add(rng, n, r, t):
    """K9's fixed order against index_add_ at the JAX kernel's tolerance
    (rtol 2e-5, atol 1e-4), past 1,024 segments too, with empty segments
    (ids drawn from half the range) and ids outside [0, T) that add nothing."""
    vals = rng.normal(size=(n, r)).astype(np.float32)
    seg = rng.integers(-3, t // 2 + 3, n).astype(np.int32)
    seg[::11] = t + 7
    keep = (seg >= 0) & (seg < t)
    ref = torch.zeros((t + 1, r)).index_add_(0, T(np.where(keep, seg, t)).long(), T(vals))[:t]
    got = tsk.segment_sum_small(T(vals), T(seg), t)
    assert got.shape == (t, r)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5, atol=1e-4)
    assert not got[t // 2 + 3:].any()


def test_segment_sum_plain_adds_in_the_documented_order(rng):
    """The order K9 and its plain version share, written out in numpy float32:
    a segment's rank-q row goes to lane q % 32, each lane adds serially from
    0.0, then the shuffle-down tree. Bit for bit, with segments of 1 to ~300
    rows; a plan made once gives the same bits as a call that makes its own."""
    n, r, t = 6000, 5, 40
    vals = (rng.normal(size=(n, r)) * 10.0 ** rng.integers(-4, 5, (n, r))).astype(np.float32)
    seg = np.minimum(rng.geometric(0.08, n) - 1, t).astype(np.int32)
    ref = np.zeros((t, r), np.float32)
    for k in range(t):
        rows = vals[seg == k]
        lanes = np.zeros((32, r), np.float32)
        for q, row in enumerate(rows):
            lanes[q % 32] = lanes[q % 32] + row
        for o in (16, 8, 4, 2, 1):
            lanes[:o] = lanes[:o] + lanes[o:2 * o]
        ref[k] = lanes[0]
    plan = tsk.plan_segments(T(seg), t)
    assert plan.order.dtype == torch.int32 and plan.offsets.shape == (t + 1,)
    for got in (tsk.segment_sum_small(T(vals), T(seg), t),
                tsk.segment_sum_small(T(vals), T(seg), t, plan=plan)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_segment_sum_plain_past_1024_matches_jax_scatter(rng):
    """Past 1,024 frames JAX's sparse_ba takes jax.ops.segment_sum
    (parallel/sparse_ba.py:_segsum_frame_rows); K9's plain version agrees
    with it at rtol 2e-5, atol 1e-4."""
    import jax

    n, r, f = 30000, 36, 1500
    vals = rng.normal(size=(n, r)).astype(np.float32)
    seg = rng.integers(0, f + 1, n).astype(np.int32)      # id f drops the row
    ref = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg), num_segments=f + 1)[:f]
    got = tsk.segment_sum_small(T(vals), T(seg), f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-4)


def test_new_wrappers_never_fall_back():
    with pytest.raises(ValueError, match="CUDA"):
        tgk.take_table(torch.zeros((2, 4)), torch.zeros(3, dtype=torch.int32), backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tgk.take_table_cuda(torch.zeros((2, 4)), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tsk.segment_sum_small(torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), 4,
                              backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        tsk.segment_sum_small_cuda(torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), 4)
    _lib.reset_launches()
    tsk.segment_sum_small(torch.zeros((3, 2)), torch.zeros(3, dtype=torch.int32), 4)
    assert all(v == 0 for v in _lib.launches.values())


def test_frame_helpers_choose_by_device_alone(monkeypatch):
    """``sparse_ba``'s frame-space gather and sum send every CUDA tensor to
    K10 / K9 with ``backend="cuda"``, whatever its width or the number of
    poses (the wrappers raise past their limits; nothing gives way to the
    plain version on the card), and every CPU tensor to the plain version,
    through the same dispatchers with ``backend="torch"`` (so the work tally
    counts it)."""
    class OnCard(torch.Tensor):
        is_cuda = True

    calls = []
    take, segsum = tsba.gather_kernel.take_table, tsba.segsum_kernel.segment_sum_small

    def take_stub(table, idx, backend, transpose_out):
        calls.append(("K10", backend))
        return table[:, :1] if backend == "cuda" else take(table, idx, backend, transpose_out)

    def segsum_stub(v, seg, t, backend, plan=None):
        calls.append(("K9", backend))
        return v[:1] if backend == "cuda" else segsum(v, seg, t, backend, plan)

    monkeypatch.setattr(tsba.gather_kernel, "take_table", take_stub)
    monkeypatch.setattr(tsba.segsum_kernel, "segment_sum_small", segsum_stub)
    fi = torch.zeros(5, dtype=torch.int32)
    for f, r in ((40, 6), (2000, 6), (40, 100)):
        tsba._gather_frame_rows(torch.zeros((f, r)).as_subclass(OnCard), fi)
        tsba._segsum_frame_rows(torch.zeros((5, r)).as_subclass(OnCard), fi, f)
    assert calls == [("K10", "cuda"), ("K9", "cuda")] * 3
    assert tsba._gather_frame_rows(torch.ones((2000, 100)), fi).shape == (5, 100)
    assert tsba._segsum_frame_rows(torch.ones((5, 100)), fi, 2000)[0, 0] == 5.0
    assert calls[6:] == [("K10", "torch"), ("K9", "torch")]


def test_generate_ba_corridor_matches_jax():
    kj, pj, nj = jsyn.generate_ba_corridor(f=16, l=400)
    kt, pt, nt = tsyn.generate_ba_corridor(f=16, l=400)
    assert nj == nt and np.array_equal(kj, kt)
    np.testing.assert_allclose(pt.poses.numpy(), np.asarray(pj.poses), atol=1e-6)
    for name in ("landmarks", "frame_idx", "lm_idx", "uv", "obs_mask"):
        got, ref = getattr(pt, name), np.asarray(getattr(pj, name))
        assert got.numpy().dtype == ref.dtype, name
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
    k2, p2, n2 = tsyn.generate_ba_corridor(f=8, l=50, obs_per_lm=3, seed=4, noise_lm=0.0)
    kj2, pj2, nj2 = jsyn.generate_ba_corridor(f=8, l=50, obs_per_lm=3, seed=4, noise_lm=0.0)
    assert n2 == nj2
    np.testing.assert_array_equal(p2.frame_idx.numpy(), np.asarray(pj2.frame_idx))
    np.testing.assert_array_equal(p2.landmarks.numpy(), np.asarray(pj2.landmarks))


def _corridor():
    k, pj, _ = jsyn.generate_ba_corridor(f=16, l=400)
    return k, pj, _to_port(pj)


@pytest.mark.parametrize("scene", ["grid", "corridor"])
@pytest.mark.parametrize("pack", [False, True])
def test_sparse_ba_step_matches_jax(rng, scene, pack):
    """One LM step, packed and unpacked, 10 CG iterations in both packages."""
    if scene == "grid":
        cam, _, pj, *_ = _problems(rng)
        k, damping = np.asarray(cam.camera_matrix), 0.1
        pt = _to_port(pj)
    else:
        k, pj, pt = _corridor()
        damping = 1.0
    wj, dj = jsba.pack_problem(pj) if pack else (pj, None)
    wt, dt = tsba.pack_problem(pt) if pack else (pt, None)
    assert dj == dt
    if pack:
        for a, b in zip(wt, wj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rj, sj = jsba.sparse_ba_step(jnp.asarray(k), wj, damping=damping, cg_iterations=10,
                                 cg_tolerance=0.0, lm_degree=dj)
    rt, st = tsba.sparse_ba_step(T(k), wt, damping=damping, cg_iterations=10,
                                 cg_tolerance=0.0, lm_degree=dt)
    out = convert.ba_solution_to_arrays(rt)
    np.testing.assert_allclose(out["poses"], np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(out["landmarks"], np.asarray(rj.landmarks), atol=1e-4)
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-4)
    assert int(st.num_obs) == int(sj.num_obs)
    np.testing.assert_allclose(float(st.cg_residual), float(sj.cg_residual), rtol=5e-2, atol=1e-6)


def test_sparse_ba_step_matches_jax_past_1024_poses():
    """One step at 1,100 poses (a corridor of 3,000 landmarks), where both
    packages sum frame rows without their kernels' old 1,024-pose limit.
    Landmarks, rotations and chi at test_sparse_ba_step_matches_jax's
    tolerances (1e-4, 1e-4 relative). The translations move by up to ~3
    units along this chain in 10 CG iterations, and there the float32 step
    itself is uncertain: JAX's lies ~3e-3 from the same step in float64 (the
    port's, run in float64), the two packages ~5e-4 from each other. So the
    port's translations must lie no farther from JAX's than JAX's lie from
    the float64 step."""
    k, pj, _ = jsyn.generate_ba_corridor(f=1100, l=3000)
    pt = _to_port(pj)
    wj, dj = jsba.pack_problem(pj)
    wt, dt = tsba.pack_problem(pt)
    assert dj == dt is not None
    rj, sj = jsba.sparse_ba_step(jnp.asarray(k), wj, cg_iterations=10, cg_tolerance=0.0,
                                 lm_degree=dj)
    rt, st = tsba.sparse_ba_step(T(k), wt, cg_iterations=10, cg_tolerance=0.0, lm_degree=dt)
    w64 = wt._replace(poses=wt.poses.double(), landmarks=wt.landmarks.double(),
                      uv=wt.uv.double())
    r64, _ = tsba.sparse_ba_step(T(k).double(), w64, cg_iterations=10, cg_tolerance=0.0,
                                 lm_degree=dt)
    got, ref, exact = rt.poses.numpy(), np.asarray(rj.poses), r64.poses.numpy()
    assert got.shape == (1100, 4, 4)
    np.testing.assert_allclose(got[:, :3, :3], ref[:, :3, :3], atol=1e-4)
    jax_error = np.abs(ref[:, :3, 3] - exact[:, :3, 3]).max()
    assert np.abs(got[:, :3, 3] - ref[:, :3, 3]).max() <= jax_error
    np.testing.assert_allclose(rt.landmarks.numpy(), np.asarray(rj.landmarks), atol=1e-4)
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-4)
    assert int(st.num_obs) == int(sj.num_obs)


def test_refine_sparse_reduces_chi_and_fixes_the_gauge(rng):
    """tests/test_sparse_ba.py:112-130 on the port: the scene is recovered,
    chi falls, the CG converges, pose 0 does not move at all."""
    cam, _, pj, gt_poses, world = _problems(rng)
    pt = _to_port(pj)
    k = T(np.asarray(cam.camera_matrix))
    _, first = tsba.sparse_ba_step(k, pt, damping=0.1)
    refined, stats = tsba.refine_sparse(k, pt, num_iterations=15, damping=0.1)
    assert float(stats.chi) < 1e-3 * float(first.chi)
    np.testing.assert_allclose(refined.poses.numpy(), gt_poses, atol=2e-3)
    np.testing.assert_allclose(refined.landmarks.numpy(), world, atol=2e-2)
    assert float(stats.cg_residual) < 1e-3
    assert torch.equal(refined.poses[0], pt.poses[0])
    for name in ("frame_idx", "lm_idx", "uv", "obs_mask"):   # the caller's layout comes back
        assert torch.equal(getattr(refined, name), getattr(pt, name))
    unpacked, _ = tsba.refine_sparse(k, pt, num_iterations=15, damping=0.1, pack=False)
    np.testing.assert_allclose(unpacked.poses.numpy(), refined.poses.numpy(), atol=1e-4)


def test_duplicate_observations_supported(rng):
    """Two observations of one (frame, landmark) pair still converge
    (tests/test_sparse_ba.py:131)."""
    cam, _, pj, gt_poses, _ = _problems(rng)
    pt = _to_port(pj)
    dup = pt._replace(**{name: torch.cat([getattr(pt, name), getattr(pt, name)[:8]])
                         for name in ("frame_idx", "lm_idx", "uv", "obs_mask")})
    refined, _ = tsba.refine_sparse(T(np.asarray(cam.camera_matrix)), dup, num_iterations=15,
                                    damping=0.1)
    np.testing.assert_allclose(refined.poses.numpy(), gt_poses, atol=2e-3)


def test_pack_problem_declines_a_dense_landmark(rng):
    """A landmark observed far more often than the rest would blow the packed
    layout up: both packages leave the problem as it is."""
    _, pj, pt = _corridor()
    n = pt.uv.shape[0]
    heavy = pt._replace(lm_idx=torch.where(torch.arange(n) < n * 4 // 5, 0, pt.lm_idx)
                        .to(torch.int32))
    work, degree = tsba.pack_problem(heavy)
    assert degree is None and work is heavy
    _, jdegree = jsba.pack_problem(pj._replace(lm_idx=jnp.asarray(heavy.lm_idx.numpy())))
    assert jdegree is None


def _join_inputs(rng):
    f, s, l, d = 6, 32, 40, 10
    map_apps = jsyn.generate_appearances(rng, l)
    pts = rng.uniform(0, 600, (f, s, 2)).astype(np.float32)
    counts = rng.integers(s // 2, s + 1, f)
    mask = np.arange(s)[None, :] < counts[:, None]   # the host join assumes prefix masks
    which = rng.integers(0, l + 5, (f, s))           # some measurements match no landmark
    allapps = np.concatenate([map_apps, jsyn.generate_appearances(rng, 5)])
    apps = allapps[which].astype(np.float32)
    return pts, apps, mask, map_apps, which


def test_build_observations_coo_matches_jax_and_the_dense_join(rng):
    """tests/test_sparse_ba.py:220-275 on the port: the COO join equals JAX's
    field by field, its membership equals the dense host join's, and so does
    the port's ``build_observations``; dead slots never join."""
    pts, apps, mask, map_apps, which = _join_inputs(rng)
    ref = jref.build_observations_coo(*(jnp.asarray(x) for x in (pts, apps, mask, map_apps)))
    got = tref.build_observations_coo(*(T(x) for x in (pts, apps, mask, map_apps)))
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    obs_d, mask_d = tref.build_observations(pts, apps, mask, map_apps)
    obs_j, mask_j = jref.build_observations(pts, apps, mask, map_apps)
    np.testing.assert_array_equal(obs_d, obs_j)
    np.testing.assert_array_equal(mask_d, mask_j)
    fi, li, uv, m = (x.numpy() for x in got)
    gmask = np.zeros_like(mask_d)
    gmask[fi[m], li[m]] = True
    np.testing.assert_array_equal(gmask, mask_d)
    # Dead slots carrying a map key, and a key held by two map rows (the
    # larger row wins in both packages).
    mask2 = mask.copy()
    mask2[:, ::3] = False
    map2 = np.concatenate([map_apps, map_apps[:3]])
    ref2 = jref.build_observations_coo(*(jnp.asarray(x) for x in (pts, apps, mask2, map2)))
    got2 = tref.build_observations_coo(*(T(x) for x in (pts, apps, mask2, map2)))
    for g, r in zip(got2, ref2):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not got2[3].reshape(mask2.shape)[:, ::3].any()
