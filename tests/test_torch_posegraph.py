"""Chunked sequence-parallel tracking of the port (parallel/posegraph) against
the JAX package, on the CPU.

The inputs are ``generate_tracking_sequence(default_rng(0), 32, 64,
seed_motion=6)`` under ``deep_camera()`` (the wide orbit of
tests/test_torch_serving.py), chunked with overlap 6. The JAX side runs its
fused path through the Pallas interpreter (``scan_backend="fused_interpret"``,
which reaches K4's batched grid under its ``vmap`` over the chunks), its 8-point
bootstrap evaluated in float64 as the port's is
(``test_torch_pipeline.jax_bootstrap_in_double``).

Tolerances: chunk starts, ``num_ratio_obs``, map membership, slot order and
counts are exact; scales within 1e-4 relative. Trajectories within 5e-4: the
port tracks each chunk with the serial arithmetic, and the JAX package's own
vmapped ``_track`` differs from its single ``_track`` by up to 5.7e-5 on these
frames, while the serial port is up to 9.7e-5 from the serial JAX run; the
chunked runs differ by up to 1.2e-4. 5e-4 is the bound
tests/test_torch_serving.py holds the port to against the JAX ``vmap`` form (a
tenth of the JAX package's own batched-vs-serial tolerance). Map points within
1e-3 of (1 + |p|), as tests/test_torch_pipeline.py holds them. The
application on a generated dataset: the evaluation metrics within 2e-3.
"""

import itertools
import os
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu import apps as japps
from visual_odometry_tpu.models import landmark_map as jlm
from visual_odometry_tpu.parallel import posegraph as jpg
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.ops import epipolar, matching
from visual_odometry_tpu_torch.parallel import posegraph as tpg
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

from test_torch_pipeline import jax_bootstrap_in_double

F, S, OVERLAP = 32, 64, 6
POSE_TOL, SCALE_RTOL = 5e-4, 1e-4
CFG = dict(n_slots=S, map_capacity=1024)
JAX_FUSED = dict(scan_backend="fused_interpret", matcher_backend="pairs_pallas_interpret")


@pytest.fixture(scope="module")
def sequence():
    return jsyn.generate_tracking_sequence(np.random.default_rng(0), F, S, seed_motion=6.0)


def _tensors(seq):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in seq)


@pytest.fixture(scope="module")
def jax_runs(sequence):
    """{(num_chunks, slack): (trajectory, map, diagnostics)} of the JAX package."""
    cfg = JaxConfig(**CFG, **JAX_FUSED)
    with jax_bootstrap_in_double():
        out = {}
        for c in (2, 3):
            for s in (0, None):
                traj, m, diags = jpg.run_sequence_chunked(
                    jsyn.deep_camera(), cfg, *(jnp.asarray(x) for x in sequence),
                    num_chunks=c, overlap=OVERLAP, slack=s)
                out[c, s] = (np.asarray(traj), m, diags)
        return out


@pytest.mark.parametrize("frames,chunks,overlap,slack,scores_seed", [
    (121, 4, 10, 0, None), (121, 5, 8, 6, 0), (50, 1, 10, 0, None), (32, 2, 6, 8, 1),
    (32, 3, 6, 8, 2), (512, 4, 10, 8, 3), (512, 4, 10, 20, 4), (100, 7, 3, 2, 5),
    (10, 3, 2, 0, None), (10, 0, 4, 0, None), (10, 2, 8, 4, None), (12, 6, 3, 0, None),
    (28, 3, 6, 8, 0),
])
def test_plan_chunks_matches_jax(frames, chunks, overlap, slack, scores_seed):
    """The same plan, or the same ValueError, for the same inputs."""
    scores = None
    if scores_seed is not None:
        scores = np.random.default_rng(scores_seed).uniform(0, 1, frames - 1).astype(np.float32)
    try:
        want = jpg.plan_chunks(frames, chunks, overlap, scores, slack)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpg.plan_chunks(frames, chunks, overlap, scores, slack)
        assert str(got.value) == str(e)
        return
    assert tpg.plan_chunks(frames, chunks, overlap, scores, slack) == want


def test_bootstrap_scores_match_jax(sequence):
    """Scores within 1e-4 relative of the JAX package's, give or take 1e-6:
    a score is a difference of [-1, 1]-normalized float32 coordinates, each
    rounded to ~1e-7 by either package's own eigh and solves (measured:
    8.6e-7 on a score of 6.6e-3). plan_chunks fed either package's scores
    gives the same starts; the scores' pass gives chunk 0's bootstrap check
    what ``check_bootstrap`` measures alone."""
    want = np.asarray(jpg.bootstrap_scores(*(jnp.asarray(x) for x in sequence)))
    t = _tensors(sequence)
    got = tpg.bootstrap_scores(*t).numpy()
    assert got.shape == (F - 1,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    for chunks in (2, 3):
        assert (tpg.plan_chunks(F, chunks, OVERLAP, got, 8)
                == tpg.plan_chunks(F, chunks, OVERLAP, want, 8))
    num, med, cnt = tpg._pair_conditioning(*t, 0.1, "auto")
    alone = tpipe.bootstrap_diagnostics(
        VOConfig(**CFG), *(tpipe.FrameData(*(x[i] for x in t), torch.full((S,), -1))
                           for i in (0, 1)))
    assert int(num[0]) == int(alone.num_correspondences) and int(cnt[0]) > 0
    assert float(med[0]) == float(alone.degeneracy_score)


def _jax_auto_slack(scores, frames, chunks):
    """The slack the JAX package's run_sequence_chunked sizes from its scores
    (visual_odometry_tpu/parallel/posegraph.py:490-505)."""
    good = scores[scores > 0]
    thr = 0.4 * (np.median(good) if good.size else 0.0)
    bad = (scores < thr).astype(np.int64)
    run = max((len(list(g)) for k, g in itertools.groupby(bad) if k), default=0)
    return max(8, min(run + 2, max(frames // max(chunks, 1) - 2, 4)))


def test_plan_scores_at_default_radius(sequence):
    """At ``match_radius=0.2`` the plan still scores the bootstrap pairs at
    0.1, as the JAX package does: its slack and starts equal those JAX's
    bootstrap_scores and plan_chunks give, while chunk 0's bootstrap check
    matches at the config's radius. The appearances carry per-frame noise
    (sigma 0.02), so the two radii match differently: scored at 0.2, the
    same frames plan other starts."""
    frames, chunks = 48, 3
    p, a, m = jsyn.generate_tracking_sequence(np.random.default_rng(0), frames, S,
                                              seed_motion=6.0)
    a = (a + np.random.default_rng(1).normal(0, 0.02, a.shape)).astype(np.float32)
    jscores = np.asarray(jpg.bootstrap_scores(*(jnp.asarray(x) for x in (p, a, m))))
    jslack = _jax_auto_slack(jscores, frames, chunks)
    want = jpg.plan_chunks(frames, chunks, OVERLAP, jscores, jslack)
    t = _tensors((p, a, m))
    ids = torch.full(m.shape, -1, dtype=torch.int32)
    cfg = VOConfig(**CFG, match_radius=0.2)
    starts, chunk_len, diag0 = tpg._plan(cfg, *t, ids, False, chunks, OVERLAP, None)
    assert (starts, chunk_len) == want
    scores = tpg.bootstrap_scores(*t).numpy()
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-6)
    assert tpg._auto_slack(scores, frames, chunks) == jslack
    assert tpg._auto_slack(jscores, frames, chunks) == jslack
    at_02 = tpg.bootstrap_scores(*t, match_radius=0.2).numpy()
    assert tpg.plan_chunks(frames, chunks, OVERLAP, at_02, jslack) != want
    s0 = starts[0]
    alone = tpipe.bootstrap_diagnostics(
        cfg, *(tpipe.FrameData(*(x[i] for x in t), ids[i]) for i in (s0, s0 + 1)))
    assert int(diag0.num_correspondences) == int(alone.num_correspondences)
    assert float(diag0.degeneracy_score) == float(alone.degeneracy_score)
    num_01 = tpg._pair_conditioning(*t, 0.1, "auto")[0][s0]
    assert int(alone.num_correspondences) > int(num_01)


def test_batched_homography_residuals_equal_single_pairs(sequence):
    """The residuals of a stack of pairs equal each pair's alone, bit for bit."""
    p, a, m = _tensors(sequence)
    corr = matching.match_appearances_batch(a[:-1], m[:-1], a[1:], m[1:])
    res, ok = epipolar.homography_transfer_residuals(
        corr.idx1, corr.idx2, corr.valid, p[:-1], p[1:], m[:-1], m[1:])
    for i in range(F - 1):
        r1, ok1 = epipolar.homography_transfer_residuals(
            corr.idx1[i], corr.idx2[i], corr.valid[i], p[i], p[i + 1], m[i], m[i + 1])
        assert torch.equal(res[i], r1) and torch.equal(ok[i], ok1)


def _null_vector_single(ata, iters=3):
    """The single-matrix null vector as the port computed it before stacks."""
    _, vecs = torch.linalg.eigh(ata)
    v0 = vecs[:, 0]
    ata_r = ata + 1e-6 * torch.trace(ata) * torch.eye(ata.shape[0], dtype=ata.dtype)
    v = v0
    for _ in range(iters):
        sol, info = torch.linalg.solve_ex(ata_r, v)
        v = torch.where(info == 0, sol, float("nan"))
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    return torch.where(torch.all(torch.isfinite(v)), v, v0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_null_vector_keeps_single_bits(sequence, dtype):
    """The main path's bootstrap (``estimate_fundamental``: float64 normal
    matrices of real frame pairs) and random ones: the stack-aware null vector
    gives one matrix the bits of the single-matrix form, and each matrix of a
    stack the bits it gets alone."""
    p, a, m = _tensors(sequence)
    mats = []
    for i in range(F - 1):
        corr = matching.match_appearances(a[i], m[i], a[i + 1], m[i + 1])
        p1n, _ = epipolar.normalize_points(p[i], m[i])
        p2n, _ = epipolar.normalize_points(p[i + 1], m[i + 1])
        ones = torch.ones((S, 1))
        rows = epipolar._design_rows(torch.cat([p1n[corr.idx1.long()], ones], -1),
                                     torch.cat([p2n[corr.idx2.long()], ones], -1),
                                     corr.valid).to(dtype)
        mats.append(rows.T @ rows)
    g = torch.randn((64, 9, 40), generator=torch.Generator().manual_seed(3), dtype=dtype)
    stack = torch.cat([torch.stack(mats), g @ g.transpose(-1, -2)])
    together = epipolar._null_vector(stack)
    for i, ata in enumerate(stack):
        alone = epipolar._null_vector(ata)
        assert torch.equal(alone, _null_vector_single(ata))
        assert torch.equal(together[i], alone)


@pytest.fixture(scope="module")
def port_runs(sequence):
    """{(num_chunks, slack): (trajectory, map, diagnostics)} of the port."""
    t = _tensors(sequence)
    return {(c, s): tpg.run_sequence_chunked(tsyn.deep_camera(), VOConfig(**CFG), *t,
                                             num_chunks=c, overlap=OVERLAP, slack=s)
            for c in (2, 3) for s in (0, None)}


@pytest.mark.parametrize("num_chunks", [2, 3])
@pytest.mark.parametrize("slack", [0, None])
def test_run_sequence_chunked_matches_jax(port_runs, jax_runs, num_chunks, slack):
    traj, m, diags = port_runs[num_chunks, slack]
    jtraj, jm, jdiags = jax_runs[num_chunks, slack]
    assert traj.shape == (F, 4, 4) and diags.scales.shape == (num_chunks,)
    np.testing.assert_allclose(diags.scales.numpy(), np.asarray(jdiags.scales), rtol=SCALE_RTOL)
    np.testing.assert_array_equal(diags.num_ratio_obs.numpy(), np.asarray(jdiags.num_ratio_obs))
    assert (diags.num_ratio_obs.numpy() >= 8).all() and int(diags.join_overflow) == 0
    np.testing.assert_allclose(diags.rot_consistency.numpy(), np.asarray(jdiags.rot_consistency),
                               atol=1e-5)
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=POSE_TOL)
    assert int(m.count) == int(jm.count)
    np.testing.assert_array_equal(m.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(m.appearances.numpy(), np.asarray(jm.appearances))
    ref = np.asarray(jm.points)
    assert (np.abs(m.points.numpy() - ref) <= 1e-3 * (1 + np.abs(ref))).all()


@pytest.mark.parametrize("num_chunks", [2, 3])
def test_batched_program_equals_loop_form(sequence, port_runs, num_chunks):
    """The chunks as one batched program (multiseq._track_batched, which the
    card runs: K1-K3 over the flattened chunks, one K8) and as a loop of
    pipeline._track, here both through the plain versions: the same
    trajectory, map and diagnostics, bit for bit."""
    t = _tensors(sequence)
    starts, length = tpg.plan_chunks(F, num_chunks, OVERLAP)
    ids = torch.full((F, S), -1, dtype=torch.int32)
    chunked = [tpg._chunk(x, starts, length) for x in t + (ids,)]
    cfg = VOConfig(**CFG)
    loop = tpg._track_and_stitch(tsyn.deep_camera(), cfg, *chunked, starts, length, F, False,
                                 batched=False)
    batched = tpg._track_and_stitch(tsyn.deep_camera(), cfg, *chunked, starts, length, F, False,
                                    batched=True)
    for a, b in zip(loop, batched):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert torch.equal(loop[0], port_runs[num_chunks, 0][0])


def test_single_chunk_equals_run_sequence(sequence):
    t = _tensors(sequence)
    cfg = VOConfig(**CFG)
    traj, m, _ = tpipe.run_sequence(tsyn.deep_camera(), cfg, *t)
    ctraj, cm, diags = tpg.run_sequence_chunked(tsyn.deep_camera(), cfg, *t, num_chunks=1)
    assert torch.equal(ctraj, traj)
    for x, y in zip(cm, m):
        assert torch.equal(x, y)
    assert diags.scales.tolist() == [1.0] and diags.num_ratio_obs.numel() == 0


def test_chunk0_bootstrap_hard_error(rng):
    """Chunk 0's bootstrap pair with fewer than 8 matches raises, as the
    serial path does (the JAX package's tests/test_posegraph.py:195)."""
    pts, apps, masks = tsyn.generate_tracking_sequence(rng, 24, 32)
    apps = apps.copy()
    apps[0] = tsyn.generate_appearances(np.random.default_rng(999), 32)
    cfg = VOConfig(n_slots=32, map_capacity=64, gn_iterations=5)
    for slack in (0, None):   # its own check, and the one taken from the scores' pass
        with pytest.raises(tpipe.BootstrapError, match="got 0"):
            tpg.run_sequence_chunked(tsyn.default_camera(), cfg, *_tensors((pts, apps, masks)),
                                     num_chunks=2, overlap=4, slack=slack)


def test_unobservable_stitch_scale_raises(rng):
    """No matches after the bootstrap pair: no shared triangulation in any
    overlap and identity tracked poses raise StitchError (the JAX package's
    tests/test_posegraph.py:221)."""
    pts, apps, masks = tsyn.generate_tracking_sequence(rng, 12, 32)
    apps = apps.copy()
    for f in range(2, 12):
        apps[f] = tsyn.generate_appearances(np.random.default_rng(500 + f), 32)
    cfg = VOConfig(n_slots=32, map_capacity=64, gn_iterations=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(tpg.StitchError):
            tpg.run_sequence_chunked(tsyn.default_camera(), cfg, *_tensors((pts, apps, masks)),
                                     num_chunks=2, overlap=4, slack=0)


def test_mesh_raises(sequence):
    """A mesh whose sequence-parallel axis does not divide the chunk count
    raises before any work (the sharded form itself:
    tests/test_torch_sharded_tracking.py)."""
    mesh = types.SimpleNamespace(shape={"dp": 4, "lm": 1}, axis_names=("dp", "lm"))
    with pytest.raises(ValueError, match="the mesh axis 'dp' of size 4 does not divide 2 chunks"):
        tpg.run_sequence_chunked(tsyn.deep_camera(), VOConfig(**CFG), *_tensors(sequence),
                                 num_chunks=2, mesh=mesh)


def _metrics(res):
    finite = np.isfinite(res.orientation_errors)
    return np.array([np.abs(res.orientation_errors[finite]).mean(), res.rmse_position,
                     res.scale, res.n_map_matched])


def test_run_vo_complete_chunked_matches_jax(tmp_path):
    """``run_vo_complete`` with ``num_chunks=2`` routes through
    run_sequence_chunked: the same evaluation metrics as the JAX application
    (its 8-point bootstrap in float64) within 2e-3, the same number of map
    landmarks matched, and the accuracy bounds of tests/test_dataset_gen.py.
    The map RMSE is not compared: far landmarks of this set triangulate with
    little parallax, and the serial runs of the two packages already place
    some 0.5 apart (RMSE_map 0.143 against 0.129, measured). Then
    refine_stitched (dense) from the port's stitched result, against the JAX
    package's on the same trajectory and map: positions within 1e-3
    (tests/test_torch_refinement.py's bound)."""
    data, out_t, out_j = (str(tmp_path / n) for n in ("data", "port", "jax"))
    jdg.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    cfg = VOConfig(num_chunks=2)
    traj, m, diags = tapps.run_vo_complete(data, out_t, cfg, verbose=False, device="cpu")[:3]
    assert isinstance(diags, tpg.PoseGraphDiagnostics) and diags.scales.shape == (2,)
    with jax_bootstrap_in_double():
        japps.run_vo_complete(data, out_j, JaxConfig(num_chunks=2), verbose=False)
    got = _metrics(tapps.run_evaluation(data, out_t, verbose=False))
    want = _metrics(japps.run_evaluation(data, out_j, verbose=False))
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert got[0] < 1e-4 and got[1] < 0.2 and got[3] > 100

    params, camera, seq = tapps._load(data, cfg, torch.device("cpu"))
    _, jcamera, _ = japps._load(data, JaxConfig())
    seq_t = _tensors((seq.points, seq.appearances, seq.mask))
    rel, refined = tpg.refine_stitched(camera, cfg, torch.from_numpy(traj), m, *seq_t)
    jmap = jlm.LandmarkMap(*(jnp.asarray(x.numpy()) for x in m))
    jrel, jrefined = jpg.refine_stitched(jcamera, JaxConfig(num_chunks=2), jnp.asarray(traj),
                                         jmap, seq.points, seq.appearances, seq.mask)
    assert rel.shape == (40, 4, 4) and int(refined.count) == int(jrefined.count) == int(m.count)
    np.testing.assert_allclose(rel.numpy()[:, :3, 3], np.asarray(jrel)[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(refined.points.numpy(), np.asarray(jrefined.points), atol=1e-3)
    np.testing.assert_array_equal(refined.appearances.numpy(), np.asarray(jrefined.appearances))
    assert os.path.getsize(os.path.join(out_t, "map.txt")) > 0
