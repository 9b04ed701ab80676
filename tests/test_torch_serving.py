"""Batched serving of the port against the JAX package, on the CPU.

The workload is that of the JAX package's ``selfcheck.check_frame_serving``:
B = 3 sequences of ``generate_tracking_sequence(default_rng(7 + i), 10, 64)``
under ``deep_camera()`` and ``VOConfig(n_slots=64, map_capacity=256,
gn_iterations=30)``, here on the wide orbit (``seed_motion=6``): at the
default motion the per-frame baseline is so short that the monocular chain
amplifies ulp-level differences to ~1e-3 within ten frames, in either package.

Tolerances: the port's batched forms equal its own ``run_sequence`` per
sequence exactly (same arithmetic, sequence by sequence). Against the JAX
``vmap`` form, trajectories within 5e-4 (a tenth of the JAX package's own
serving-vs-serial tolerance, utils/selfcheck.py:345) with equal map counts,
each package running its own 8-point bootstrap, the JAX package's evaluated in
float64 as the port's is. The plain K8 against
``track_frames_fused_serving(interpret=True, inner_batch=1)`` on the same
kernel inputs: poses within 2e-3 (its serving-vs-vmap tolerance,
tests/test_multiseq.py:66), counts and triangulation validity exact.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops.pallas import frame_kernel as jfk
from visual_odometry_tpu.parallel import multiseq as jmulti
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.ops.kernels import frame_kernel as tfk
from visual_odometry_tpu_torch.parallel import multiseq as tmulti
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

from test_torch_kernels import T, _k4_inputs
from test_torch_pipeline import jax_bootstrap_in_double

B, F, S = 3, 10, 64
CFG = dict(n_slots=S, map_capacity=256, gn_iterations=30)


@pytest.fixture(scope="module")
def batch():
    seqs = [jsyn.generate_tracking_sequence(np.random.default_rng(7 + i), F, S, seed_motion=6.0)
            for i in range(B)]
    return tuple(np.stack([s[k] for s in seqs]) for k in range(3))


def _assert_equal_runs(got, ref_runs, map_points_rtol=0.0):
    traj, maps, outs = got
    for i, (rt, rm, ro) in enumerate(ref_runs):
        assert torch.equal(traj[i], rt)
        for name, a, b in zip(maps._fields, maps, rm):
            if name == "points" and map_points_rtol:
                torch.testing.assert_close(a[i], b, rtol=map_points_rtol, atol=map_points_rtol)
            else:
                assert torch.equal(a[i], b)
        for a, b in zip(outs, ro):
            assert torch.equal(a[i], b)


def test_batched_forms_equal_run_sequence(batch):
    """``backend="torch"`` (the loop) and the batch-aware program (one match,
    join, gather and frame-loop call over the flattened batch, here through
    the plain versions) both give ``run_sequence``'s result per sequence,
    bit for bit: trajectory, map and every per-frame output. The batch-aware
    program moves the triangulations into frame 0 with one matmul batched
    over the sequences, which may round differently from a single
    sequence's: its map positions are held to 1e-6, all else exactly."""
    cam, cfg = tsyn.deep_camera(), VOConfig(**CFG)
    tensors = tuple(torch.from_numpy(x) for x in batch)
    ref = [tpipe.run_sequence(cam, cfg, *(x[i] for x in tensors)) for i in range(B)]
    looped = tmulti.run_sequences_batched(cam, cfg, *tensors, backend="torch")
    assert looped[0].shape == (B, F, 4, 4) and looped[1].points.shape == (B, 256, 3)
    assert looped[2].pose.shape == (B, F - 2, 4, 4) and looped[1].count.shape == (B,)
    _assert_equal_runs(looped, ref)
    _assert_equal_runs(tmulti._run_serving(cam, cfg, *tensors), ref, map_points_rtol=1e-6)
    assert tmulti.run_sequences_batched(cam, cfg, *tensors)[0].equal(looped[0])   # auto on the CPU


def test_batched_matches_jax_vmap(batch):
    """Against JAX ``run_sequences_batched(backend="vmap")``, its 8-point
    bootstrap evaluated in float64 as the port's is (test_torch_pipeline's
    docstring says why): trajectories within 5e-4, equal map counts, equal
    match counts."""
    jcfg = JaxConfig(**CFG)
    with jax_bootstrap_in_double():
        jtraj, jmaps, jouts = jmulti.run_sequences_batched(
            jsyn.deep_camera(), jcfg, *(jnp.asarray(x) for x in batch), backend="vmap")
        jtraj = np.asarray(jtraj)
    traj, maps, outs = tmulti.run_sequences_batched(
        tsyn.deep_camera(), VOConfig(**CFG), *(torch.from_numpy(x) for x in batch),
        backend="torch")
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=5e-4)
    np.testing.assert_array_equal(maps.count.numpy(), np.asarray(jmaps.count))
    np.testing.assert_array_equal(maps.valid.numpy(), np.asarray(jmaps.valid))
    np.testing.assert_array_equal(outs.num_matches.numpy(), np.asarray(jouts.num_matches))


def _serving_inputs(planar, dead=None):
    """K8's inputs for 2 sequences (8 frames x 64 slots), built by the JAX
    pipeline's own stages; sequence ``dead`` gets no valid correspondence."""
    per_seq = [_k4_inputs(8, 64, seed_motion=m) for m in (6.0, 5.0)]
    jargs = [a for a, _ in per_seq]
    stack = lambda k: jnp.stack([a[k] for a in jargs])   # noqa: E731
    cand = jfk.JoinCandidates(*(jnp.stack([getattr(a[5], f) for a in jargs])
                                for f in ("lo", "hi", "ok", "overflow")))
    valid = stack(8)
    tri_ok = stack(4)
    if dead is not None:
        valid = valid.at[dead].set(False)
        tri_ok = tri_ok.at[dead].set(False)
    jax_args = (jargs[0][0], jargs[0][1], stack(2), stack(3), tri_ok, cand, stack(6), stack(7),
                valid)
    tcand = tfk.JoinCandidates(T(cand.lo + 128 * cand.hi).to(torch.int32), T(cand.ok),
                               T(cand.overflow))
    torch_args = tuple(T(x) for x in jax_args[:5]) + (tcand,) + tuple(T(x) for x in jax_args[6:])
    return jax_args, torch_args


MOUNT = np.array([[0.0, 0.0, 1.0, 0.2], [-1.0, 0.0, 0.0, 0.0], [0.0, -1.0, 0.0, 0.0],
                  [0.0, 0.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("planar", [False, True])
def test_track_frames_batched_plain_matches_pallas_serving(planar):
    """The plain K8 against ``track_frames_fused_serving`` in interpret mode,
    SE(3) and planar: poses within 2e-3, inlier and correspondence counts and
    triangulation validity exact."""
    jax_args, torch_args = _serving_inputs(planar)
    kw = dict(planar=planar, cam_in_robot=MOUNT if planar else None)
    ref = jfk.track_frames_fused_serving(*jax_args, 30, jnp.float32(1e4), jnp.float32(1.0),
                                         jnp.float32(1e-12), interpret=True, inner_batch=1, **kw)
    got = tfk.track_frames_batched(*torch_args, 30, 1e4, 1.0, 1e-12, **kw)
    assert got[0].shape == (2, 6, 4, 4) and got[1].shape == (2, 6, 64, 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=2e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(got[3][..., 2:].numpy(), np.asarray(ref[3])[..., 2:])


def test_track_frames_batched_with_a_dead_sequence():
    """A sequence with no valid correspondence comes out as the JAX kernel
    leaves it — identity poses, nothing triangulated, zero counts, no NaN —
    and does not disturb its neighbour, which equals its single-sequence run."""
    jax_args, torch_args = _serving_inputs(False, dead=1)
    ref = jfk.track_frames_fused_serving(*jax_args, 30, jnp.float32(1e4), jnp.float32(1.0),
                                         jnp.float32(1e-12), interpret=True, inner_batch=1)
    got = tfk.track_frames_batched(*torch_args, 30, 1e4, 1.0, 1e-12)
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    np.testing.assert_array_equal(got[0][1].numpy(), np.asarray(ref[0])[1])
    assert torch.equal(got[0][1], torch.eye(4).expand(6, 4, 4))
    assert not got[2][1].any() and float(got[3][1].abs().max()) == 0.0
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(ref[0])[0], atol=2e-3)
    alone = tfk.track_frames(torch_args[0], torch_args[1], torch_args[2][0], torch_args[3][0],
                             torch_args[4][0], tfk.JoinCandidates(*(x[0] for x in torch_args[5])),
                             *(x[0] for x in torch_args[6:]), 30, 1e4, 1.0, 1e-12)
    for a, b in zip(alone, got):
        assert torch.equal(a, b[0])


def test_mesh_and_bad_shapes_raise(batch):
    """Bad shapes raise, and so does a dp axis that does not divide the batch
    (the sharded form itself: tests/test_torch_sharded_tracking.py)."""
    cam, cfg = tsyn.deep_camera(), VOConfig(**CFG)
    tensors = tuple(torch.from_numpy(x) for x in batch)
    mesh = types.SimpleNamespace(shape={"dp": 2, "lm": 1}, axis_names=("dp", "lm"))
    with pytest.raises(ValueError, match="'dp' of size 2 does not divide 3 sequences"):
        tmulti.run_sequences_batched(cam, cfg, *tensors, mesh=mesh)
    with pytest.raises(ValueError, match="CUDA"):
        tmulti.run_sequences_batched(cam, cfg, *tensors, backend="cuda")
    with pytest.raises(ValueError, match="slots"):
        tmulti.run_sequences_batched(cam, cfg.replace(n_slots=32), *tensors)
    # num_chunks belongs to apps.run_vo_complete; serving tracks each sequence
    # whole, as the JAX package's does.
    assert torch.equal(tmulti.run_sequences_batched(cam, cfg.replace(num_chunks=2), *tensors)[0],
                       tmulti.run_sequences_batched(cam, cfg, *tensors)[0])
