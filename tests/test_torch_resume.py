"""Resume, checkpoint, known data association and relocalization of the port
against the JAX package, on the CPU.

Tolerances. ``continue_sequence`` split against one shot: poses and the
carried lookup equal, map layout equal, map positions to 1e-4 (a split
re-associates the float32 frame-0 chain products at the boundary;
tests/test_checkpoint.py:118); the frame_step loop against the fused form to
2e-3 (tests/test_checkpoint.py:131). Against JAX from a carried state: poses
to 1e-4 (two float32 programs, sums in different orders), counts exact.
Correspondences by id are exact. ``relocalize_frame``: match counts exact,
pose to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.models.refinement import absolute_from_relative as jabsolute
from visual_odometry_tpu.utils import checkpoint as jcheckpoint
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.utils import checkpoint, convert
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

F, S, SPLIT = 12, 64, 7


@pytest.fixture(scope="module")
def sequence():
    pts, apps, masks = jsyn.generate_tracking_sequence(np.random.default_rng(0), F, S,
                                                       seed_motion=6.0)
    ids = np.where(masks, np.arange(S, dtype=np.int32)[None], -1).astype(np.int32)
    return pts, apps, masks, ids


def _tensors(sequence, lo=0, hi=None):
    return tuple(torch.from_numpy(x[lo:hi]) for x in sequence)


def _jarrays(sequence, lo=0, hi=None):
    return tuple(jnp.asarray(x[lo:hi]) for x in sequence)


@pytest.fixture(scope="module")
def jax_state0(sequence):
    """The JAX package's bootstrap state on frames 0/1, which both packages resume from."""
    pts, apps, masks, ids = _jarrays(sequence)
    cfg = JaxConfig(n_slots=S, map_capacity=256, gn_iterations=20)
    f0 = jpipe.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = jpipe.FrameData(pts[1], apps[1], masks[1], ids[1])
    state, x_init = jpipe.initialize(jsyn.deep_camera(), cfg, f0, f1)
    return state, np.asarray(x_init)


def _flat(jstate):
    """A JAX VOState as the checkpoint's flat dict of numpy arrays."""
    return dict(
        ref_points=jstate.ref.points, ref_appearances=jstate.ref.appearances,
        ref_mask=jstate.ref.mask, ref_ids=jstate.ref.ids, point_lookup=jstate.point_lookup,
        tri_points=jstate.tri_points, tri_valid=jstate.tri_valid, x_curr=jstate.x_curr,
        history=jstate.history, map_points=jstate.map.points,
        map_appearances=jstate.map.appearances, map_valid=jstate.map.valid,
        map_count=jstate.map.count,
    )


def _cfg(**kw):
    return VOConfig(n_slots=S, map_capacity=256, gn_iterations=20, **kw)


def test_initialize_state_matches_jax(sequence, jax_state0, monkeypatch):
    jstate, x_init = jax_state0
    monkeypatch.setattr(tpipe.epipolar_kernel, "estimate_transform_batched_plain",
                        lambda *a: torch.from_numpy(x_init.copy())[None])
    pts, apps, masks, ids = _tensors(sequence)
    state, _ = tpipe.initialize(tsyn.deep_camera(), _cfg(),
                                tpipe.FrameData(pts[0], apps[0], masks[0], ids[0]),
                                tpipe.FrameData(pts[1], apps[1], masks[1], ids[1]))
    got, ref = convert.vo_state_to_arrays(state), _flat(jstate)
    assert set(got) == set(ref)
    for key in ("point_lookup", "tri_valid", "map_valid", "map_count", "map_appearances",
                "ref_ids", "ref_mask"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    # Mid-point triangulation amplifies float32 rounding with depth: 1e-3 relative,
    # as tests/test_torch_pipeline.py holds the map's points.
    tri_ref = np.asarray(ref["tri_points"])
    assert (np.abs(got["tri_points"] - tri_ref) <= 1e-3 * (1 + np.abs(tri_ref))).all()


@pytest.mark.parametrize("scan_backend", ["torch", "step"])
def test_split_equals_oneshot(sequence, jax_state0, scan_backend, tmp_path, monkeypatch):
    """One call over frames 2.. against two calls with a checkpoint round trip
    between them, in the fused form and as the frame_step loop."""
    state0 = convert.vo_state_from_flat(_flat(jax_state0[0]))
    cam, cfg = tsyn.deep_camera(), _cfg(scan_backend=scan_backend)
    full_state, full = tpipe.continue_sequence(cam, cfg, state0, *_tensors(sequence, 2))
    state_a, out_a = tpipe.continue_sequence(cam, cfg, state0, *_tensors(sequence, 2, SPLIT))
    path = str(tmp_path / "state.npz")
    traj_a = np.concatenate([np.eye(4, dtype=np.float32)[None], jax_state0[1][None],
                             out_a.pose.numpy()])
    checkpoint.save_state(path, state_a, traj_a)
    state_l, traj_l = checkpoint.load_state(path, device="cpu")
    np.testing.assert_array_equal(traj_l, traj_a)
    for a, b in zip(convert.vo_state_to_arrays(state_a).values(),
                    convert.vo_state_to_arrays(state_l).values()):
        np.testing.assert_array_equal(a, b)
    state_b, out_b = tpipe.continue_sequence(cam, cfg, state_l, *_tensors(sequence, SPLIT))

    split = torch.cat([out_a.pose, out_b.pose])
    # The carried state is the whole pipeline state: split == one shot.
    np.testing.assert_array_equal(full.pose.numpy(), split.numpy())
    np.testing.assert_array_equal(full_state.point_lookup.numpy(), state_b.point_lookup.numpy())
    np.testing.assert_array_equal(full_state.map.valid.numpy(), state_b.map.valid.numpy())
    np.testing.assert_array_equal(full_state.map.appearances.numpy(),
                                  state_b.map.appearances.numpy())
    np.testing.assert_allclose(full_state.map.points.numpy(), state_b.map.points.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(full_state.history.numpy(), state_b.history.numpy(), atol=1e-5)
    for field in ("num_matches", "num_solver_corr", "num_inliers"):
        np.testing.assert_array_equal(
            getattr(full, field).numpy(),
            torch.cat([getattr(out_a, field), getattr(out_b, field)]).numpy())

    # And the whole-run entry point agrees, from the same bootstrap pose.
    monkeypatch.setattr(tpipe.epipolar_kernel, "estimate_transform_batched_plain",
                        lambda *a: torch.from_numpy(jax_state0[1].copy())[None])
    traj, m, _ = tpipe.run_sequence(cam, cfg, *_tensors(sequence)[:3])
    np.testing.assert_allclose(traj[2:].numpy(), split.numpy(), atol=5e-3)
    assert int(m.count) == int(state_b.map.count)


def test_step_and_fused_resume_agree(sequence, jax_state0):
    state0 = convert.vo_state_from_flat(_flat(jax_state0[0]))
    cam = tsyn.deep_camera()
    sf, of = tpipe.continue_sequence(cam, _cfg(scan_backend="torch"), state0,
                                     *_tensors(sequence, 2))
    ss, os_ = tpipe.continue_sequence(cam, _cfg(scan_backend="step"), state0,
                                      *_tensors(sequence, 2))
    np.testing.assert_allclose(of.pose.numpy(), os_.pose.numpy(), atol=2e-3)
    assert int(sf.map.count) == int(ss.map.count)
    np.testing.assert_array_equal(sf.map.appearances.numpy(), ss.map.appearances.numpy())
    np.testing.assert_array_equal(sf.point_lookup.numpy(), ss.point_lookup.numpy())
    np.testing.assert_allclose(sf.map.points.numpy(), ss.map.points.numpy(), atol=2e-2)


@pytest.mark.parametrize("backends", [("torch", "fused_interpret"), ("step", "xla")])
def test_continue_sequence_matches_jax(sequence, jax_state0, backends):
    port_backend, jax_backend = backends
    jstate0 = jax_state0[0]
    jcfg = JaxConfig(n_slots=S, map_capacity=256, gn_iterations=20, scan_backend=jax_backend,
                     solver_backend="xla", matcher_backend="xla")
    jstate, jout = jpipe.continue_sequence(jsyn.deep_camera(), jcfg, jstate0,
                                           *_jarrays(sequence, 2))
    state, out = tpipe.continue_sequence(
        tsyn.deep_camera(), _cfg(scan_backend=port_backend),
        convert.vo_state_from_flat(_flat(jstate0)), *_tensors(sequence, 2))
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(jout.pose), atol=1e-4)
    for field in ("num_matches", "num_solver_corr", "num_inliers"):
        np.testing.assert_array_equal(getattr(out, field).numpy(), np.asarray(getattr(jout, field)))
    got, ref = convert.vo_state_to_arrays(state), _flat(jstate)
    for key in ("point_lookup", "tri_valid", "map_valid", "map_count", "map_appearances"):
        np.testing.assert_array_equal(got[key], np.asarray(ref[key]), err_msg=key)
    pts_ref = np.asarray(ref["map_points"])
    assert (np.abs(got["map_points"] - pts_ref) <= 1e-3 * (1 + np.abs(pts_ref))).all()
    np.testing.assert_allclose(got["history"], np.asarray(ref["history"]), atol=1e-3)


def test_checkpoint_crosses_packages(sequence, jax_state0, tmp_path):
    """A file the JAX package wrote loads in the port and gives the same
    continuation as JAX resuming from it; and the reverse."""
    jstate0, x_init = jax_state0
    jcam, jcfg = jsyn.deep_camera(), JaxConfig(n_slots=S, map_capacity=256, gn_iterations=20,
                                               scan_backend="fused_interpret")
    jstate_a, jout_a = jpipe.continue_sequence(jcam, jcfg, jstate0, *_jarrays(sequence, 2, SPLIT))
    traj_a = np.concatenate([np.eye(4, dtype=np.float32)[None], x_init[None],
                             np.asarray(jout_a.pose)])
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save_state(jpath, jstate_a, traj_a)

    state_a, traj_l = checkpoint.load_state(jpath, device="cpu")
    np.testing.assert_array_equal(traj_l, traj_a)
    state_b, out_b = tpipe.continue_sequence(tsyn.deep_camera(), _cfg(), state_a,
                                             *_tensors(sequence, SPLIT))
    jstate_l, _ = jcheckpoint.load_state(jpath)
    jstate_b, jout_b = jpipe.continue_sequence(jcam, jcfg, jstate_l, *_jarrays(sequence, SPLIT))
    np.testing.assert_allclose(out_b.pose.numpy(), np.asarray(jout_b.pose), atol=1e-4)
    np.testing.assert_array_equal(state_b.map.appearances.numpy(),
                                  np.asarray(jstate_b.map.appearances))

    # The reverse: the port writes, the JAX package loads and continues.
    tpath = str(tmp_path / "port.npz")
    checkpoint.save_state(tpath, state_a, traj_a)
    jstate_r, jtraj_r = jcheckpoint.load_state(tpath)
    np.testing.assert_array_equal(jtraj_r, traj_a)
    for a, b in zip(_flat(jstate_r).values(), _flat(jstate_a).values()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, jout_r = jpipe.continue_sequence(jcam, jcfg, jstate_r, *_jarrays(sequence, SPLIT))
    np.testing.assert_array_equal(np.asarray(jout_r.pose), np.asarray(jout_b.pose))


def test_match_by_ids_and_known_da_match_jax(sequence, monkeypatch):
    pts, apps, masks, ids = sequence
    rng = np.random.default_rng(4)
    perm = np.stack([rng.permutation(S) for _ in range(F)])      # ids no longer sit at their slot
    take = lambda x: np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)), 1)
    shuffled = tuple(np.ascontiguousarray(take(x)) for x in (pts, apps, masks, ids))
    spts, sapps, smasks, sids = shuffled

    jc = jpipe.match_by_ids(*(jnp.asarray(x) for x in (sids[3], smasks[3], sids[4], smasks[4])))
    tc = tpipe.match_by_ids(*(torch.from_numpy(x) for x in (sids[3], smasks[3], sids[4],
                                                            smasks[4])))
    batched = tpipe.match_by_ids(*(torch.from_numpy(x) for x in (sids[:-1], smasks[:-1],
                                                                 sids[1:], smasks[1:])))
    for field in ("idx1", "idx2", "valid"):
        np.testing.assert_array_equal(getattr(tc, field).numpy(), np.asarray(getattr(jc, field)))
        np.testing.assert_array_equal(getattr(batched, field)[3].numpy(),
                                      getattr(tc, field).numpy())
    assert tc.idx2.dtype == torch.int32 and int(tc.valid.sum()) > 30

    jcfg = JaxConfig(n_slots=S, map_capacity=256, gn_iterations=20, scan_backend="fused_interpret")
    jtraj, jm, jo = jpipe.run_sequence_known_da(jsyn.deep_camera(), jcfg,
                                                *(jnp.asarray(x) for x in shuffled))
    monkeypatch.setattr(tpipe.epipolar_kernel, "estimate_transform_batched_plain",
                        lambda *a: torch.from_numpy(np.array(jtraj[1]))[None])
    traj, m, o = tpipe.run_sequence_known_da(tsyn.deep_camera(), _cfg(),
                                             *(torch.from_numpy(x) for x in shuffled))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=1e-4)
    for field in ("num_matches", "num_solver_corr", "num_inliers"):
        np.testing.assert_array_equal(getattr(o, field).numpy(), np.asarray(getattr(jo, field)))
    np.testing.assert_array_equal(m.appearances.numpy(), np.asarray(jm.appearances))
    # Appearance association finds the same pairs on this noise-free sequence.
    traj_app, _, o_app = tpipe.run_sequence(tsyn.deep_camera(), _cfg(),
                                            *(torch.from_numpy(x) for x in shuffled[:3]))
    np.testing.assert_array_equal(o_app.num_matches.numpy(), o.num_matches.numpy())


@pytest.fixture(scope="module")
def tracked_scene():
    """The recipe of tests/test_relocalize.py: a camera translating and slowly
    rotating past a landmark field, tracked by the JAX package into a map."""
    from visual_odometry_tpu.ops import se3 as jse3
    from visual_odometry_tpu.ops.camera import Camera, project_points

    rng = np.random.default_rng(3)
    frames = 24
    k = np.array([[180.0, 0.0, 320.0], [0.0, 180.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    camera = Camera.create(k, rows=480, cols=640, z_near=0, z_far=100.0)
    world = np.stack([rng.uniform(-1.5, 1.5, S), rng.uniform(-1.2, 1.2, S),
                      rng.uniform(2.0, 4.0, S)], axis=1).astype(np.float32)
    keys = jsyn.generate_appearances(rng, S)
    pts, masks = [], []
    for i in range(frames):
        v = np.float32([0.05 * i, -0.02 * i, 0.08 * i, 0.005 * i, -0.005 * i, 0.0025 * i])
        uv, valid = project_points(
            Camera.create(k, np.array(jse3.v2t_euler(jnp.asarray(v))), rows=480, cols=640,
                          z_near=0, z_far=100.0), jnp.asarray(world))
        pts.append(np.asarray(uv))
        masks.append(np.asarray(valid))
    pts, masks = np.stack(pts), np.stack(masks)
    apps_a = np.tile(keys[None], (frames, 1, 1))
    cfg = JaxConfig(n_slots=S, map_capacity=4096, gn_iterations=50)
    traj, map_state, _ = jpipe.run_sequence(camera, cfg, jnp.asarray(pts), jnp.asarray(apps_a),
                                            jnp.asarray(masks))
    return camera, cfg, map_state, pts, apps_a, masks, jabsolute(np.asarray(traj))


@pytest.mark.parametrize("precision", ["highest", "fast"])
def test_relocalize_frame_matches_jax(tracked_scene, precision):
    jcam, jcfg, jmap, pts, apps_a, masks, absolute = tracked_scene
    np.testing.assert_array_equal(tapps.absolute_from_relative(
        np.stack([np.eye(4, dtype=np.float32), absolute[1], absolute[2] @ np.linalg.inv(
            absolute[1])]))[:2], absolute[:2])
    tmap = convert.landmark_map_from_arrays(jmap.points, jmap.appearances, jmap.valid, jmap.count)
    cfg = VOConfig(n_slots=S, map_capacity=4096, gn_iterations=50, matcher_precision=precision)
    cam = tsyn.deep_camera()
    no_ids = np.full((S,), -1, np.int32)
    for f in (8, 16, 23):
        jframe = jpipe.FrameData(*(jnp.asarray(x) for x in (pts[f], apps_a[f], masks[f], no_ids)))
        jpose, jst, jn = jpipe.relocalize_frame(
            jcam, jcfg.replace(matcher_backend="pallas", solver_backend="xla",
                               matcher_precision=precision),
            jmap, jframe, jnp.asarray(absolute[f - 1]), interpret=True)
        frame = convert.frame_data_from_arrays(pts[f], apps_a[f], masks[f])
        pose, st, n = tpipe.relocalize_frame(cam, cfg, tmap, frame,
                                             torch.from_numpy(absolute[f - 1]))
        assert int(n) == int(jn) > 20
        assert int(st.num_inliers) == int(jst.num_inliers) > 20
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-4)
        # The bounds the JAX package holds itself to (tests/test_relocalize.py:91-92).
        pose = pose.numpy()
        assert np.linalg.norm(pose[:3, 3] - absolute[f][:3, 3]) < 0.05
        assert float(np.trace(np.eye(3) - pose[:3, :3].T @ absolute[f][:3, :3])) < 1e-3
