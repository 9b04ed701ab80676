"""Global refinement of the port against the JAX package, on the CPU: the
dense Schur step, the sparse step against the dense one, and both
``refine_trajectory`` forms on a tracked reference-format sequence.

Tolerances: one dense ``ba_step`` on the scene of
tests/test_bundle_adjustment.py: poses within 1e-4, landmarks within 5e-4, chi
within 1e-5 relative (the same reduced system through another Cholesky).
Sparse against dense, as tests/test_sparse_ba.py:91 holds the JAX package:
poses 1e-4, landmarks 5e-4. ``refine_trajectory*`` from one shared tracked
trajectory and map: positions (relative translations and landmarks) within
1e-3 of the JAX package's after 5 iterations.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import landmark_map as jlm
from visual_odometry_tpu.models import refinement as jref
from visual_odometry_tpu.parallel import bundle_adjustment as jba
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.models import refinement as tref
from visual_odometry_tpu_torch.ops.camera import Camera
from visual_odometry_tpu_torch.parallel import bundle_adjustment as tba
from visual_odometry_tpu_torch.parallel import sparse_ba as tsba
from visual_odometry_tpu_torch.utils import convert, io
from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

from test_bundle_adjustment import _make_problem
from test_sparse_ba import _problems


def T(x):
    return torch.from_numpy(np.array(x))


def _dense_to_port(jproblem):
    return convert.ba_problem_from_arrays(
        **{k: np.asarray(v) for k, v in jproblem._asdict().items()})


@pytest.mark.parametrize("fix_first", [True, False])
def test_ba_step_matches_jax(rng, fix_first):
    cam, pj, *_ = _make_problem(rng)
    pt = _dense_to_port(pj)
    rj, sj = jba.ba_step(cam.camera_matrix, pj, damping=0.1, fix_first=fix_first)
    rt, st = tba.ba_step(T(np.asarray(cam.camera_matrix)), pt, damping=0.1, fix_first=fix_first)
    out = convert.ba_solution_to_arrays(rt)
    np.testing.assert_allclose(out["poses"], np.asarray(rj.poses), atol=1e-4)
    np.testing.assert_allclose(out["landmarks"], np.asarray(rj.landmarks), atol=5e-4)
    np.testing.assert_allclose(float(st.chi), float(sj.chi), rtol=1e-5)
    assert int(st.num_obs) == int(sj.num_obs)
    if fix_first:
        assert torch.equal(rt.poses[0], pt.poses[0])


def test_refine_recovers_the_scene(rng):
    """tests/test_bundle_adjustment.py's convergence check on the port."""
    cam, pj, gt_poses, world, _ = _make_problem(rng)
    refined, stats = tba.refine(T(np.asarray(cam.camera_matrix)), _dense_to_port(pj),
                                num_iterations=15, damping=0.1)
    np.testing.assert_allclose(refined.poses.numpy(), gt_poses, atol=2e-3)
    np.testing.assert_allclose(refined.landmarks.numpy(), world, atol=2e-2)
    assert float(stats.chi) < 1e-2


def test_sparse_step_matches_dense_step(rng):
    """The CG solve against the dense Cholesky solve of the same reduced
    system (tests/test_sparse_ba.py:91), both in the port."""
    cam, dense_j, sparse_j, *_ = _problems(rng)
    k = T(np.asarray(cam.camera_matrix))
    dense = _dense_to_port(dense_j)
    sparse = convert.sparse_ba_problem_from_arrays(
        **{name: np.asarray(v) for name, v in sparse_j._asdict().items()})
    d_out, d_stats = tba.ba_step(k, dense, damping=0.1)
    s_out, s_stats = tsba.sparse_ba_step(k, sparse, damping=0.1, cg_iterations=200,
                                         cg_tolerance=1e-10)
    assert int(d_stats.num_obs) == int(s_stats.num_obs)
    np.testing.assert_allclose(float(s_stats.chi), float(d_stats.chi), rtol=1e-5)
    np.testing.assert_allclose(s_out.poses.numpy(), d_out.poses.numpy(), atol=1e-4)
    np.testing.assert_allclose(s_out.landmarks.numpy(), d_out.landmarks.numpy(), atol=5e-4)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dataset") / "data")
    jdg.generate_dataset(d, num_frames=40, num_landmarks=400, seed=1)
    return d


@pytest.fixture(scope="module")
def tracked(data_dir):
    """The dataset tracked once by the port on the CPU: what both packages refine."""
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device="cpu")
    seq = io.load_sequence(data_dir, DEFAULT_CONFIG.n_slots)
    traj, map_state, _ = tpipe.run_sequence(
        camera, DEFAULT_CONFIG, *(torch.from_numpy(x) for x in (seq.points, seq.appearances,
                                                                seq.mask)))
    return params.camera_matrix, traj.numpy(), map_state, seq


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_refine_trajectory_matches_jax(tracked, backend):
    """Both packages refine the same tracked trajectory and map for 5
    iterations: relative translations and landmarks within 1e-3, rotations
    within 1e-4, the appearance keys untouched; pose 0 stays the identity."""
    k, traj, map_state, seq = tracked
    jmap = jlm.LandmarkMap(points=jnp.asarray(map_state.points.numpy()),
                           appearances=jnp.asarray(map_state.appearances.numpy()),
                           valid=jnp.asarray(map_state.valid.numpy()),
                           count=jnp.asarray(map_state.count.numpy()))
    args = (seq.points, seq.appearances, seq.mask)
    if backend == "dense":
        ref = jref.refine_trajectory(k, traj, jmap, *args, num_iterations=5)
        got = tref.refine_trajectory(k, traj, map_state, *args, num_iterations=5, device="cpu")
    else:
        ref = jref.refine_trajectory_sparse(k, traj, jmap, *args, num_iterations=5)
        got = tref.refine_trajectory_sparse(k, traj, map_state, *args, num_iterations=5,
                                            device="cpu")
    assert isinstance(got[0], np.ndarray) and got[0].shape == traj.shape
    np.testing.assert_allclose(got[0][:, :3, 3], ref[0][:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got[0][:, :3, :3], ref[0][:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[0][0], np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(float(got[3].chi), float(ref[3].chi), rtol=1e-3)
    assert float(got[3].chi) > 0.0 and int(got[3].num_obs) == int(ref[3].num_obs)
    assert np.abs(got[0] - traj).max() > 1e-6     # the refinement moved something


def test_relative_absolute_round_trip(tracked):
    _, traj, _, _ = tracked
    absolute = tref.absolute_from_relative(traj)
    np.testing.assert_array_equal(absolute, jref.absolute_from_relative(traj))
    np.testing.assert_array_equal(tref.relative_from_absolute(absolute),
                                  jref.relative_from_absolute(absolute))
    np.testing.assert_allclose(tref.relative_from_absolute(absolute), traj, atol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_run_vo_complete_with_refinement(data_dir, tmp_path, backend):
    """``vo_complete`` with ``refine_iterations=5`` writes the refined
    trajectory and map for both backends; the evaluation reads them. Bundle
    adjustment lowers the reprojection error; on this dataset the aligned
    position and map errors then move by a few percent either way (here
    RMSE_position 0.05755 -> 0.05792, RMSE_map 0.1429 -> 0.1350), so both are
    held within 10% of the unrefined run's."""
    plain_dir, out = str(tmp_path / "plain"), str(tmp_path / backend)
    tapps.run_vo_complete(data_dir, plain_dir, verbose=False, device="cpu")
    cfg = DEFAULT_CONFIG.replace(refine_iterations=5, refine_backend=backend)
    traj, map_state, _, _ = tapps.run_vo_complete(data_dir, out, cfg, verbose=False, device="cpu")
    assert {"map.txt", "map_appearances.txt", "trajectory_est_complete.txt",
            "trajectory_est_data.txt"} <= set(os.listdir(out))
    assert np.isfinite(traj).all()
    unrefined = io.load_est_trajectory(os.path.join(plain_dir, "trajectory_est_data.txt"))
    refined = io.load_est_trajectory(os.path.join(out, "trajectory_est_data.txt"))
    assert refined.shape == unrefined.shape and np.abs(refined - unrefined).max() > 1e-6
    assert (open(os.path.join(out, "map_appearances.txt")).read()
            == open(os.path.join(plain_dir, "map_appearances.txt")).read())
    res = tapps.run_evaluation(data_dir, out, verbose=False)
    res_plain = tapps.run_evaluation(data_dir, plain_dir, verbose=False)
    assert res.rmse_map <= res_plain.rmse_map * 1.1
    assert res.rmse_position <= res_plain.rmse_position * 1.1
    assert res.n_map_matched == res_plain.n_map_matched


def test_mesh_raises(tracked):
    """Dense refinement steps a batch of one sequence, as the JAX package's
    does: a mesh with a dp axis wider than 1, or none, raises before any work
    (the sharded forms themselves: tests/test_torch_sharded_tracking.py)."""
    k, traj, map_state, seq = tracked
    for shape, message in (({"dp": 2, "lm": 2}, "does not divide the mesh's dp axis of size 2"),
                           ({"lm": 4}, "mesh axes \\('lm',\\) have no axis 'dp'")):
        mesh = types.SimpleNamespace(shape=shape, axis_names=tuple(shape))
        with pytest.raises(ValueError, match=message):
            tref.refine_trajectory(k, traj, map_state, seq.points, seq.appearances, seq.mask,
                                   mesh=mesh, device="cpu")
