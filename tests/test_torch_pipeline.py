"""The port's main path end to end against the JAX package, on the CPU.

run_sequence is held against JAX run_sequence on its fused path through the
Pallas interpreter (scan_backend="fused_interpret", matcher_backend=
"pairs_pallas_interpret"); run_vo_complete against JAX run_vo_complete, whose
CPU default is the scan path.

Tolerances: the map's membership and slot order, match counts and inlier
counts are exact. Poses: 1e-4 against the fused interpreter, from a shared
bootstrap pose and with each package running its own 8-point bootstrap; 2e-3
on relative motions against the scan path (the repo's own fused-vs-scan
tolerance, tests/test_pipeline.py:331).

The 8-point bootstrap. The port forms the 9x9 normal matrix and its null
vector in float64 (ops/epipolar.estimate_fundamental): in float32 the
matrix's two smallest eigenvalues are closer than its rounding error on these
scenes, so the float32 pose is rounding noise at the 1e-2 level (the JAX
package's own value moves that far between its eager and its jitted
evaluation, test_float32_bootstrap_is_rounding_noise). "Its own bootstrap" on
the JAX side is therefore the JAX package's own ``estimate_transform``
evaluated in float64 (:func:`jax_bootstrap_in_double`), which the port then
meets at 1e-6 and the tracked chain at 1e-4.
"""

import contextlib

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu import apps as japps
from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

F, S = 10, 64


@pytest.fixture(scope="module")
def sequence():
    return jsyn.generate_tracking_sequence(np.random.default_rng(0), F, S, seed_motion=6.0)


@pytest.fixture(scope="module")
def jax_run(sequence):
    cfg = JaxConfig(n_slots=S, map_capacity=512, scan_backend="fused_interpret",
                    matcher_backend="pairs_pallas_interpret")
    traj, m, outs = jpipe.run_sequence(jsyn.deep_camera(), cfg, *(jnp.asarray(x) for x in sequence))
    return np.asarray(traj), m, outs


@contextlib.contextmanager
def jax_bootstrap_in_double():
    """Inside, the JAX pipeline's 8-point ``estimate_transform`` runs in
    float64 on the same float32 inputs and hands back a float32 pose; nothing
    else of the JAX program changes. Traces made before and inside are
    dropped, since they hold the function they were traced with."""
    float32_form = jpipe.epipolar.estimate_transform

    def in_double(*args):
        up = [a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a for a in args]
        return float32_form(*up).astype(jnp.float32)

    jax.clear_caches()
    jpipe.epipolar.estimate_transform = in_double
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jpipe.epipolar.estimate_transform = float32_form
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_run_double_bootstrap(sequence):
    cfg = JaxConfig(n_slots=S, map_capacity=512, scan_backend="fused_interpret",
                    matcher_backend="pairs_pallas_interpret")
    with jax_bootstrap_in_double():
        traj, m, outs = jpipe.run_sequence(jsyn.deep_camera(), cfg,
                                           *(jnp.asarray(x) for x in sequence))
        return np.asarray(traj), m, outs


def _port_run(sequence):
    return tpipe.run_sequence(tsyn.deep_camera(), VOConfig(n_slots=S, map_capacity=512),
                              *(torch.from_numpy(x) for x in sequence))


def _check_map_and_counts(port, ref):
    _, tm, to = port
    _, jm, jo = ref
    assert int(tm.count) == int(jm.count)
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(tm.appearances.numpy(), np.asarray(jm.appearances))
    for field in ("num_matches", "num_solver_corr", "num_inliers", "join_overflow"):
        np.testing.assert_array_equal(getattr(to, field).numpy(), np.asarray(getattr(jo, field)))
    np.testing.assert_array_equal(to.tri_valid.numpy(), np.asarray(jo.tri_valid))
    np.testing.assert_array_equal(to.tri_apps.numpy(), np.asarray(jo.tri_apps))


def test_run_sequence_matches_jax_fused_shared_bootstrap(sequence, jax_run, monkeypatch):
    """With the JAX bootstrap pose handed to the port, every tracked pose is
    within 1e-4 of the fused interpreter's and the map matches."""
    x_init = torch.from_numpy(jax_run[0][1].copy())
    monkeypatch.setattr(tpipe.epipolar, "estimate_transform", lambda *a: x_init)
    port = _port_run(sequence)
    np.testing.assert_allclose(port[0].numpy(), jax_run[0], atol=1e-4)
    _check_map_and_counts(port, jax_run)
    pts_ref = np.asarray(jax_run[1].points)
    assert (np.abs(port[1].points.numpy() - pts_ref) <= 1e-3 * (1 + np.abs(pts_ref))).all()


def test_run_sequence_matches_jax_fused(sequence, jax_run_double_bootstrap):
    """Each package with its own bootstrap (the JAX package's evaluated in
    float64, module docstring): the bootstrap pose within 1e-6, every tracked
    pose within 1e-4, the map's landmarks and order and every count exact."""
    port = _port_run(sequence)
    ref = jax_run_double_bootstrap
    np.testing.assert_allclose(port[0][1].numpy(), ref[0][1], atol=1e-6)
    np.testing.assert_allclose(port[0].numpy(), ref[0], atol=1e-4)
    _check_map_and_counts(port, ref)


def test_float32_bootstrap_is_rounding_noise(sequence, jax_run, jax_run_double_bootstrap):
    """Why the port does not follow the JAX package's float32 8-point pose: on
    this scene (64 exact correspondences) the JAX float32 value is further
    than 1e-3 from the same function's float64 value (measured 1.6e-2), and
    the port's is within 1e-6 of the latter."""
    float32_pose, float64_pose = jax_run[0][1], jax_run_double_bootstrap[0][1]
    assert np.abs(float32_pose - float64_pose).max() > 1e-3
    port_pose = _port_run(sequence)[0][1].numpy()
    assert np.abs(port_pose - float64_pose).max() < 1e-6


def test_fused_join_depth_overflow_raises(rng, monkeypatch):
    """Multiplicity 3 against depth 2 raises; depth 3 clears the guard and,
    from the JAX run's bootstrap pose (this 10-point scene's 8-point estimate
    is too ill-conditioned to share triangulation validity otherwise), gives
    the JAX fused path's solver correspondence and inlier counts."""
    from test_pipeline import _duplicate_heavy_sequence

    pts, apps, masks = _duplicate_heavy_sequence(rng, multiplicity=3)
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (pts, apps, masks))
    cfg = VOConfig(n_slots=16, map_capacity=64, gn_iterations=10)
    with pytest.raises(tpipe.FusedJoinDepthError):
        tpipe.run_sequence(tsyn.default_camera(), cfg, *tensors)
    jcfg = JaxConfig(n_slots=16, map_capacity=64, gn_iterations=10, fused_join_depth=3,
                     scan_backend="fused_interpret")
    jtraj, _, jouts = jpipe.run_sequence(jsyn.default_camera(), jcfg,
                                         *(jnp.asarray(x) for x in (pts, apps, masks)))
    x_init = torch.from_numpy(np.array(jtraj[1]))
    monkeypatch.setattr(tpipe.epipolar, "estimate_transform", lambda *a: x_init)
    traj, _, outs = tpipe.run_sequence(tsyn.default_camera(), cfg.replace(fused_join_depth=3),
                                       *tensors)
    assert int(outs.join_overflow.sum()) == 0
    np.testing.assert_array_equal(outs.num_solver_corr.numpy(), np.asarray(jouts.num_solver_corr))
    np.testing.assert_array_equal(outs.num_inliers.numpy(), np.asarray(jouts.num_inliers))
    # The JAX package holds this 10-point workload to 2e-3 (test_pipeline.py:331).
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), atol=2e-3)


def test_check_bootstrap_raises_below_eight_matches():
    pts = torch.zeros((S, 2))
    apps = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (S, 10)).astype(np.float32))
    mask = torch.zeros(S, dtype=torch.bool)
    mask[:5] = True
    ids = torch.full((S,), -1, dtype=torch.int32)
    f = tpipe.FrameData(pts, apps, mask, ids)
    with pytest.raises(tpipe.BootstrapError):
        tpipe.check_bootstrap(VOConfig(n_slots=S), f, f)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.run_sequence(tsyn.default_camera(), VOConfig(n_slots=S, num_chunks=2),
                           pts[None].expand(3, S, 2), apps[None].expand(3, S, 10),
                           mask[None].expand(3, S))


def _relative(poses):
    inv = np.linalg.inv(poses[:-1].astype(np.float64))
    return inv @ poses[1:].astype(np.float64)


def test_run_vo_complete_matches_jax(tmp_path):
    """The CLI on a generated dataset writes the JAX app's files: world,
    ground truth and map appearances identical (same landmarks, same slot
    order), relative robot motions within 2e-3 of the scan path's, the same
    metrics to 1e-3, and the accuracy bounds of tests/test_dataset_gen.py."""
    data, out_t, out_j = (str(tmp_path / n) for n in ("data", "port", "jax"))
    jdg.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    assert tapps.main(["vo_complete", data, out_t, "--device", "cpu"]) == 0
    assert tapps.main(["evaluation", data, out_t]) == 0
    japps.run_vo_complete(data, out_j, verbose=False)
    res_j = japps.run_evaluation(data, out_j, verbose=False)
    res_t = tapps.run_evaluation(data, out_t, verbose=False)

    for name in ("world.txt", "trajectory_gt.txt", "map_appearances.txt"):
        assert open(os.path.join(out_t, name)).read() == open(os.path.join(out_j, name)).read()
    expected = {"world.txt", "map.txt", "map_appearances.txt", "trajectory_gt.txt",
                "trajectory_est_complete.txt", "trajectory_est_data.txt", "out_performance.txt",
                "map_corrected.txt", "arrows.txt", "world_pruned.txt"}
    assert expected <= set(os.listdir(out_t))

    def poses(d):
        from visual_odometry_tpu_torch.utils import io

        return io.load_est_trajectory(os.path.join(d, "trajectory_est_data.txt"))

    rel_t, rel_j = _relative(poses(out_t)), _relative(poses(out_j))
    np.testing.assert_allclose(rel_t[:, :3, :3], rel_j[:, :3, :3], atol=2e-3)
    np.testing.assert_allclose(rel_t[:, :3, 3], rel_j[:, :3, 3], atol=2e-3)
    assert abs(res_t.scale - res_j.scale) < 1e-3 * res_j.scale
    assert abs(res_t.rmse_position - res_j.rmse_position) < 1e-3
    finite = np.isfinite(res_t.orientation_errors)
    assert np.abs(res_t.orientation_errors[finite]).mean() < 1e-4
    assert res_t.rmse_position < 0.2 and res_t.n_map_matched > 100
