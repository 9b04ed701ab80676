"""The planar (est_SE2) estimation group of the port against the JAX package,
on the CPU: kernel K5's plain version against the JAX fused frame kernel with
``planar=True`` in interpret mode, and the ``frame_step`` loop
(``scan_backend="step"``) against both the port's fused path and JAX's scan.

The sequence is ``generate_tracking_sequence`` at ``seed_motion=6``, the
low-amplification setting: the monocular chain then grows a last-ulp
difference by little, so the tolerances test the arithmetic and not the
scene's conditioning. Tolerances: poses to 1e-4 against the fused interpreter
from a shared bootstrap pose (two float32 programs with sums in different
orders over 8 frames); 2e-3 between the fused form and the frame_step loop
(the repo's fused-vs-scan tolerance, tests/test_pipeline.py:331: Schur form
against Cholesky); the planar-subgroup deviation below 1e-4 (the bound of the
JAX package's selfcheck). Counts and map layout are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.ops import se3 as jse3
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.ops import se3
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

F, S = 10, 64
MOUNT = np.array(jse3.v2t_euler(jnp.float32([0.05, -0.1, 0.02, 0.01, -0.02, 0.015])))


@pytest.fixture(scope="module")
def sequence():
    return jsyn.generate_tracking_sequence(np.random.default_rng(0), F, S, seed_motion=6.0)


def _jax_run(sequence, planar, **kw):
    cfg = JaxConfig(n_slots=S, map_capacity=512, gn_iterations=30, **kw)
    if planar:
        cfg = cfg.with_planar_mount(MOUNT)
    traj, m, outs = jpipe.run_sequence(jsyn.deep_camera(), cfg, *(jnp.asarray(x) for x in sequence))
    return np.asarray(traj), m, outs


def _port_run(sequence, planar, **kw):
    cfg = VOConfig(n_slots=S, map_capacity=512, gn_iterations=30, **kw)
    if planar:
        cfg = cfg.with_planar_mount(MOUNT)
    return tpipe.run_sequence(tsyn.deep_camera(), cfg, *(torch.from_numpy(x) for x in sequence))


@pytest.fixture(scope="module")
def jax_fused_planar(sequence):
    return _jax_run(sequence, True, scan_backend="fused_interpret",
                    matcher_backend="pairs_pallas_interpret")


def _share_bootstrap(monkeypatch, x_init):
    """The port takes the JAX run's bootstrap pose as its two-view estimate.
    In a planar run that pose is already planarized; planarizing it again
    changes it by rounding only."""
    pose = torch.from_numpy(np.array(x_init))
    monkeypatch.setattr(tpipe.epipolar_kernel, "estimate_transform_batched_plain",
                        lambda *a: pose[None])


def test_planar_fused_plain_matches_jax_kernel(sequence, jax_fused_planar, monkeypatch):
    jtraj, jm, jo = jax_fused_planar
    _share_bootstrap(monkeypatch, jtraj[1])
    traj, m, o = _port_run(sequence, True)
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=1e-4)
    assert se3.planar_deviation(traj, torch.from_numpy(MOUNT)) < 1e-4
    assert se3.planar_deviation(torch.from_numpy(jtraj.copy()), torch.from_numpy(MOUNT)) < 1e-4
    for field in ("num_matches", "num_solver_corr", "num_inliers", "join_overflow"):
        np.testing.assert_array_equal(getattr(o, field).numpy(), np.asarray(getattr(jo, field)))
    np.testing.assert_array_equal(o.tri_valid.numpy(), np.asarray(jo.tri_valid))
    assert int(m.count) == int(jm.count)
    np.testing.assert_array_equal(m.appearances.numpy(), np.asarray(jm.appearances))


def test_planar_own_bootstrap_is_planar_and_differs_from_se3(sequence):
    """Each package on its own bootstrap: the port's planar trajectory lies in
    the conjugated subgroup, and it is a different estimate from the SE(3) one
    (the sequence's motion is not planar)."""
    traj, _, _ = _port_run(sequence, True)
    assert bool(torch.isfinite(traj).all())
    assert se3.planar_deviation(traj, torch.from_numpy(MOUNT)) < 1e-4
    traj3, _, _ = _port_run(sequence, False)
    assert se3.planar_deviation(traj3, torch.from_numpy(MOUNT)) > 1e-3


@pytest.mark.parametrize("planar", [False, True])
def test_step_loop_matches_fused_and_jax_scan(sequence, planar, monkeypatch):
    """``scan_backend="step"`` (frame_step per frame, ops/picp.solve or
    picp_se2.solve_se2) against the port's fused plain path, and against the
    JAX package's ``scan_backend="xla"``, from JAX's bootstrap pose."""
    jtraj, jm, jo = _jax_run(sequence, planar, scan_backend="xla", solver_backend="xla",
                             matcher_backend="xla")
    _share_bootstrap(monkeypatch, jtraj[1])
    traj_s, m_s, o_s = _port_run(sequence, planar, scan_backend="step")
    traj_f, m_f, o_f = _port_run(sequence, planar, scan_backend="torch")
    np.testing.assert_allclose(traj_s.numpy(), traj_f.numpy(), atol=2e-3)
    np.testing.assert_allclose(traj_s.numpy(), jtraj, atol=1e-4)
    assert int(o_s.join_overflow.sum()) == 0
    for field in ("num_matches", "num_solver_corr", "num_inliers"):
        np.testing.assert_array_equal(getattr(o_s, field).numpy(), np.asarray(getattr(jo, field)))
        np.testing.assert_array_equal(getattr(o_s, field).numpy(), getattr(o_f, field).numpy())
    assert int(m_s.count) == int(m_f.count) == int(jm.count)
    np.testing.assert_array_equal(m_s.appearances.numpy(), np.asarray(jm.appearances))
    if planar:
        assert se3.planar_deviation(traj_s, torch.from_numpy(MOUNT)) < 1e-4


def _collapse_frame(traj):
    """The first frame whose pose is non-finite or whose translation is under
    1e-3 of the bootstrap's, or None."""
    t = np.linalg.norm(np.asarray(traj)[:, :3, 3], axis=-1)
    for f in range(2, len(t)):
        if not np.isfinite(np.asarray(traj)[f]).all() or t[f] < 1e-3 * t[1]:
            return f
    return None


def test_planar_model_on_6dof_motion_collapses_in_both_packages():
    """The card's 6-DoF planar input (test_torch_cuda.py::
    test_planar_run_sequence_and_relocalize_cuda[six_dof]: seed 1, 24 frames
    x 128 slots, its mount) through both packages from the same bootstrap
    pose, JAX's 8-point step evaluated in float64 as the port's kernel does:
    on motion outside its subgroup the planar model shrinks the monocular
    scale by more than 1e3 within 16 frames in each, and then the poses turn
    non-finite (JAX's lax.scan at frame 15, the port's fused plain path at 14,
    here). JAX's own float32 bootstrap draws another pose (1.2% off in
    translation at frame 1), from which the scale shrinks by about 90x and
    stays finite over the 24 frames."""
    from test_torch_pipeline import jax_bootstrap_in_double

    seq = jsyn.generate_tracking_sequence(np.random.default_rng(1), 24, 128)
    v = (0.2, -0.1, 0.3, -1.2, 0.1, 0.3)
    mount = np.array(jse3.v2t_euler(jnp.float32(v)))
    jcfg = JaxConfig(n_slots=128, map_capacity=256, scan_backend="xla").with_planar_mount(mount)
    with jax_bootstrap_in_double():
        jtraj, _, _ = jpipe.run_sequence(jsyn.deep_camera(), jcfg, *(jnp.asarray(x) for x in seq))
    cfg = VOConfig(n_slots=128, map_capacity=256).with_planar_mount(
        se3.v2t_euler(torch.tensor(v)).numpy())
    traj, _, _ = tpipe.run_sequence(tsyn.deep_camera(), cfg, *(torch.from_numpy(x) for x in seq))
    np.testing.assert_allclose(traj[1].numpy(), np.asarray(jtraj[1]), atol=1e-4)
    for t in (np.asarray(jtraj), traj.numpy()):
        first = _collapse_frame(t)
        assert first is not None and first < 16
        assert not np.isfinite(t).all()
