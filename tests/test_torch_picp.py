"""The port's PICP solvers against the JAX package, on the CPU.

``ops/picp`` and ``ops/picp_se2`` (linearize, one round, whole solve) are held
against their JAX counterparts on the same numpy inputs. Kernel K6's plain
versions (``picp_kernel.solve_fused_plain`` / ``solve_se2_fused_plain``) are
held against the JAX Pallas kernels ``solve_fused`` / ``solve_se2_fused`` in
interpret mode.

Tolerances: float32 sums taken in different orders, so H and b agree to 1e-5
of the system's largest entry and poses to 1e-5 absolute; the chi statistics
to 1e-4 relative (plus 1e-5 absolute), since a 1e-6 pose difference moves a
sum of a hundred squared pixel residuals by about that; inlier counts are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops import picp as jpicp
from visual_odometry_tpu.ops import picp_se2 as jpicp_se2
from visual_odometry_tpu.ops import se3 as jse3
from visual_odometry_tpu.ops.camera import project_points as jproject
from visual_odometry_tpu.ops.pallas import picp_kernel as jkernel
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu_torch.ops import linalg6, picp, picp_se2, se3, stats
from visual_odometry_tpu_torch.ops.kernels import picp_kernel
from visual_odometry_tpu_torch.utils import synthetic as tsyn

MOUNT_V = np.float32([0.2, -0.1, 0.3, -1.2, 0.1, 0.3])
POSE_TOL = 1e-5


def _scene(n, planar, seed=0, noise=0.3):
    """World points, measurements under a ground-truth pose (pixel noise and a
    few gross outliers), live weights with dead slots."""
    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(2.0, 4.0, n)], 1).astype(np.float32)
    mount = np.asarray(jse3.v2t_euler(jnp.asarray(MOUNT_V)))
    if planar:
        d = np.asarray(jse3.v2t_se2(jnp.asarray(np.float32([0.1, -0.05, 0.04]))))
        gt = (np.linalg.inv(mount) @ d @ mount).astype(np.float32)
    else:
        gt = np.asarray(jse3.v2t_euler(jnp.asarray(np.float32([0.1, -0.05, 0.02, 0.01, 0.02, -0.03]))))
    uv, ok = jproject(jsyn.default_camera(gt), jnp.asarray(world))
    uv = np.array(uv) + rng.normal(0, noise, (n, 2)).astype(np.float32)
    uv[::17] += 150.0                      # gross outliers for the robust kernel
    w = np.array(ok, np.float32)
    w[::9] = 0.0                           # dead slots
    return world, uv.astype(np.float32), w, gt, mount


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _close_system(h, b, jh, jb):
    scale = float(np.abs(np.asarray(jh)).max())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5 * scale)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb),
                               atol=1e-5 * max(float(np.abs(np.asarray(jb)).max()), 1.0))


def _close_stats(st, jst):
    assert int(st.num_inliers) == int(jst.num_inliers)
    for a, b in ((st.chi_inliers, jst.chi_inliers), (st.chi_outliers, jst.chi_outliers)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("keep_outliers", [False, True])
def test_linearize_and_one_round_match_jax(keep_outliers):
    world, uv, w, gt, _ = _scene(200, planar=False)
    start = np.asarray(jse3.v2t_euler(jnp.asarray(np.float32([0.05, 0, 0, 0, 0.01, 0]))))
    jcam, tcam = jsyn.default_camera(start), tsyn.default_camera(start)
    kt = 400.0
    jh, jb, jst = jpicp.linearize(jcam, jnp.asarray(world), jnp.asarray(uv), jnp.asarray(w),
                                  jnp.float32(kt), keep_outliers)
    h, b, st = picp.linearize(tcam, *_t(world, uv, w), kt, keep_outliers)
    _close_system(h, b, jh, jb)
    _close_stats(st, jst)
    assert int(st.num_inliers) < int(w.sum())   # the outliers were classified

    jcam2, jst2, jdx = jpicp.one_round(jcam, jnp.asarray(world), jnp.asarray(uv), jnp.asarray(w),
                                       jnp.float32(kt), jnp.float32(1.0), keep_outliers)
    cam2, st2, dx = picp.one_round(tcam, *_t(world, uv, w), kt, 1.0, keep_outliers)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=POSE_TOL)
    np.testing.assert_allclose(cam2.world_in_camera.numpy(), np.asarray(jcam2.world_in_camera),
                               atol=POSE_TOL)
    _close_stats(st2, jst2)


@pytest.mark.parametrize("tolerance,min_iterations", [(0.0, 1), (1e-12, 1), (1e-3, 4)])
def test_solve_matches_jax(tolerance, min_iterations):
    world, uv, w, gt, _ = _scene(300, planar=False)
    world[::9] = np.nan                    # garbage in dead slots is sanitized by solve
    kw = dict(kernel_threshold=400.0, tolerance=tolerance, min_iterations=min_iterations)
    jcam, jst = jpicp.solve(jsyn.default_camera(), jnp.asarray(world), jnp.asarray(uv),
                            jnp.asarray(w), 15, backend="xla", **kw)
    cam, st = picp.solve(tsyn.default_camera(), *_t(world, uv, w), 15, backend="auto", **kw)
    np.testing.assert_allclose(cam.world_in_camera.numpy(), np.asarray(jcam.world_in_camera),
                               atol=POSE_TOL)
    _close_stats(st, jst)
    assert np.abs(cam.world_in_camera.numpy() - gt).max() < 5e-3


def test_linearize_and_one_round_se2_match_jax():
    world, uv, w, gt, mount = _scene(200, planar=True)
    jcam, tcam = jsyn.default_camera(), tsyn.default_camera()
    kt = 400.0
    jh, jb, jst = jpicp_se2.linearize_se2(jcam, jnp.asarray(world), jnp.asarray(uv),
                                          jnp.asarray(w), jnp.float32(kt), jnp.asarray(mount))
    h, b, st = picp_se2.linearize_se2(tcam, *_t(world, uv, w), kt, torch.from_numpy(mount))
    assert h.shape == (3, 3) and b.shape == (3,)
    _close_system(h, b, jh, jb)
    _close_stats(st, jst)
    minv = np.asarray(jse3.inverse(jnp.asarray(mount)))
    jcam2, _, jdx = jpicp_se2.one_round_se2(
        jcam, jnp.asarray(world), jnp.asarray(uv), jnp.asarray(w), jnp.float32(kt),
        jnp.float32(1.0), jnp.asarray(mount), jnp.asarray(minv))
    cam2, _, dx = picp_se2.one_round_se2(tcam, *_t(world, uv, w), kt, 1.0,
                                         *_t(mount, minv))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=POSE_TOL)
    np.testing.assert_allclose(cam2.world_in_camera.numpy(), np.asarray(jcam2.world_in_camera),
                               atol=POSE_TOL)


@pytest.mark.parametrize("use_mount", [True, False])
def test_solve_se2_matches_jax(use_mount):
    world, uv, w, gt, mount = _scene(300, planar=True)
    if not use_mount:   # cam_in_robot=None is the identity mount
        d = np.asarray(jse3.v2t_se2(jnp.asarray(np.float32([0.1, -0.05, 0.04]))))
        uv = np.array(jproject(jsyn.default_camera(d), jnp.asarray(world))[0])
    kw = dict(kernel_threshold=400.0, tolerance=1e-12)
    jcam, jst = jpicp_se2.solve_se2(jsyn.default_camera(), jnp.asarray(world), jnp.asarray(uv),
                                    jnp.asarray(w), 15,
                                    cam_in_robot=jnp.asarray(mount) if use_mount else None, **kw)
    cam, st = picp_se2.solve_se2(tsyn.default_camera(), *_t(world, uv, w), 15,
                                 cam_in_robot=torch.from_numpy(mount) if use_mount else None,
                                 **kw)
    np.testing.assert_allclose(cam.world_in_camera.numpy(), np.asarray(jcam.world_in_camera),
                               atol=POSE_TOL)
    _close_stats(st, jst)
    # The solved relative robot motion stays in SE(2): c X c^-1 has no z, roll or pitch.
    c = mount if use_mount else np.eye(4, dtype=np.float32)
    robot = c @ cam.world_in_camera.numpy() @ np.linalg.inv(c)
    planar = np.asarray(jse3.project_se2(jnp.asarray(robot)))
    assert np.abs(robot - planar).max() < 1e-5


def _fused(planar, world, uv, w, mount, iterations, tol, min_inl, min_iterations=1,
           start=None):
    """(port plain K6, JAX Pallas kernel in interpret mode) on the same inputs."""
    start = np.eye(4, dtype=np.float32) if start is None else start
    jcam, tcam = jsyn.default_camera(start), tsyn.default_camera(start)
    jpar = jnp.stack([jcam.z_near, jcam.z_far, jcam.cols, jcam.rows])
    jargs = (jnp.asarray(world), jnp.asarray(uv), jnp.asarray(w), iterations, jnp.float32(400.0),
             jnp.float32(1.0), jnp.float32(tol))
    jkw = dict(interpret=True, min_num_inliers=jnp.float32(min_inl), min_iterations=min_iterations)
    targs = _t(world, uv, w) + (iterations, 400.0, 1.0, tol)
    tkw = dict(min_num_inliers=min_inl, min_iterations=min_iterations)
    if planar:
        jout = jkernel.solve_se2_fused(jcam.camera_matrix, jcam.world_in_camera, jpar,
                                       jnp.asarray(mount), *jargs, **jkw)
        out = picp_kernel.solve_se2_fused_plain(tcam.camera_matrix, tcam.world_in_camera,
                                                tcam.params(), torch.from_numpy(mount), *targs,
                                                **tkw)
    else:
        jout = jkernel.solve_fused(jcam.camera_matrix, jcam.world_in_camera, jpar, *jargs, **jkw)
        out = picp_kernel.solve_fused_plain(tcam.camera_matrix, tcam.world_in_camera,
                                            tcam.params(), *targs, **tkw)
    return out, jout


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("n", [100, 1500])   # 1500: more points than one block's threads
@pytest.mark.parametrize("tol", [-1.0, 1e-12])   # fixed budget, tolerance exit
def test_fused_solve_plain_matches_jax_kernel(planar, n, tol):
    world, uv, w, gt, mount = _scene(n, planar)
    (pose, st), (jpose, jst) = _fused(planar, world, uv, w, mount, 12, tol, 0.0)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=POSE_TOL)
    _close_stats(st, jst)
    assert np.abs(pose.numpy() - gt).max() < 5e-3


@pytest.mark.parametrize("planar", [False, True])
def test_fused_solve_edge_cases_match_jax_kernel(planar):
    world, uv, w, gt, mount = _scene(100, planar)
    start = np.asarray(jse3.v2t_se2(jnp.asarray(np.float32([0.02, 0.0, 0.01]))))
    # min_num_inliers above the count: the pose must stay.
    (pose, st), (jpose, jst) = _fused(planar, world, uv, w, mount, 12, 1e-12, 1e9, start=start)
    np.testing.assert_allclose(pose.numpy(), start, atol=1e-6)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=POSE_TOL)
    _close_stats(st, jst)
    # All-zero weights: the pose stays and everything is finite.
    (pose, st), (jpose, jst) = _fused(planar, world, uv, 0.0 * w, mount, 12, 1e-12, 0.0,
                                      start=start)
    assert np.isfinite(pose.numpy()).all()
    np.testing.assert_allclose(pose.numpy(), start, atol=1e-6)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=POSE_TOL)
    assert int(st.num_inliers) == 0 == int(jst.num_inliers)
    # NaN in dead slots, sanitized by the caller as ops/picp.solve does.
    bad = world.copy()
    bad[w == 0] = np.nan
    clean = np.where(w[:, None] > 0, bad, 1.0).astype(np.float32)
    (pose, st), (jpose, jst) = _fused(planar, clean, uv, w, mount, 12, 1e-12, 0.0,
                                      min_iterations=3)
    assert np.isfinite(pose.numpy()).all()
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=POSE_TOL)
    _close_stats(st, jst)


def test_picp_solve_routes_and_agrees_with_fused_plain():
    """``picp.solve`` on a CPU tensor runs the plain loop under ``auto``, raises
    under ``cuda``, and agrees with K6's plain version (a different arithmetic:
    6x6 Cholesky against the Schur form) to float32 tolerance."""
    world, uv, w, gt, _ = _scene(300, planar=False)
    cam = tsyn.default_camera()
    solved, st = picp.solve(cam, *_t(world, uv, w), 15, kernel_threshold=400.0, tolerance=1e-12)
    pose, st_k = picp_kernel.solve_fused_plain(cam.camera_matrix, cam.world_in_camera,
                                               cam.params(), *_t(world, uv, w), 15, 400.0, 1.0,
                                               1e-12)
    np.testing.assert_allclose(solved.world_in_camera.numpy(), pose.numpy(), atol=POSE_TOL)
    assert int(st.num_inliers) == int(st_k.num_inliers)
    with pytest.raises(ValueError, match="CUDA"):
        picp.solve(cam, *_t(world, uv, w), 15, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        picp.solve(cam, *_t(world, uv, w), 15, backend="pallas")


def test_se2_chart_linalg_and_stats_match_jax():
    from visual_odometry_tpu.ops import linalg6 as jlinalg6
    from visual_odometry_tpu.ops import stats as jstats

    rng = np.random.default_rng(5)
    v = rng.normal(size=(4, 3)).astype(np.float32)
    pose = se3.v2t_se2(torch.from_numpy(v))
    np.testing.assert_allclose(pose.numpy(), np.asarray(jse3.v2t_se2(jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(se3.t2v_se2(pose).numpy(), v, atol=1e-6)
    full = np.asarray(jse3.v2t_euler(jnp.asarray(rng.normal(size=(6,)).astype(np.float32) * 0.3)))
    np.testing.assert_allclose(se3.project_se2(torch.from_numpy(full)).numpy(),
                               np.asarray(jse3.project_se2(jnp.asarray(full))), atol=1e-6)
    np.testing.assert_array_equal(se3.skew(torch.from_numpy(v)).numpy(),
                                  np.asarray(jse3.skew(jnp.asarray(v))))

    a = rng.normal(size=(3, 6, 6)).astype(np.float32)
    h = a @ a.transpose(0, 2, 1) + np.eye(6, dtype=np.float32)
    b = rng.normal(size=(3, 6)).astype(np.float32)
    x = linalg6.cholesky_solve(*_t(h, b))
    np.testing.assert_allclose(x.numpy(), np.asarray(jlinalg6.cholesky_solve(
        jnp.asarray(h), jnp.asarray(b))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", h, x.numpy()), b, atol=1e-4)
    x0, x1, det = linalg6.solve_2x2(*_t(h[:, 0, 0], h[:, 0, 1], h[:, 1, 1], b[:, 0], b[:, 1]))
    j0, j1, jdet = jlinalg6.solve_2x2(*(jnp.asarray(t) for t in (
        h[:, 0, 0], h[:, 0, 1], h[:, 1, 1], b[:, 0], b[:, 1])))
    np.testing.assert_allclose(np.stack([x0, x1, det]), np.stack([j0, j1, jdet]), rtol=1e-5)

    pts = rng.normal(size=(2, 50, 3)).astype(np.float32) * np.float32([3.0, 1.0, 0.2])
    mask = rng.uniform(size=(2, 50)) > 0.3
    mu, cov = stats.mean_and_covariance(*_t(pts, mask))
    jmu, jcov = jstats.mean_and_covariance(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), atol=1e-5)
    for fn, jfn in ((stats.largest_eigenvector, jstats.largest_eigenvector),
                    (stats.smallest_eigenvector, jstats.smallest_eigenvector)):
        vec, jvec = fn(cov).numpy(), np.asarray(jfn(jcov))
        sign = np.sign((vec * jvec).sum(-1, keepdims=True))   # an eigenvector's sign is free
        np.testing.assert_allclose(vec, sign * jvec, atol=1e-4)


# --------------------------------------------------------------------------
# K11: one linearization
# --------------------------------------------------------------------------


def _linearize_case(n, seed=0):
    """tests/test_pallas_kernels.py:64-96: a pose far from convergence, so H
    and b are both large, against exact measurements."""
    rng = np.random.default_rng(seed)
    world = jsyn.generate_points3d(rng, n)
    pose = np.asarray(jse3.v2t_euler(jnp.asarray(np.float32([0.2, -0.1, 0.3, 0.05, -0.08, 0.02]))))
    meas, valid = jproject(jsyn.default_camera(np.eye(4, dtype=np.float32)), jnp.asarray(world))
    return np.array(world), np.array(meas), np.array(valid, np.float32), pose


def _both_linearize(world, meas, w, pose, kt, keep_outliers):
    jcam, tcam = jsyn.default_camera(pose), tsyn.default_camera(pose)
    ref = jkernel.linearize_pallas(
        jcam.camera_matrix, jcam.world_in_camera,
        jnp.asarray([float(jcam.z_near), float(jcam.z_far), float(jcam.cols), float(jcam.rows)],
                    jnp.float32),
        jnp.asarray(world), jnp.asarray(meas), jnp.asarray(w), jnp.float32(kt),
        keep_outliers=keep_outliers, interpret=True)
    got = picp_kernel.linearize(tcam.camera_matrix, tcam.world_in_camera, tcam.params(),
                                *_t(world, meas, w), kt, keep_outliers)
    return got, ref, tcam


@pytest.mark.parametrize("n", [100, 300, 1000])
@pytest.mark.parametrize("keep_outliers,kt", [(False, 1e4), (True, 400.0), (False, 400.0)])
def test_linearize_plain_matches_jax_kernel(n, keep_outliers, kt):
    """K11's plain version against ``linearize_pallas(interpret=True)``: H and
    b within 1e-5 of the system's largest entry, the stats as _close_stats
    holds them; and against the port's own ``picp.linearize``."""
    world, meas, w, pose = _linearize_case(n)
    (h, b, st), (jh, jb, jst), tcam = _both_linearize(world, meas, w, pose, kt, keep_outliers)
    assert h.shape == (6, 6) and b.shape == (6,) and st.num_inliers.dtype == torch.int32
    assert torch.equal(h, h.T)
    _close_system(h, b, jh, jb)
    _close_stats(st, jst)
    h2, b2, st2 = picp.linearize(tcam, *_t(world, meas, w), kt, keep_outliers)
    _close_system(h, b, h2.numpy(), b2.numpy())
    _close_stats(st, st2)
    if kt < 1e4:
        assert 0 < int(st.num_inliers) < int(w.sum())   # the kernel threshold split the points


def test_linearize_restores_the_near_depth_guard():
    """A point a tenth of a micrometre in front of the pinhole under the pose
    linearized at (``hz`` ~ 1e-7, inside the frustum test): the TPU kernel
    lets its 1/z^2 terms into H, the port
    follows ``picp.linearize`` and drops it. The difference is the guard and
    nothing else: without that point both agree."""
    world, meas, w, pose = _linearize_case(100)
    world[0] = pose[:3, :3].T @ (np.float32([0.0, 0.0, 1e-7]) - pose[:3, 3])
    meas[0] = (320.0, 240.0)       # K's principal point: the projection of any (0, 0, z)
    w[0] = 1.0
    (h, b, st), (jh, _, jst), tcam = _both_linearize(world, meas, w, pose, 1e4, False)
    h2, b2, st2 = picp.linearize(tcam, *_t(world, meas, w), 1e4, False)
    _close_system(h, b, h2.numpy(), b2.numpy())
    assert int(st.num_inliers) == int(st2.num_inliers) == int(jst.num_inliers) - 1
    assert float(np.abs(np.asarray(jh)).max()) > 1e6 * float(h.abs().max())
    w[0] = 0.0
    (h, b, st), (jh, jb, jst), _ = _both_linearize(world, meas, w, pose, 1e4, False)
    _close_system(h, b, jh, jb)
    _close_stats(st, jst)


def test_linearize_wrapper_never_falls_back():
    world, meas, w, pose = _linearize_case(50)
    tcam = tsyn.default_camera(pose)
    args = (tcam.camera_matrix, tcam.world_in_camera, tcam.params(), *_t(world, meas, w), 1e4)
    with pytest.raises(ValueError, match="CUDA"):
        picp_kernel.linearize(*args, backend="cuda")
    a, b = picp_kernel.linearize(*args), picp_kernel.linearize_plain(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
