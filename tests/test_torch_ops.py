"""visual_odometry_tpu_torch ops and utils against the JAX package, on the CPU.

Both packages get the same numpy inputs from a seeded generator. Tolerances:
exact where the computation is selection or copying (indices, masks, file
contents); float32 round-off (1e-5 relative) for closed-form geometry;
looser only where stated, for the ill-conditioned f32 8-point bootstrap.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops import camera as jcam
from visual_odometry_tpu.ops import epipolar as jepi
from visual_odometry_tpu.ops import matching as jmat
from visual_odometry_tpu.ops import se3 as jse3
from visual_odometry_tpu.ops import triangulation as jtri
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu.utils import evaluation as jeval
from visual_odometry_tpu.utils import io as jio
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.ops import camera as tcam
from visual_odometry_tpu_torch.ops import epipolar as tepi
from visual_odometry_tpu_torch.ops import matching as tmat
from visual_odometry_tpu_torch.ops import se3 as tse3
from visual_odometry_tpu_torch.ops import triangulation as ttri
from visual_odometry_tpu_torch.utils import convert, dataset_gen as tdg
from visual_odometry_tpu_torch.utils import evaluation as teval
from visual_odometry_tpu_torch.utils import io as tio
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig


def T(x):
    return torch.from_numpy(np.array(x))


def test_se3_matches_jax(rng):
    v = rng.uniform(-1, 1, (16, 6)).astype(np.float32)
    np.testing.assert_allclose(tse3.v2t_euler(T(v)).numpy(), np.asarray(jse3.v2t_euler(v)),
                               rtol=1e-5, atol=1e-6)
    poses = np.asarray(jse3.v2t_euler(v))
    np.testing.assert_allclose(tse3.inverse(T(poses)).numpy(), np.asarray(jse3.inverse(poses)),
                               rtol=1e-5, atol=1e-6)
    pts = rng.normal(size=(16, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(tse3.transform_points(T(poses), T(pts)).numpy(),
                               np.asarray(jse3.transform_points(poses, pts)), rtol=1e-5, atol=1e-5)


def test_chain_products_keeps_order(rng):
    """The doubling scan equals the left-to-right running product."""
    mats = T(np.asarray(jse3.v2t_euler(rng.uniform(-0.5, 0.5, (13, 6)).astype(np.float32))))
    out = tse3.chain_products(mats.double())
    ref = [mats[0].double()]
    for m in mats[1:]:
        ref.append(ref[-1] @ m.double())
    np.testing.assert_allclose(out.numpy(), torch.stack(ref).numpy(), atol=1e-12)


def test_project_points_matches_jax(rng):
    world = jsyn.generate_points3d(rng, 300)
    pose = jsyn.generate_pose(rng)
    juv, jv = jcam.project_points(jsyn.default_camera(pose), jnp.asarray(world))
    tuv, tv = tcam.project_points(tsyn.default_camera(pose), T(world))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), rtol=1e-5, atol=1e-3)


def test_triangulation_matches_jax(rng):
    world, w1, w2, p1, p2, valid, x12 = jsyn.two_view_scene(rng, 400)
    k = np.asarray(jsyn.default_camera().camera_matrix)
    idx = np.arange(400, dtype=np.int32)
    jp, jok = jtri.triangulate_correspondences(k, x12, idx, idx, valid, p1, p2)
    tp, tok = ttri.triangulate_correspondences(T(k), T(x12), T(idx), T(idx), T(valid), T(p1), T(p2))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_transform_matches_jax(seed):
    """The chosen bootstrap pose, not F or E (eigenvector signs may differ), on
    the JAX package's own epipolar scene (tests/test_epipolar.py): two small
    random poses over 1000 points. Rotations within 1e-3 and translation
    directions within 1e-3 of each other: the f32 8-point null vector carries
    ~1e-3 of implementation-dependent error (ops/epipolar._null_vector)."""
    rng = np.random.default_rng(seed)
    world = jsyn.generate_points3d(rng, 1000)
    w1, w2 = (np.asarray(jse3.v2t_euler(rng.uniform(-0.25, 0.25, 6).astype(np.float32)))
              for _ in range(2))
    p1, v1 = (np.asarray(x) for x in jcam.project_points(jsyn.default_camera(w1), world))
    p2, v2 = (np.asarray(x) for x in jcam.project_points(jsyn.default_camera(w2), world))
    k = np.asarray(jsyn.default_camera().camera_matrix)
    idx = np.arange(1000, dtype=np.int32)
    args = (idx, idx, v1 & v2, p1, p2, (p1 != -1).any(axis=1), (p2 != -1).any(axis=1))
    jx = np.asarray(jepi.estimate_transform(k, *args))
    tx = tepi.estimate_transform(T(k), *(T(a) for a in args)).numpy()
    np.testing.assert_allclose(tx[:3, :3], jx[:3, :3], atol=1e-3)
    tdir = tx[:3, 3] / np.linalg.norm(tx[:3, 3])
    np.testing.assert_allclose(tdir, jx[:3, 3] / np.linalg.norm(jx[:3, 3]), atol=1e-3)
    x12 = w2 @ np.linalg.inv(w1)
    np.testing.assert_allclose(tdir, x12[:3, 3] / np.linalg.norm(x12[:3, 3]), atol=1e-2)

    jres, jok = jepi.homography_transfer_residuals(*args)
    tres, tok = tepi.homography_transfer_residuals(*(T(a) for a in args))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(np.median(tres.numpy()[tok.numpy()]),
                               np.median(np.asarray(jres)[np.asarray(jok)]), rtol=1e-2)


def test_estimate_transform_identity_when_no_votes():
    k = T(np.asarray(jsyn.default_camera().camera_matrix))
    idx = torch.arange(16, dtype=torch.int32)
    none = torch.zeros(16, dtype=torch.bool)
    zeros = torch.zeros((16, 2))
    x = tepi.estimate_transform(k, idx, idx, none, zeros, zeros, none, none)
    np.testing.assert_allclose(x.numpy(), np.eye(4), atol=1e-6)


@pytest.mark.parametrize("kd_side", ["frame1", "frame2"])
def test_match_appearances_matches_jax(rng, kd_side):
    """Indices and validity exact on margin-separated data, both query sides."""
    n, d = 96, 10
    a1 = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    a2 = a1[rng.permutation(n)] + rng.normal(0, 0.01, (n, d)).astype(np.float32)
    m1 = rng.uniform(size=n) > 0.1
    m2 = rng.uniform(size=n) > 0.1
    (m2 if kd_side == "frame1" else m1)[:20] = False
    j = jmat.match_appearances(a1, m1, a2, m2, 0.1)
    t = tmat.match_appearances(T(a1), T(m1), T(a2), T(m2), 0.1)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.idx1.numpy()[v], np.asarray(j.idx1)[v])
    np.testing.assert_array_equal(t.idx2.numpy()[v], np.asarray(j.idx2)[v])
    np.testing.assert_allclose(tmat.pairwise_sq_dists(T(a1), T(a2)).numpy(),
                               np.asarray(jmat.pairwise_sq_dists(a1, a2)), rtol=1e-5, atol=1e-5)


def test_config_mirrors_jax_fields_and_defaults():
    j = JaxConfig()
    for f in (x for x in j.__dataclass_fields__):
        if f.endswith("_backend") and f != "refine_backend":
            assert getattr(DEFAULT_CONFIG, f) == "auto"
        else:
            assert getattr(DEFAULT_CONFIG, f) == getattr(j, f), f
    assert set(j.__dataclass_fields__) == set(VOConfig.__dataclass_fields__)
    with pytest.raises(ValueError):
        VOConfig(scan_backend="fused")
    VOConfig(planar=True).check_supported()   # est_SE2 runs (kernel K5)
    assert VOConfig(scan_backend="step").scan_backend == "step"
    with pytest.raises(ValueError):
        VOConfig(matcher_precision="bf16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VOConfig(num_chunks=4).check_supported()
    VOConfig(refine_iterations=1, refine_backend="sparse").check_supported()   # BA is ported
    with pytest.raises(ValueError):
        VOConfig(refine_backend="lm")
    mount = np.eye(4, dtype=np.float32)
    mount[0, 3] = 0.25
    planar = VOConfig().with_planar_mount(mount)
    assert planar.planar and hash(planar) is not None
    np.testing.assert_array_equal(planar.planar_mount(), JaxConfig().with_planar_mount(
        mount).planar_mount())


def test_convert_config_and_state():
    import dataclasses

    cfg = convert.config_from_dict(dataclasses.asdict(
        JaxConfig(n_slots=256, scan_backend="fused_interpret", matcher_backend="pairs_pallas")
    ))
    assert (cfg.n_slots, cfg.scan_backend, cfg.matcher_backend) == (256, "torch", "cuda")
    with pytest.raises(ValueError):
        convert.config_from_dict({"no_such_field": 1})
    # JAX's "xla" scan is the frame_step loop; a planar config carries its mount.
    mount = np.eye(4, dtype=np.float32)
    mount[1, 3] = -0.5
    planar = convert.config_from_dict(dataclasses.asdict(
        JaxConfig(scan_backend="xla", solver_backend="pallas").with_planar_mount(mount)))
    assert (planar.scan_backend, planar.solver_backend, planar.planar) == ("step", "cuda", True)
    np.testing.assert_array_equal(planar.planar_mount(), mount)
    stats = convert.picp_stats_from_arrays(np.float32(1.5), np.float32(0.25), np.int32(7))
    assert stats.num_inliers.dtype == torch.int32 and int(stats.num_inliers) == 7
    assert float(stats.chi_inliers) == 1.5 and float(stats.chi_outliers) == 0.25
    cam = convert.camera_from_arrays(np.eye(3), 480, 640, 0, 5)
    assert cam.rows.dtype == torch.float32 and float(cam.cols) == 640.0
    m = convert.landmark_map_from_arrays(np.zeros((4, 3)), np.ones((4, 10)), [1, 1, 0, 0])
    assert int(m.count) == 2 and m.valid.dtype == torch.bool


def test_synthetic_sequence_matches_jax():
    jp, ja, jm = jsyn.generate_tracking_sequence(np.random.default_rng(3), 6, 64)
    tp, ta, tm = tsyn.generate_tracking_sequence(np.random.default_rng(3), 6, 64)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tp, jp, atol=1e-3)


def test_dataset_gen_and_io_match_jax(tmp_path):
    """Same files up to the last printed digit of projected pixels; the readers,
    the padded loader and the writers are byte-for-byte the JAX package's."""
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jdg.generate_dataset(dj, num_frames=6, num_landmarks=120, seed=4)
    tdg.generate_dataset(dt, num_frames=6, num_landmarks=120, seed=4)
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for name in ("world.dat", "camera.dat", "trajectory.dat"):
        assert open(os.path.join(dj, name)).read() == open(os.path.join(dt, name)).read()
    js, ts = jio.load_sequence(dj, 128), tio.load_sequence(dt, 128)
    np.testing.assert_array_equal(ts.mask, js.mask)
    np.testing.assert_array_equal(ts.ids, js.ids)
    np.testing.assert_array_equal(ts.appearances, js.appearances)
    np.testing.assert_allclose(ts.points, js.points, atol=2e-3)
    jparams = jio.load_camera_params(os.path.join(dj, "camera.dat"))
    tparams = tio.load_camera_params(os.path.join(dt, "camera.dat"))
    np.testing.assert_array_equal(tparams.camera_matrix, jparams.camera_matrix)
    np.testing.assert_array_equal(tparams.cam_in_robot, jparams.cam_in_robot)

    poses = np.asarray(jse3.v2t_euler(np.random.default_rng(0).uniform(-0.1, 0.1, (5, 6))
                                      .astype(np.float32)))
    jio.save_trajectory(str(tmp_path / "j.txt"), poses, jparams.cam_in_robot, save_rotation=True)
    tio.save_trajectory(str(tmp_path / "t.txt"), poses, tparams.cam_in_robot, save_rotation=True)
    assert open(tmp_path / "j.txt").read() == open(tmp_path / "t.txt").read()


def test_evaluation_matches_jax(rng):
    est = np.asarray(jse3.v2t_euler(rng.uniform(-1, 1, (12, 6)).astype(np.float32)))
    gt = np.asarray(jse3.v2t_euler(rng.uniform(-1, 1, (12, 6)).astype(np.float32)))
    mp = rng.normal(size=(30, 3)).astype(np.float32)
    ma = rng.normal(size=(30, 10)).astype(np.float32)
    wp = rng.normal(size=(40, 3)).astype(np.float32)
    wa = np.concatenate([ma[:20], rng.normal(size=(20, 10)).astype(np.float32)])
    j = jeval.evaluate(est, gt, mp, ma, wp, wa)
    t = teval.evaluate(est, gt, mp, ma, wp, wa)
    np.testing.assert_array_equal(t.orientation_errors, j.orientation_errors)
    assert (t.scale, t.rmse_position, t.rmse_map, t.n_map_matched) == (
        j.scale, j.rmse_position, j.rmse_map, j.n_map_matched)


def test_initialize_matches_jax_state():
    """The port's bootstrap state against JAX's, carried across with
    convert.vo_state_from_arrays: lookup, validity and map layout exact,
    geometry within the 8-point bootstrap's f32 conditioning: over 64 points
    the two packages' eigh null vectors put the unit translation ~1e-2 apart
    (2e-2 bound), the rotations ~1e-3 apart."""
    from visual_odometry_tpu.models import pipeline as jpipe
    from visual_odometry_tpu_torch.models import pipeline as tpipe

    pts, apps, masks = jsyn.generate_tracking_sequence(np.random.default_rng(0), 2, 64,
                                                       seed_motion=6.0)
    ids = np.full(masks.shape, -1, np.int32)
    jf = [jpipe.FrameData(*(jnp.asarray(x[i]) for x in (pts, apps, masks, ids))) for i in (0, 1)]
    jstate, _ = jpipe.initialize(jsyn.deep_camera(), JaxConfig(n_slots=64), *jf)
    carried = convert.vo_state_from_arrays(
        ref=dict(points=jstate.ref.points, appearances=jstate.ref.appearances,
                 mask=jstate.ref.mask, ids=jstate.ref.ids),
        point_lookup=jstate.point_lookup, tri_points=jstate.tri_points,
        tri_valid=jstate.tri_valid, x_curr=jstate.x_curr, history=jstate.history,
        map_arrays=dict(points=jstate.map.points, appearances=jstate.map.appearances,
                        valid=jstate.map.valid, count=jstate.map.count),
    )
    tf = [tpipe.FrameData(*(T(x[i]) for x in (pts, apps, masks, ids))) for i in (0, 1)]
    state, _ = tpipe.initialize(tsyn.deep_camera(), VOConfig(n_slots=64), *tf)
    for name in ("point_lookup", "tri_valid"):
        assert torch.equal(getattr(state, name), getattr(carried, name)), name
    for name in ("appearances", "valid", "count"):
        assert torch.equal(getattr(state.map, name), getattr(carried.map, name)), name
    assert torch.equal(state.ref.appearances, carried.ref.appearances)
    np.testing.assert_allclose(state.x_curr.numpy(), carried.x_curr.numpy(), atol=2e-2)
    np.testing.assert_allclose(state.history.numpy(), carried.history.numpy(), atol=2e-2)
    np.testing.assert_allclose(state.x_curr[:3, :3].numpy(), carried.x_curr[:3, :3].numpy(),
                               atol=2e-3)
