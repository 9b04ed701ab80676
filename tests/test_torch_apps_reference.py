"""The reference's remaining programs in the port (``real_init``,
``picp_known_real``, ``compute_corr``, ``read_data_test`` and the synthetic
``init``, ``picp_test``, ``whole_test``, ``kdtree_test``) against the JAX
package's, on the CPU.

The dataset apps run on one generated reference-format dataset (40 frames,
400 landmarks, seed 1): the same triangulated points (the bootstrap pose
within 1e-5; the points within 1e-3 of their norm at the median, see the
test), the known-world PICP poses within 1e-4, the association sets equal. The
8-point bootstrap runs in float64 on the JAX side too
(``test_torch_pipeline.jax_bootstrap_in_double``), as the parity contract
asks. The synthetic apps meet the JAX package's own guards
(tests/test_apps.py:60-81) and agree with it: rotations within 5e-3 where
they go through the 8-point estimate, poses within 1e-4 for the PICP solve
at 100 rounds, the kd-tree tally exactly.
"""

import functools
import os

import numpy as np
import pytest
import torch

from visual_odometry_tpu import apps as japps
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.utils import dataset_gen as tdg
from visual_odometry_tpu_torch.utils import evaluation, io

from test_torch_pipeline import jax_bootstrap_in_double


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dataset") / "data")
    jdg.generate_dataset(d, num_frames=40, num_landmarks=400, seed=1)
    return d


def test_real_init_matches_jax(data_dir, tmp_path):
    x, tri = tapps.run_real_init(data_dir, str(tmp_path / "t"), verbose=False, device="cpu")
    with jax_bootstrap_in_double():
        jx, jtri = japps.run_real_init(data_dir, str(tmp_path / "j"), verbose=False)
    assert len(tri) == len(jtri) > 50
    np.testing.assert_allclose(x, jx, atol=1e-5)
    # Relative to each point's norm: the median within 1e-3, every point
    # within 1e-2. The first pair is a forward motion, and the points near
    # its focus of expansion (the image centre) have little parallax: there
    # a mid-point triangulation moves by 100x a pose's rounding (measured:
    # median 1.6e-4, 9 of 96 points above 1e-3, at most 6.0e-3, for poses
    # 3.9e-7 apart).
    rel = np.linalg.norm(tri - jtri, axis=1) / np.linalg.norm(jtri, axis=1)
    assert np.median(rel) < 1e-3 and rel.max() < 1e-2
    for name in ("world.txt", "triangulated.txt"):
        assert os.path.exists(tmp_path / "t" / name)
    assert (open(tmp_path / "t" / "world.txt").read()
            == open(tmp_path / "j" / "world.txt").read())
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "triangulated.txt"), tri, atol=1e-4)


def test_picp_known_real_matches_jax(data_dir, tmp_path):
    """Known world and association: the metric scale and near-zero error of
    tests/test_apps.py:25-37, and the JAX package's poses within 1e-4."""
    poses = tapps.run_picp_known_real(data_dir, str(tmp_path / "t"), verbose=False,
                                      device="cpu")
    jposes = japps.run_picp_known_real(data_dir, str(tmp_path / "j"), verbose=False)
    np.testing.assert_allclose(poses, np.asarray(jposes), atol=1e-4)
    params = io.load_camera_params(os.path.join(data_dir, "camera.dat"))
    gt = io.gt_poses_se3(io.load_trajectory(os.path.join(data_dir, "trajectory.dat"))[1])
    res = evaluation.evaluate(io.robot_trajectory(poses, params.cam_in_robot), gt)
    assert abs(res.scale - 1.0) < 1e-3 and res.rmse_position < 1e-3
    written = np.loadtxt(tmp_path / "t" / "trajectory_est.txt")
    assert written.shape == (len(poses), 3)


def test_compute_corr_matches_jax(data_dir):
    a_set, g_set = tapps.run_compute_corr(data_dir, verbose=False, device="cpu")
    ja, jg = japps.run_compute_corr(data_dir, verbose=False)
    assert a_set == ja and g_set == jg
    assert a_set == g_set and len(a_set) > 50


def test_read_data_test_matches_jax(data_dir, capsys):
    params, seq = tapps.run_read_data_test(data_dir)
    out = capsys.readouterr().out
    jparams, jseq = japps.run_read_data_test(data_dir)
    assert capsys.readouterr().out == out
    assert "frames: 40" in out and "world landmarks: 400" in out
    for field in ("points", "appearances", "ids", "mask", "counts"):
        np.testing.assert_array_equal(getattr(seq, field), getattr(jseq, field))
    np.testing.assert_array_equal(params.camera_matrix, jparams.camera_matrix)


def test_init_synthetic_matches_jax():
    x, x_gt = tapps.run_init_synthetic(seed=0, num_points=400, verbose=False, device="cpu")
    with jax_bootstrap_in_double():
        jx, jx_gt = japps.run_init_synthetic(seed=0, num_points=400, verbose=False)
    np.testing.assert_array_equal(x_gt, jx_gt)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=5e-3)
    ratio = x[:3, 3] / x_gt[:3, 3]
    assert np.abs(ratio - ratio.mean()).max() < 1e-2 * abs(ratio.mean())
    np.testing.assert_allclose(x[:3, :3], jx[:3, :3], atol=5e-3)


def test_picp_synthetic_matches_jax():
    x, x_gt = tapps.run_picp_synthetic(seed=0, num_points=1000, iterations=100, verbose=False,
                                       device="cpu")
    jx, jx_gt = japps.run_picp_synthetic(seed=0, num_points=1000, iterations=100, verbose=False)
    np.testing.assert_array_equal(x_gt, jx_gt)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-3)
    np.testing.assert_allclose(x[:3, 3], x_gt[:3, 3], atol=1e-2)
    np.testing.assert_allclose(x, jx, atol=1e-4)


def test_whole_synthetic_matches_jax():
    x, x_gt = tapps.run_whole_synthetic(seed=0, num_points=1500, verbose=False, device="cpu")
    with jax_bootstrap_in_double():
        jx, jx_gt = japps.run_whole_synthetic(seed=0, num_points=1500, verbose=False)
    np.testing.assert_array_equal(x_gt, jx_gt)
    np.testing.assert_allclose(x[:3, :3], x_gt[:3, :3], atol=1e-2)
    np.testing.assert_allclose(x[:3, :3], jx[:3, :3], atol=5e-3)


def test_kdtree_test_matches_jax():
    correct = tapps.run_kdtree_test(seed=0, num_points=300, verbose=False, device="cpu")
    jcorrect = japps.run_kdtree_test(seed=0, num_points=300, verbose=False)
    assert correct.mean() > 0.9
    np.testing.assert_array_equal(correct, np.asarray(jcorrect))


def _fake_outputs(d):
    """The files plot_all reads, with random contents."""
    rng = np.random.default_rng(0)
    os.makedirs(d, exist_ok=True)
    for name, cols in (("trajectory_gt.txt", 3), ("trajectory_est_complete.txt", 3),
                       ("world_pruned.txt", 3), ("map_corrected.txt", 3), ("arrows.txt", 6),
                       ("out_performance.txt", 2)):
        np.savetxt(os.path.join(d, name), rng.normal(size=(20, cols)))


def test_cli_dispatches_every_new_command(data_dir, tmp_path, monkeypatch, capsys):
    """Each command the port adds returns 0 through ``main``, as does the
    dataset generator's; picp_test's solve is cut to 100 rounds here."""
    monkeypatch.setitem(
        tapps._COMMANDS, "picp_test",
        (functools.partial(tapps.run_picp_synthetic, iterations=100), "seed", True))
    out = str(tmp_path / "out")
    for argv in (["real_init", data_dir, out], ["picp_known_real", data_dir, out],
                 ["compute_corr", data_dir], ["read_data_test", data_dir],
                 ["init", "1"], ["picp_test", "1"], ["whole_test"], ["kdtree_test", "3"]):
        device = [] if argv[0] == "read_data_test" else ["--device", "cpu"]
        assert tapps.main(argv + device) == 0, argv
    text = capsys.readouterr().out
    assert "FAST Correct" in text and "agreeing: 96" in text and "frames: 40" in text
    assert {"triangulated.txt", "trajectory_est.txt"} <= set(os.listdir(out))
    _fake_outputs(out)
    assert tapps.main(["plot", out]) == 0
    assert {"trajectories.png", "points.png", "errors.png"} <= set(os.listdir(out))
    monkeypatch.chdir(out)
    assert tapps.main(["plot"]) == 0
    with pytest.raises(SystemExit):
        tapps.main(["init", "1", "2"])
    with pytest.raises(SystemExit):
        tapps.main(["bogus"])
    gen = str(tmp_path / "gen")
    assert tdg.main([gen, "--frames", "5", "--landmarks", "50", "--seed", "2"]) == 0
    assert len(io.list_measurement_files(gen)) == 5
    assert len(io.load_world(os.path.join(gen, "world.dat"))[0]) == 50


def test_new_apps_default_to_the_card(data_dir, tmp_path):
    """Without ``device`` every new application asks for the CUDA card and
    raises on a host that has none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = str(tmp_path)
    for call in (lambda: tapps.run_real_init(data_dir, out, verbose=False),
                 lambda: tapps.run_picp_known_real(data_dir, out, verbose=False),
                 lambda: tapps.run_compute_corr(data_dir, verbose=False),
                 lambda: tapps.run_init_synthetic(verbose=False),
                 lambda: tapps.run_picp_synthetic(verbose=False),
                 lambda: tapps.run_whole_synthetic(verbose=False),
                 lambda: tapps.run_kdtree_test(verbose=False),
                 lambda: tapps.main(["init"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
