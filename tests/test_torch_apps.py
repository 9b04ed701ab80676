"""The slice's applications against the JAX package's, on the CPU: ``vo_se2``,
``vo_daknown`` and ``relocalize`` on one generated reference-format dataset.

Tolerances are those tests/test_torch_pipeline.py uses for ``vo_complete``:
each package runs its own 8-point bootstrap, and the JAX apps track through
the scan path on the CPU, so relative robot motions agree to 2e-3 and the
metrics to 1e-3; files that hold no estimate are identical. The planar run is
held to the planar-subgroup bound 1e-4 (utils/selfcheck.py:189 of the JAX
package) and ``relocalization.txt`` to the bounds of tests/test_relocalize.py.
"""

import os

import numpy as np
import pytest
import torch

from visual_odometry_tpu import apps as japps
from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu_torch import apps as tapps
from visual_odometry_tpu_torch.ops import se3
from visual_odometry_tpu_torch.utils import checkpoint, io


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dataset") / "data")
    jdg.generate_dataset(d, num_frames=40, num_landmarks=400, seed=1)
    return d


def _relative(poses):
    return np.linalg.inv(poses[:-1].astype(np.float64)) @ poses[1:].astype(np.float64)


def _poses(d):
    return io.load_est_trajectory(os.path.join(d, "trajectory_est_data.txt"))


def _assert_motions_close(out_t, out_j):
    rel_t, rel_j = _relative(_poses(out_t)), _relative(_poses(out_j))
    np.testing.assert_allclose(rel_t[:, :3, :3], rel_j[:, :3, :3], atol=2e-3)
    np.testing.assert_allclose(rel_t[:, :3, 3], rel_j[:, :3, 3], atol=2e-3)


def test_run_vo_se2_matches_jax(data_dir, tmp_path):
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tapps.main(["vo_se2", data_dir, out_t, "--device", "cpu"]) == 0
    japps.run_vo_se2(data_dir, out_j, verbose=False)
    for name in ("world.txt", "trajectory_gt.txt", "map_appearances.txt"):
        assert open(os.path.join(out_t, name)).read() == open(os.path.join(out_j, name)).read()
    _assert_motions_close(out_t, out_j)
    res_t = tapps.run_evaluation(data_dir, out_t, verbose=False)
    res_j = japps.run_evaluation(data_dir, out_j, verbose=False)
    assert abs(res_t.scale - res_j.scale) < 1e-3 * res_j.scale
    assert abs(res_t.rmse_position - res_j.rmse_position) < 1e-3
    finite = np.isfinite(res_t.orientation_errors)
    assert np.abs(res_t.orientation_errors[finite]).mean() < 1e-4
    assert res_t.rmse_position < 0.2 and res_t.n_map_matched > 100
    # The written poses are robot poses: their relative motions lie in SE(2).
    rel = torch.from_numpy(_relative(_poses(out_t)).astype(np.float32))
    assert se3.planar_deviation(rel, torch.eye(4)) < 1e-4


def test_run_vo_da_known_matches_jax(data_dir, tmp_path):
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tapps.main(["vo_daknown", data_dir, out_t, "--device", "cpu"]) == 0
    jtraj, jouts, _ = japps.run_vo_da_known(data_dir, out_j, verbose=False)
    assert {"trajectory_est_noWorld.txt", "trajectory_est_data.txt",
            "time_known.txt"} <= set(os.listdir(out_t))
    _assert_motions_close(out_t, out_j)
    times = np.loadtxt(os.path.join(out_t, "time_known.txt"))
    assert times.shape == (len(jtraj) - 1,) and (times >= 0).all()
    traj, outs, _ = tapps.run_vo_da_known(data_dir, out_t, verbose=False, device="cpu")
    np.testing.assert_array_equal(outs.num_matches.numpy(), np.asarray(jouts.num_matches))
    np.testing.assert_array_equal(outs.num_solver_corr.numpy(), np.asarray(jouts.num_solver_corr))
    no_world = np.loadtxt(os.path.join(out_t, "trajectory_est_noWorld.txt"))
    assert no_world.shape == np.loadtxt(os.path.join(out_j, "trajectory_est_noWorld.txt")).shape


def test_run_relocalize_matches_jax(data_dir, tmp_path):
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    rows = tapps.run_relocalize(data_dir, out_t, every=10, verbose=False, device="cpu")
    jrows = japps.run_relocalize(data_dir, out_j, every=10, verbose=False)
    assert [r[0] for r in rows] == [r[0] for r in jrows] == [10, 20, 30]
    assert [r[3] for r in rows] == [r[3] for r in jrows]           # match counts
    for r, jr in zip(rows, jrows):
        assert abs(r[4] - jr[4]) <= 1                              # inliers: a boundary point may flip
        assert r[1] < 0.05 and r[2] < 1e-3
        assert abs(r[1] - jr[1]) < 2e-3
    text = open(os.path.join(out_t, "relocalization.txt")).read().splitlines()
    assert [int(line.split()[0]) for line in text] == [10, 20, 30]
    assert all(len(line.split()) == 5 for line in text)


def test_apps_default_to_the_card(data_dir, tmp_path):
    """Without ``device`` the tracking commands and the checkpoint loader ask
    for the CUDA card and raise on a host that has none, instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for fn in (tapps.run_vo_se2, tapps.run_vo_da_known, tapps.run_relocalize):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(data_dir, str(tmp_path), verbose=False)
    path = str(tmp_path / "state.npz")
    np.savez(path, trajectory=np.zeros((2, 4, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_state(path)
