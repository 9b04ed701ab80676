"""The port's figures (utils/plots): the three gnuplot figures of the
reference rendered with matplotlib from an output directory's files, as the
JAX package's tests/test_plots.py checks them, and the same figure files as
the JAX package's renderer writes."""

import os

import numpy as np
import pytest

from visual_odometry_tpu.utils import plots as jplots
from visual_odometry_tpu_torch.utils import plots


def _write(d, rng):
    np.savetxt(os.path.join(d, "trajectory_gt.txt"), rng.normal(size=(20, 3)))
    np.savetxt(os.path.join(d, "trajectory_est_complete.txt"), rng.normal(size=(20, 3)))
    np.savetxt(os.path.join(d, "world_pruned.txt"), rng.normal(size=(30, 3)))
    np.savetxt(os.path.join(d, "map_corrected.txt"), rng.normal(size=(30, 3)))
    np.savetxt(os.path.join(d, "arrows.txt"), rng.normal(size=(30, 6)))
    perf = rng.normal(size=(19, 2))
    perf[3, 1] = np.inf   # a stationary frame: its ratio is inf (README.md:113 there)
    np.savetxt(os.path.join(d, "out_performance.txt"), perf)


@pytest.fixture
def fake_outputs(tmp_path):
    _write(str(tmp_path), np.random.default_rng(0))
    return str(tmp_path)


def test_plot_all_renders_three_figures(fake_outputs):
    out = plots.plot_all(fake_outputs)
    assert [os.path.basename(p) for p in out] == ["trajectories.png", "points.png", "errors.png"]
    for p in out:
        assert os.path.exists(p) and os.path.getsize(p) > 1000
    assert ([os.path.basename(p) for p in jplots.plot_all(fake_outputs)]
            == [os.path.basename(p) for p in out])


def test_plot_all_skips_missing_inputs(tmp_path):
    d = str(tmp_path)
    np.savetxt(os.path.join(d, "out_performance.txt"), np.zeros((5, 2)))
    out = plots.plot_all(d)
    assert len(out) == 1 and out[0].endswith("errors.png")
    os.makedirs(tmp_path / "empty")
    assert plots.plot_all(str(tmp_path / "empty")) == []
