"""The GN round counters of tests/chunk_gn_rounds.py, on the CPU: counting
changes no pose in either package, and the sliced pair matcher gives the
plain matcher's bits. Inputs: ``generate_tracking_sequence(default_rng(0),
24, 64)`` under ``deep_camera()``."""

import numpy as np
import pytest
import torch

import chunk_gn_rounds as gr
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.ops.kernels import matcher_kernel
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

F, S = 24, 64


@pytest.fixture(scope="module")
def sequence():
    return tsyn.generate_tracking_sequence(np.random.default_rng(0), F, S)


def test_counted_jax_solve_keeps_its_poses(sequence):
    rounds, poses = gr.jax_rounds(*sequence, S)
    _, want = gr.jax_rounds(*sequence, S, count=False)
    np.testing.assert_array_equal(poses, want)
    assert rounds.shape == (F - 2,)
    assert ((rounds >= 1) & (rounds <= VOConfig().gn_iterations)).all()


def test_counted_port_rounds_keep_its_poses(sequence):
    rounds, poses = gr.port_rounds(*sequence, S)
    t = [torch.from_numpy(x) for x in sequence]
    ids = torch.full(t[2].shape, -1, dtype=torch.int32)
    _, outs, _ = tpipe._track(tsyn.deep_camera(), VOConfig(n_slots=S, map_capacity=2 * S), *t,
                              ids, False)
    np.testing.assert_array_equal(poses, outs.pose.numpy())
    assert rounds.shape == (F - 2,)
    assert ((rounds >= 1) & (rounds <= VOConfig().gn_iterations)).all()


@pytest.mark.parametrize("pairs", [1, 32, 70])
def test_sliced_matcher_equals_plain(pairs):
    rng = np.random.default_rng(pairs)
    app = torch.from_numpy(rng.normal(size=(2, pairs, S, 10)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, pairs, S)) < 0.9)
    got = gr._sliced_matcher()(app[0], mask[0], app[1], mask[1])
    want = matcher_kernel.match_pairs_plain(app[0], mask[0], app[1], mask[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
