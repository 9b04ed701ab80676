"""The port's landmark map against the JAX package's, on the CPU: the same
slots in the same order, the same count, +inf padding — exact, since the
map only selects and copies its inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import landmark_map as jlm
from visual_odometry_tpu_torch.models import landmark_map as tlm


def _assert_same(t, j):
    assert int(t.count) == int(j.count)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.appearances.numpy(), np.asarray(j.appearances))
    np.testing.assert_array_equal(t.points.numpy(), np.asarray(j.points))


def _stream(rng, t=400, keys=150, d=10):
    """Re-observed keys (including a -0.0 twin of +0.0) and masked rows."""
    table = rng.uniform(-1, 1, (keys, d)).astype(np.float32)
    table[0, 0] = 0.0
    apps = table[rng.integers(0, keys, t)]
    neg = np.where((apps == table[0]).all(1))[0]
    if len(neg):
        apps[neg[0], 0] = -0.0
    pts = rng.normal(size=(t, 3)).astype(np.float32)
    mask = rng.uniform(size=t) > 0.2
    return pts, apps, mask


@pytest.mark.parametrize("capacity", [64, 512])
def test_merge_stream_matches_jax(rng, capacity):
    pts, apps, mask = _stream(rng)
    j = jlm.merge_stream(jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask), capacity)
    t = tlm.merge_stream(torch.from_numpy(pts), torch.from_numpy(apps), torch.from_numpy(mask),
                         capacity)
    _assert_same(t, j)


def test_update_matches_jax_and_merge_stream(rng):
    """Iterated update (append new keys, replace re-observed positions) equals
    the JAX update step by step and the one-pass merge_stream at the end."""
    pts, apps, mask = _stream(rng, t=240, keys=90)
    # Keys are unique within each 40-row frame, as the tracker guarantees.
    jm = jlm.LandmarkMap.empty(128)
    tm = tlm.LandmarkMap.empty(128)
    kept = np.zeros_like(mask)
    for f in range(0, 240, 40):
        sl = slice(f, f + 40)
        m = mask[sl].copy()
        _, first = np.unique(apps[sl], axis=0, return_index=True)
        uniq = np.zeros(40, bool)
        uniq[first] = True
        m &= uniq
        kept[sl] = m
        jm = jlm.update(jm, jnp.asarray(pts[sl]), jnp.asarray(apps[sl]), jnp.asarray(m))
        tm = tlm.update(tm, torch.from_numpy(pts[sl]), torch.from_numpy(apps[sl]),
                        torch.from_numpy(m))
        _assert_same(tm, jm)
    one_pass = tlm.merge_stream(torch.from_numpy(pts), torch.from_numpy(apps + 0.0),
                                torch.from_numpy(kept), 128)
    _assert_same(one_pass, jm)


def test_compact_returns_live_rows_in_order():
    m = tlm.LandmarkMap.empty(8, 2)
    m = tlm.update(m, torch.arange(9.0).reshape(3, 3), torch.eye(3)[:, :2] + 5,
                   torch.tensor([True, False, True]))
    p, a = tlm.compact(m)
    np.testing.assert_array_equal(p, [[0, 1, 2], [6, 7, 8]])
    assert a.shape == (2, 2)


def test_transform_matches_jax(rng):
    """Points moved by the pose within float32 round-off (1e-5 relative) of
    the JAX function's; appearances, validity and count untouched (exact)."""
    from visual_odometry_tpu.ops import se3 as jse3

    pts, apps, mask = _stream(rng)
    jm = jlm.merge_stream(jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask), 512)
    tm = tlm.merge_stream(torch.from_numpy(pts), torch.from_numpy(apps),
                          torch.from_numpy(mask), 512)
    pose = np.asarray(jse3.v2t_euler(rng.uniform(-1, 1, 6).astype(np.float32)))
    jt = jlm.transform(jm, jnp.asarray(pose))
    tt = tlm.transform(tm, torch.from_numpy(np.array(pose)))
    assert int(tt.count) == int(jt.count)
    np.testing.assert_array_equal(tt.valid.numpy(), np.asarray(jt.valid))
    np.testing.assert_array_equal(tt.appearances.numpy(), tm.appearances.numpy())
    live = tt.valid.numpy()
    np.testing.assert_allclose(tt.points.numpy()[live], np.asarray(jt.points)[live],
                               rtol=1e-5, atol=1e-5)
