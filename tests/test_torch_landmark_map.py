"""The port's landmark map against the JAX package's, on the CPU: the same
slots in the same order, the same count, +inf padding — exact, since the
map only selects and copies its inputs."""

import jax
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


def _same_bits(t, j):
    """Each output of the port's map holds the JAX map's bits (NaN keys
    included, whatever their payload)."""
    for a, b in zip(t, j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.mark.parametrize("batched", [False, True])
def test_merge_stream_all_masked_matches_jax(rng, batched):
    """A stream with no live row folds to the empty map (0 / +inf / False,
    count 0), alone and as every sequence of a batch (jax.vmap)."""
    pts, apps, _ = _stream(rng, t=120)
    mask = np.zeros(120, bool)
    if batched:
        pts, apps, mask = (np.stack([x, x, x]) for x in (pts, apps, mask))
        j = jax.vmap(lambda p, a, m: jlm.merge_stream(p, a, m, 16))(
            jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask))
    else:
        j = jlm.merge_stream(jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask), 16)
    t = tlm.merge_stream(*(torch.from_numpy(x) for x in (pts, apps, mask)), 16)
    _same_bits(t, j)
    assert not t.valid.any() and bool(torch.isinf(t.appearances).all())


def test_merge_stream_nan_keys_match_jax(rng):
    """Keys holding NaNs of several payloads and signs group by their bits
    after the + 0.0 as the JAX fold groups them; a NaN never matches a
    number."""
    pts, apps, mask = _stream(rng, t=300, keys=60)
    nans = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7FFFFFFF], np.uint32).view(np.float32)
    rows = rng.choice(300, 120, replace=False)
    apps[rows, rng.integers(0, 10, 120)] = nans[rng.integers(0, 4, 120)]
    apps[rows[:40]] = apps[rows[0]]             # one NaN key observed 40 times
    for capacity in (8, 256):
        j = jlm.merge_stream(jnp.asarray(pts), jnp.asarray(apps), jnp.asarray(mask), capacity)
        t = tlm.merge_stream(*(torch.from_numpy(x) for x in (pts, apps, mask)), capacity)
        _same_bits(t, j)


@pytest.mark.parametrize("batched", [False, True])
def test_merge_stream_torch_backend_is_auto_on_the_cpu(rng, batched):
    """On CPU tensors ``"auto"`` takes the plain fold, which ``"torch"`` names."""
    pts, apps, mask = _stream(rng)
    if batched:
        pts, apps, mask = (np.stack([x, x[::-1]]) for x in (pts, apps, mask))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (pts, apps, mask)]
    auto = tlm.merge_stream(*args, 64)
    plain = tlm.merge_stream(*args, 64, backend="torch")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    assert auto.count.dtype == torch.int32 and auto.count.shape == ((2,) if batched else ())


@pytest.mark.parametrize("backend,match", [("cuda", "needs CUDA tensors"),
                                           ("triton", "expected one of")])
def test_merge_stream_refuses_a_backend(rng, backend, match):
    """``"cuda"`` on CPU tensors raises instead of falling back; an unknown
    backend raises."""
    args = [torch.from_numpy(x) for x in _stream(rng, t=50)]
    with pytest.raises(ValueError, match=match):
        tlm.merge_stream(*args, 16, backend=backend)


def test_map_kernel_table_and_launch_checks(rng):
    """P2's table holds the smallest power of two >= 2 T entries a sequence,
    and its launcher refuses CPU tensors before it builds anything."""
    from visual_odometry_tpu_torch.ops.kernels import map_kernel

    assert [map_kernel.table_entries(t) for t in (0, 1, 2, 3, 15_360, 523_264)] == [
        2, 2, 4, 8, 32_768, 1 << 20]
    args = [torch.from_numpy(x)[None] for x in _stream(rng, t=50)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        map_kernel.merge_streams_cuda(*args, 16)


@pytest.mark.parametrize("batched", [False, True])
def test_merge_stream_head_is_the_front_of_the_stream(rng, batched):
    """A head segment folds as the rows in front of the stream's: the plain
    fold concatenates it."""
    pts, apps, mask = _stream(rng)
    if batched:
        pts, apps, mask = (np.stack([x, x[::-1]]) for x in (pts, apps, mask))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (pts, apps, mask)]
    axis = args[2].dim() - 1
    whole = tlm.merge_stream(*args, 64)
    for h in (0, 90, 400):
        split = tlm.merge_stream(*(x.narrow(axis, h, 400 - h) for x in args), 64,
                                 head=tuple(x.narrow(axis, 0, h) for x in args))
        assert all(torch.equal(a, b) for a, b in zip(split, whole))
