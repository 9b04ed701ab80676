"""The batched bootstrap and map fold of the port against the JAX package and
against the port's own per-pair forms, on the CPU (the plain version of the
eight-point kernel P1, ``ops/kernels/epipolar_kernel``).

Inputs: frame pairs of ``generate_tracking_sequence(default_rng(seed), 2, 64,
seed_motion=m)`` at several seeds and two motions, matched by the port's
matcher (equal to the JAX package's, tests/test_torch_ops.py), and the
degenerate pairs the bootstrap meets: a dead pair (every mask false), fewer
than 8 correspondences, zero baseline, pure rotation, one correspondence
repeated on every slot, NaN in masked slots and NaN in a valid one.

Tolerances. Against the JAX package's ``estimate_transform`` under
``jax.vmap``, evaluated in float64 (``test_torch_pipeline``'s docstring says
why): chosen poses within 1e-4. Against the port's previous per-pair form
(``torch.linalg.eigh``, ``solve_ex`` and ``svd``, kept here as
:func:`previous_estimate_transform`): within 1e-5, so the same candidate. A
pair alone, in the batch of 64 and in blocks of 32 and 16: bit for bit.

The degenerate pairs. A dead pair and a pair with a NaN in a valid slot come
out as the identity, as in the JAX package (the previous form raised on the
NaN: ``eigh`` does not converge); NaN in masked slots leaves the pose as it
is. With fewer than 8 correspondences, zero baseline, pure rotation or one
repeated correspondence the normal matrix's null space has more than one
dimension: every eigen-solver picks another vector in it (the previous form
and the JAX package differ there by 0.4-1.0 too), so the pose is not
determined and ``pipeline.check_bootstrap`` guards the pipeline against
such pairs. There the test holds what is determined: the result is a finite
rigid transform or the identity, and has the same bits in any batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import landmark_map as jlm
from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.ops import epipolar as jepi
from visual_odometry_tpu.ops import se3 as jse3
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.models import landmark_map as tlm
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.ops import epipolar, se3, triangulation
from visual_odometry_tpu_torch.ops.kernels import epipolar_kernel as ek
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

from test_torch_pipeline import jax_bootstrap_in_double

S = 64
K = tsyn.deep_camera().camera_matrix
WELL_POSED = [(seed, motion) for motion in (6.0, 3.0) for seed in range(28)]   # 56 pairs
MOUNT = np.array(jse3.v2t_euler(jnp.float32([0.05, -0.1, 0.02, 0.01, -0.02, 0.015])))


def _frames(seed, motion):
    pts, apps, masks = jsyn.generate_tracking_sequence(np.random.default_rng(seed), 2, S,
                                                       seed_motion=motion)
    return pts, apps, masks


def _pair(seed, motion):
    """(idx1, idx2, valid, p1, p2, mask1, mask2) of one matched frame pair."""
    pts, apps, masks = (torch.from_numpy(x) for x in _frames(seed, motion))
    ids = torch.full(masks.shape, -1, dtype=torch.int32)
    f0, f1 = (tpipe.FrameData(pts[i], apps[i], masks[i], ids[i]) for i in (0, 1))
    corr = tpipe._match(VOConfig(n_slots=S), False, f0, f1)
    return [corr.idx1, corr.idx2, corr.valid, pts[0], pts[1], masks[0], masks[1]]


def _degenerate():
    """{name: (pair, determined)}: ``determined`` names the pose the pair must
    give (``"identity"``, ``"clean"`` for the clean pair's), else None."""
    i1, i2, v, p1, p2, m1, m2 = _pair(3, 6.0)
    live = torch.nonzero(v)[:, 0]
    out = {"dead": ([i1, i2, torch.zeros_like(v), p1, p2, torch.zeros_like(m1),
                     torch.zeros_like(m2)], "identity")}
    for n in (5, 7):
        few = v.clone()
        few[live[n:]] = False
        out[f"fewer_than_8_{n}"] = ([i1, i2, few, p1, p2, m1, m2], None)
    out["zero_baseline"] = ([i1, i1, v, p1, p1, m1, m1], None)
    rot = se3.euler_to_rotation(torch.tensor([0.02, -0.03, 0.01]))
    h = torch.cat([p1, torch.ones(S, 1)], 1) @ (K @ rot @ torch.linalg.inv(K)).T
    out["pure_rotation"] = ([i1, i1, v, p1, (h[:, :2] / h[:, 2:]).contiguous(), m1, m1], None)
    out["repeated"] = ([torch.where(v, i1[live[0]], 0), torch.where(v, i2[live[0]], 0), v, p1,
                        p2, m1, m2], None)
    masked_nan = p1.clone()
    masked_nan[~m1] = float("nan")
    out["nan_masked"] = ([i1, i2, v, masked_nan, p2, m1, m2], "clean")
    valid_nan = p1.clone()
    valid_nan[i1[live[0]]] = float("nan")
    out["nan_valid"] = ([i1, i2, v, valid_nan, p2, m1, m2], "identity")
    return out


DEGENERATE = _degenerate()


def _stack(pairs):
    return [torch.stack(x) for x in zip(*pairs)]


@pytest.fixture(scope="module")
def batch64():
    """56 well-posed pairs and the 8 degenerate ones, their P1 poses in one batch."""
    pairs = [_pair(*sm) for sm in WELL_POSED] + [p for p, _ in DEGENERATE.values()]
    assert len(pairs) == 64
    args = _stack(pairs)
    return args, ek.estimate_transform_batched(K, *args)


def jax_vmap_in_double(args):
    """JAX ``estimate_transform`` under ``jax.vmap`` in float64, as float32 poses."""
    with jax.enable_x64(True):
        up = [jnp.asarray(a.numpy()).astype(jnp.float64) if a.dtype == torch.float32
              else jnp.asarray(a.numpy()) for a in args]
        k = jnp.asarray(K.numpy()).astype(jnp.float64)
        out = jax.vmap(lambda *a: jepi.estimate_transform(k, *a))(*up)
        return np.asarray(out).astype(np.float32)


def previous_estimate_transform(k, idx1, idx2, valid, p1, p2, mask1, mask2):
    """The port's per-pair bootstrap before P1 (LAPACK through torch.linalg)."""
    f = epipolar.estimate_fundamental(idx1, idx2, valid, p1, p2, mask1, mask2)
    r1, t1, r2, t2 = epipolar.essential_to_transform_pair(k.T @ f @ k)
    cands = se3.pose_from_rt(torch.stack([r1, r1, r2, r2]), torch.stack([t1, -t1, t2, -t2]))
    q1, q2 = p1[idx1.long()], p2[idx2.long()]
    votes = torch.stack([triangulation.triangulate_pairs(k, x, q1, q2, valid)[1].sum()
                         for x in cands])
    best = torch.argmax(votes)
    return torch.where(votes[best] > 0, cands[best], torch.eye(4)), votes[best]


def _rigid_or_identity(x):
    x = x.double()
    r = x[:3, :3]
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x[3], torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=x.dtype))
    torch.testing.assert_close(r.T @ r, torch.eye(3, dtype=x.dtype), atol=1e-5, rtol=0)
    assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5


def test_plain_matches_jax_vmap_in_double(batch64):
    """(a) The 56 well-posed pairs' poses within 1e-4 of the JAX function's
    under jax.vmap in float64, and each a rigid transform."""
    args, poses = batch64
    n = len(WELL_POSED)
    ref = jax_vmap_in_double([a[:n] for a in args])
    np.testing.assert_allclose(poses[:n].numpy(), ref, atol=1e-4)
    for x in poses[:n]:
        _rigid_or_identity(x)


@pytest.mark.parametrize("name", sorted(DEGENERATE))
def test_degenerate_pairs(batch64, name):
    """(a) Each degenerate pair: the identity where the JAX package gives it
    (its float64 value held to 1e-4), the clean pair's pose under NaN in masked
    slots, else a finite rigid transform or the identity (module docstring)."""
    pair, determined = DEGENERATE[name]
    got = ek.estimate_transform_batched(K, *(x[None] for x in pair))[0]
    _rigid_or_identity(got)
    if determined == "identity":
        assert torch.equal(got, torch.eye(4))
        np.testing.assert_allclose(jax_vmap_in_double([x[None] for x in pair])[0], np.eye(4),
                                   atol=1e-4)
    elif determined == "clean":
        clean = _pair(3, 6.0)
        want = ek.estimate_transform_batched(K, *(x[None] for x in clean))[0]
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), jax_vmap_in_double([x[None] for x in clean])[0],
                                   atol=1e-4)


def test_plain_matches_previous_per_pair_form(batch64):
    """(b) Against the port's previous per-pair form: the same candidate,
    poses within 1e-5, over the well-posed pairs, the dead pair and NaN in
    masked slots."""
    args, poses = batch64
    rows = list(range(len(WELL_POSED))) + [len(WELL_POSED) + list(DEGENERATE).index(n)
                                           for n in ("dead", "nan_masked")]
    for i in rows:
        prev, votes = previous_estimate_transform(K, *(a[i] for a in args))
        np.testing.assert_allclose(poses[i].numpy(), prev.numpy(), atol=1e-5)
        assert (int(votes) > 0) == (not torch.equal(poses[i], torch.eye(4)))


@pytest.mark.parametrize("block", [1, 16, 32])
def test_batch_invariance_bitwise(batch64, block):
    """(c) Each pair alone and in blocks of 32 and 16 has the bits it has in
    the batch of 64, degenerate pairs included."""
    args, poses = batch64
    parts = [ek.estimate_transform_batched(K, *(a[i:i + block] for a in args))
             for i in range(0, 64, block)]
    got = torch.cat(parts)
    assert torch.equal(got.view(torch.int32), poses.view(torch.int32))


def test_estimate_transform_is_the_batch_of_one(batch64):
    """``epipolar.estimate_transform`` (the JAX name's counterpart) is P1's
    batch of one."""
    args, poses = batch64
    for i in (0, 7, 60):
        got = epipolar.estimate_transform(K, *(a[i] for a in args))
        assert torch.equal(got.view(torch.int32), poses[i].view(torch.int32))


@pytest.mark.parametrize("planar", [False, True])
def test_initialize_batched_matches_jax_vmap(planar):
    """(d) The batched initialize over 8 pairs against JAX
    ``jax.vmap(pipeline.initialize)`` with its bootstrap in float64: x_init
    within 1e-4; triangulation validity, map count, map validity and the
    lookup equal. Each pair's state equals ``initialize`` of that pair alone,
    bit for bit."""
    seqs = [_frames(seed, 6.0) for seed in range(8)]
    pts, apps, masks = (np.stack([s[k] for s in seqs]) for k in range(3))
    ids = np.full(masks.shape, -1, np.int32)
    cfg, jcfg = VOConfig(n_slots=S, map_capacity=256), JaxConfig(n_slots=S, map_capacity=256)
    if planar:
        cfg, jcfg = cfg.with_planar_mount(MOUNT), jcfg.with_planar_mount(MOUNT)
    tf = [tpipe.FrameData(*(torch.from_numpy(np.ascontiguousarray(x[:, i]))
                            for x in (pts, apps, masks, ids))) for i in (0, 1)]
    state, x_init = tpipe.initialize_batched(tsyn.deep_camera(), cfg, *tf)
    jf = [jpipe.FrameData(*(jnp.asarray(x[:, i]) for x in (pts, apps, masks, ids)))
          for i in (0, 1)]
    with jax_bootstrap_in_double():
        jstate, jx = jax.vmap(lambda a, b: jpipe.initialize(jsyn.deep_camera(), jcfg, a, b))(*jf)
        jx = np.asarray(jx)
    np.testing.assert_allclose(x_init.numpy(), jx, atol=1e-4)
    np.testing.assert_array_equal(state.tri_valid.numpy(), np.asarray(jstate.tri_valid))
    np.testing.assert_array_equal(state.point_lookup.numpy(), np.asarray(jstate.point_lookup))
    np.testing.assert_array_equal(state.map.count.numpy(), np.asarray(jstate.map.count))
    np.testing.assert_array_equal(state.map.valid.numpy(), np.asarray(jstate.map.valid))
    assert x_init.shape == (8, 4, 4) and state.map.points.shape == (8, 256, 3)
    for i in range(8):
        alone, xi = tpipe.initialize(tsyn.deep_camera(), cfg, *(type(f)(*(x[i] for x in f))
                                                                 for f in tf))
        assert torch.equal(xi, x_init[i])
        for a, b in zip(tpipe._index_state(state, i), alone):
            for u, w in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                assert torch.equal(u, w)


def _fold_streams(rng, b=5, t=300, keys=120, d=10):
    """b streams of re-observed keys; stream 1 empty, a -0.0 twin of a +0.0
    key in stream 0, the same key table for all (groups must not span streams)."""
    table = rng.uniform(-1, 1, (keys, d)).astype(np.float32)
    table[0, 0] = 0.0
    apps = table[rng.integers(0, keys, (b, t))]
    apps[0, np.where((apps[0] == table[0]).all(1))[0][:1], 0] = -0.0
    pts = rng.normal(size=(b, t, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, t)) > 0.2
    mask[1] = False
    return pts, apps, mask


@pytest.mark.parametrize("capacity", [40, 512])
def test_merge_stream_batched(rng, capacity):
    """(e) One batched fold against the per-sequence fold, bit for bit, and
    against JAX ``jax.vmap(merge_stream)``: capacity truncation (40 slots for
    ~100 keys), an empty sequence and a -0.0 key."""
    pts, apps, mask = _fold_streams(rng)
    assert (apps[0] == 0.0).all(1).any() or np.signbit(apps[0][:, 0]).any()
    got = tlm.merge_stream(*(torch.from_numpy(x) for x in (pts, apps, mask)), capacity)
    assert got.count.shape == (5,) and int(got.count[1]) == 0
    if capacity == 40:
        assert int(got.count.max()) == 40
    for i in range(5):
        alone = tlm.merge_stream(*(torch.from_numpy(x[i]) for x in (pts, apps, mask)), capacity)
        for a, b in zip(got, alone):
            assert torch.equal(a[i], b)
    ref = jax.vmap(lambda p, a, m: jlm.merge_stream(p, a, m, capacity))(
        *(jnp.asarray(x) for x in (pts, apps, mask)))
    for name in ("points", "appearances", "valid", "count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))


def test_fold_map_batched_equals_each_sequence():
    """``pipeline._fold_map`` over a batch (one merge_stream call) gives each
    sequence the map of its own fold, bit for bit."""
    rng = np.random.default_rng(5)
    b, f, d = 3, 4, 10
    init = tpipe.InitTriangulation(torch.from_numpy(rng.normal(size=(b, S, 3)).astype(np.float32)),
                                   torch.from_numpy(rng.uniform(size=(b, S, d)).astype(np.float32)),
                                   torch.from_numpy(rng.uniform(size=(b, S)) > 0.3))
    apps = init.apps[:, None].expand(b, f, S, d).contiguous()
    outs = tpipe.FrameOutput(*([None] * 5), tri_apps=apps,
                             tri_valid=torch.from_numpy(rng.uniform(size=(b, f, S)) > 0.5),
                             join_overflow=None, tri_points=None, gn_rounds=None)
    tri_world = torch.from_numpy(rng.normal(size=(b, f, S, 3)).astype(np.float32))
    cfg = VOConfig(n_slots=S, map_capacity=96)
    got = tpipe._fold_map(cfg, init, tri_world, outs)
    for i in range(b):
        one = tpipe._fold_map(cfg, type(init)(*(x[i] for x in init)), tri_world[i],
                              outs._replace(tri_apps=apps[i], tri_valid=outs.tri_valid[i]))
        for x, y in zip(got, one):
            assert torch.equal(x[i], y)


def test_work_tally_counts_the_bootstrap():
    """Inside ``_lib.counting_work`` the batched bootstrap adds P1's model
    once a call at its shapes, the bootstrap instance's seed included (the
    work partition of parallel/scaling counts it), whichever backend runs
    it."""
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import roofline

    seqs = [_frames(seed, 6.0) for seed in range(3)]
    pts, apps, masks = (torch.from_numpy(np.stack([s[k] for s in seqs])) for k in range(3))
    ids = torch.full(masks.shape, -1, dtype=torch.int32)
    f0, f1 = (tpipe.FrameData(*(x[:, i] for x in (pts, apps, masks, ids))) for i in (0, 1))
    cfg = VOConfig(n_slots=S)
    with _lib.counting_work() as work:
        tpipe.initialize_batched(tsyn.deep_camera(), cfg, f0, f1)
    m = roofline.eight_point_model(3, S, S, capacity=cfg.map_capacity, d=apps.shape[-1])
    assert work["eight_point"] == [1, m.tc_flops, m.fp32_ops, m.hbm_bytes,
                                   m.speed_of_light_s(roofline.H100)]
