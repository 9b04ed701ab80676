"""The whole two-view bootstrap of a batch, P1's bootstrap instance
(``epipolar_kernel.bootstrap_batched``), on the CPU: its plain route.

(a) Against the composition the port ran before the seed moved into P1, kept
here as :func:`former_bootstrap`: the pose's plain version, then the former
``pipeline._seed`` (planarization, triangulation, ``landmark_map.update`` on
an empty map, the lookup, the inverse), bit for bit on every output, through
``pipeline.initialize_batched``, through the wrapper itself and, pair by
pair, through ``pipeline.initialize``.

(b) Against the JAX package's ``jax.vmap(pipeline.initialize)`` with its
bootstrap in float64 (``test_torch_pipeline.jax_bootstrap_in_double``), at
``test_torch_bootstrap.test_initialize_batched_matches_jax_vmap``'s
tolerances: x_init within 1e-4; triangulation validity, map count, map
validity and the lookup equal.

Each case is a batch of 8 frame pairs of ``generate_tracking_sequence(
default_rng(seed), 2, 64, seed_motion=6.0)``, the second frame's slots
permuted (so the lookup is no identity), matched by each package's own
matcher unless the case edits the correspondences (then both get the same):

- ``truncation``: map capacity 40 below the pairs' ~64 triangulated slots;
- ``duplicate_idx2``: on pair 2, slot 9 a copy of slot 3 (the same
  measurements) and slot 20 on slot 11's second-frame measurement: the
  lookup keeps the first live slot;
- ``dead_and_few``: pair 1 without a valid correspondence (the identity, an
  empty map, a lookup of -1) and pair 4 with 5: its pose is not determined
  (``test_torch_bootstrap``'s docstring), so (b) skips that pair;
- ``planar``: the planar mount of ``test_torch_bootstrap``;
- ``known_da``: matched by landmark id (``use_known_da``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.models import pipeline as jpipe
from visual_odometry_tpu.ops import matching as jmatching
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.models import landmark_map
from visual_odometry_tpu_torch.models import pipeline as tpipe
from visual_odometry_tpu_torch.models.landmark_map import LandmarkMap
from visual_odometry_tpu_torch.ops import matching, se3, triangulation
from visual_odometry_tpu_torch.ops.kernels import epipolar_kernel as ek
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

from test_torch_bootstrap import MOUNT
from test_torch_pipeline import jax_bootstrap_in_double

S, B = 64, 8
CASES = ("truncation", "duplicate_idx2", "dead_and_few", "planar", "known_da")
UNDETERMINED = {"dead_and_few": (4,)}   # pairs whose pose the data do not fix


def _former_lookup(corr, tri_ok, n_slots):
    """The former ``pipeline._lookup_from_corr``."""
    live = (corr.valid & tri_ok).reshape(-1, n_slots)
    slots = torch.arange(n_slots, dtype=torch.int64).expand_as(live)
    target = torch.where(live, corr.idx2.reshape(-1, n_slots).long(), n_slots)
    lut = torch.full((live.shape[0], n_slots + 1), n_slots + 1, dtype=torch.int64)
    lut = lut.scatter_reduce(1, target, slots, reduce="amin")[:, :n_slots]
    return torch.where(lut <= n_slots, lut, -1).to(torch.int32).reshape(corr.idx2.shape)


def former_bootstrap(camera, config, frame0, frame1, corr):
    """``pipeline.initialize_batched`` as it stood before P1's bootstrap
    instance: the pose's plain version, then the former ``pipeline._seed``."""
    x_init = ek.estimate_transform_batched_plain(
        camera.camera_matrix, corr.idx1, corr.idx2, corr.valid, frame0.points, frame1.points,
        frame0.mask, frame1.mask)
    mul = se3.matmul_elementwise
    if config.planar:
        mount = config.planar_mount()
        c = (torch.eye(4) if mount is None else torch.from_numpy(mount)).to(x_init.dtype)
        ci = se3.inverse_elementwise(c)
        x_init = mul(mul(ci, se3.project_se2_elementwise(mul(mul(c, x_init), ci))), c)

    def take(rows, idx):
        k = idx.long()
        return torch.gather(rows, 1, k[..., None].expand(k.shape + rows.shape[-1:]))

    tri, ok = triangulation.triangulate_pairs_elementwise(
        camera.camera_matrix, x_init, take(frame0.points, corr.idx1),
        take(frame1.points, corr.idx2), corr.valid)
    tri_apps = take(frame1.appearances, corr.idx2)
    empty = LandmarkMap.empty(config.map_capacity, frame0.appearances.shape[-1], tri.dtype)
    map_state = landmark_map.update(
        LandmarkMap(*(x.expand((tri.shape[0],) + x.shape) for x in empty)), tri, tri_apps, ok)
    state = tpipe.VOState(ref=frame1, point_lookup=_former_lookup(corr, ok, config.n_slots),
                          tri_points=tri, tri_valid=ok, x_curr=x_init,
                          history=se3.inverse_elementwise(x_init), map=map_state)
    return state, x_init


def _flat(t):
    return [t] if isinstance(t, torch.Tensor) else [y for x in t for y in _flat(x)]


def _same_bits(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x, y = x.contiguous().view(torch.int32), y.contiguous().view(torch.int32)
        assert torch.equal(x, y)


def _case(name):
    """(port config, JAX config, port frames, JAX frames, use_known_da,
    corr or None) for one case."""
    rng = np.random.default_rng(7)
    seqs = [jsyn.generate_tracking_sequence(np.random.default_rng(seed), 2, S, seed_motion=6.0)
            for seed in range(B)]
    pts, apps, masks = (np.stack([q[k] for q in seqs]) for k in range(3))
    ids = np.where(masks, np.arange(S, dtype=np.int32), -1).astype(np.int32)
    for i in range(B):   # the second frame's slots permuted
        perm = rng.permutation(S)
        for x in (pts, apps, masks, ids):
            x[i, 1] = x[i, 1][perm]
    cap = 40 if name == "truncation" else 128
    cfg = VOConfig(n_slots=S, map_capacity=cap)
    jcfg = JaxConfig(n_slots=S, map_capacity=cap)
    if name == "planar":
        cfg, jcfg = cfg.with_planar_mount(MOUNT), jcfg.with_planar_mount(MOUNT)
    tf = [tpipe.FrameData(*(torch.from_numpy(np.ascontiguousarray(x[:, i]))
                            for x in (pts, apps, masks, ids))) for i in (0, 1)]
    jf = [jpipe.FrameData(*(jnp.asarray(x[:, i]) for x in (pts, apps, masks, ids)))
          for i in (0, 1)]
    known = name == "known_da"
    corr = None
    if name in ("duplicate_idx2", "dead_and_few"):
        corr = tpipe._batched_match(cfg, False, tf[1], tf[0])
        i1, i2, v = (x.clone() for x in corr)
        if name == "duplicate_idx2":
            assert bool(v[2, 3] & v[2, 9] & v[2, 11] & v[2, 20])
            i1[2, 9], i2[2, 9] = i1[2, 3], i2[2, 3]
            i2[2, 20] = i2[2, 11]
        else:
            v[1] = False
            v[4, torch.nonzero(v[4])[5:, 0]] = False
        corr = matching.Correspondences(i1, i2, v)
    return cfg, jcfg, tf, jf, known, corr


@pytest.mark.parametrize("name", CASES)
def test_plain_route_equals_the_former_composition(name):
    """(a) Every output bit for bit: initialize_batched, the wrapper, and
    initialize pair by pair."""
    cfg, _, (f0, f1), _, known, corr = _case(name)
    camera = tsyn.deep_camera()
    if corr is None:   # the case's own matcher, inside initialize_batched too
        corr = tpipe._batched_match(cfg, known, f1, f0)
        _same_bits(tpipe.initialize_batched(camera, cfg, f0, f1, known),
                   former_bootstrap(camera, cfg, f0, f1, corr))
    want = former_bootstrap(camera, cfg, f0, f1, corr)
    _same_bits(tpipe.initialize_batched(camera, cfg, f0, f1, known, corr=corr), want)
    mount = None
    if cfg.planar:
        mount = cfg.planar_mount()
    boot = ek.bootstrap_batched(camera.camera_matrix, *corr, f0.points, f1.points, f0.mask,
                                f1.mask, f1.appearances, cfg.map_capacity, mount)
    state, x_init = want
    _same_bits(boot, (x_init, state.history, state.tri_points, state.tri_valid, state.map,
                      state.point_lookup))
    for i in (0, 2, 4):
        pick = lambda t: type(t)(*(x[i] for x in t))   # noqa: E731
        alone = tpipe.initialize(camera, cfg, pick(f0), pick(f1), known, corr=pick(corr))
        _same_bits(alone, (tpipe._index_state(state, i), x_init[i]))
    if name == "truncation":
        assert int(state.map.count.min()) == cfg.map_capacity
        assert bool((state.tri_valid.sum(1) > cfg.map_capacity).all())
    if name == "duplicate_idx2":
        lk = state.point_lookup[2]
        assert bool(state.tri_valid[2, 3] & state.tri_valid[2, 9])
        assert int(lk[corr.idx2[2, 3]]) == 3
        assert int(lk[corr.idx2[2, 11]]) == (11 if bool(state.tri_valid[2, 11]) else 20)
    if name == "dead_and_few":
        assert torch.equal(x_init[1], torch.eye(4))
        assert int(state.map.count[1]) == 0 and bool((state.point_lookup[1] == -1).all())
        assert not bool(state.map.valid[1].any())
        assert bool(torch.isinf(state.map.appearances[1]).all())


@pytest.mark.parametrize("name", CASES)
def test_plain_route_matches_jax_vmap(name):
    """(b) Against ``jax.vmap(pipeline.initialize)`` in float64, each
    determined pair at the batched initialize test's tolerances."""
    cfg, jcfg, (f0, f1), jf, known, corr = _case(name)
    state, x_init = tpipe.initialize_batched(tsyn.deep_camera(), cfg, f0, f1, known, corr=corr)
    jcorr = None if corr is None else jmatching.Correspondences(
        *(jnp.asarray(x.numpy()) for x in corr))
    with jax_bootstrap_in_double():
        if jcorr is None:
            jstate, jx = jax.vmap(lambda a, b: jpipe.initialize(
                jsyn.deep_camera(), jcfg, a, b, known))(*jf)
        else:
            jstate, jx = jax.vmap(lambda a, b, c: jpipe.initialize(
                jsyn.deep_camera(), jcfg, a, b, known, corr=c))(*jf, jcorr)
        jx = np.asarray(jx)
    rows = [i for i in range(B) if i not in UNDETERMINED.get(name, ())]
    np.testing.assert_allclose(x_init.numpy()[rows], jx[rows], atol=1e-4)
    for got, want in ((state.tri_valid, jstate.tri_valid), (state.point_lookup,
                                                            jstate.point_lookup),
                      (state.map.count, jstate.map.count), (state.map.valid, jstate.map.valid)):
        np.testing.assert_array_equal(got.numpy()[rows], np.asarray(want)[rows])
