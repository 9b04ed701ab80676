"""The port's landmark-sharded bundle adjustment against its single-device
steps and the JAX package's sharded steps, on the CPU, in one world of 4
ranks over gloo.

Dense (``bundle_adjustment.make_sharded_ba_step``): the scene of
tests/test_bundle_adjustment.py (f=3, l=64), a batch of dp identical copies,
on (dp, lm) meshes (1, 4) and (2, 2) (the JAX test takes (1, 8) and (2, 4) of
its 8 devices; the JAX side here runs the port's two shapes on 4 of them):
every rank's block within 2e-3 of ``ba_step`` and of JAX's sharded step,
chi within 1e-3 relative (tests/test_bundle_adjustment.py:111-118).

Sparse (``sparse_ba.make_sharded_sparse_ba_step``): the scene of
tests/test_sparse_ba.py (f=3, l=64), 4 ``lm`` blocks, unpacked and packed,
200 CG iterations to 1e-10: poses within 5e-5 and landmarks within 5e-4 of
the port's single step and of JAX's sharded step, equal observation counts
(tests/test_sparse_ba.py:193-200, 347-353). ``partition_observations`` and
its packed form equal the JAX package's array for array.

JAX and the functions that make the scenes are imported inside the tests only: the ranks
import this module.
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.parallel import bundle_adjustment as tba
from visual_odometry_tpu_torch.parallel import mesh as tmesh
from visual_odometry_tpu_torch.parallel import sparse_ba as tsba

WORLD = 4
DENSE_MESHES = [(1, 4), (2, 2)]
BA_TOL, CHI_RTOL = 2e-3, 1e-3
POSE_TOL, LM_TOL = 5e-5, 5e-4
SPARSE = dict(damping=0.1, cg_iterations=200, cg_tolerance=1e-10)


def _block(x: np.ndarray, index: int, count: int, axis: int = 0) -> np.ndarray:
    """Block ``index`` of ``count`` equal blocks of ``x`` along ``axis``."""
    rows = x.shape[axis] // count
    return np.take(x, np.arange(index * rows, (index + 1) * rows), axis=axis)


def T(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def _rank_steps(k, dense, sparse_layouts):
    """Every rank: the dense step on each mesh shape, then the sparse step in
    each layout. ``dense`` holds the batch-of-1 arrays (poses, landmarks,
    observations, obs_mask); ``sparse_layouts`` {label: (arrays, lm_degree)}."""
    k = T(k)
    out = {}
    for dp, lm in DENSE_MESHES:
        mesh = tmesh.make_mesh(WORLD, dp_size=dp, device="cpu")
        i, j = mesh.axis_index("dp"), mesh.axis_index("lm")
        # This rank's block of the batch, then of each sequence's landmark axis.
        block = tba.BAProblem(*(
            T(_block(_block(np.repeat(x, dp, axis=0), i, dp), j, lm, axis) if axis else
              _block(np.repeat(x, dp, axis=0), i, dp))
            for x, axis in zip(dense, (0, 1, 2, 2))))
        out[dp, lm] = tba.make_sharded_ba_step(mesh, damping=0.1)(k, block)
    mesh = tmesh.single_axis_mesh(name="lm", device="cpu")
    i = mesh.axis_index("lm")
    for label, (arrays, degree) in sparse_layouts.items():
        problem = tsba.SparseBAProblem(T(arrays[0]), *(T(_block(x, i, WORLD))
                                                       for x in arrays[1:]))
        step = tsba.make_sharded_sparse_ba_step(mesh, lm_degree=degree, **SPARSE)
        out[label] = step(k, problem, tsba.plan_frames(problem))
    return out


@pytest.fixture(scope="module")
def scenes():
    """The JAX package's two scenes, as numpy."""
    from test_bundle_adjustment import _make_problem
    from test_sparse_ba import _problems

    cam, dense, *_ = _make_problem(np.random.default_rng(0), f=3, l=64)
    cam_s, _, sparse, *_ = _problems(np.random.default_rng(0), f=3, l=64)
    return (np.asarray(cam.camera_matrix), tuple(np.asarray(x) for x in dense),
            np.asarray(cam_s.camera_matrix), tuple(np.asarray(x) for x in sparse))


def _layouts(sparse):
    """{label: ((poses, landmarks, frame_idx, lm_idx, uv, mask) in shard-major
    order, lm_degree)} from the port's partitions."""
    poses, landmarks, fi, li, uv, mask = sparse
    out = {}
    for label, fn in (("unpacked", tsba.partition_observations),
                      ("packed", tsba.partition_observations_packed)):
        parts = fn(WORLD, len(landmarks), fi, li, uv, mask)
        lms = np.zeros((WORLD * parts[4], 3), np.float32)
        lms[:len(landmarks)] = landmarks
        out[label] = ((poses, lms, *parts[:4]), parts[5] if label == "packed" else None)
    return out


@pytest.fixture(scope="module")
def world(scenes):
    k, dense, k_s, sparse = scenes
    ranks = tmesh.run_local(_rank_steps, WORLD, k, tuple(x[None] for x in dense),
                            _layouts(sparse))
    # The sparse steps run on the sparse scene's camera; both scenes share it.
    assert np.array_equal(k, k_s)
    return ranks


@pytest.mark.parametrize("dp,lm", DENSE_MESHES)
def test_sharded_dense_step_matches_single_and_jax(scenes, world, dp, lm):
    import jax
    import jax.numpy as jnp

    from visual_odometry_tpu.parallel import bundle_adjustment as jba
    from visual_odometry_tpu.parallel import mesh as jmesh

    k, dense, *_ = scenes
    ref, ref_stats = tba.ba_step(T(k), tba.BAProblem(*(T(x) for x in dense)), damping=0.1)
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 virtual devices")
    jout, jstats = jba.make_sharded_ba_step(jmesh.make_mesh(WORLD, dp_size=dp), damping=0.1)(
        jnp.asarray(k), jba.BAProblem(*(jnp.asarray(np.repeat(x[None], dp, 0)) for x in dense)))
    rows = dense[1].shape[0] // lm
    for r, res in enumerate(world):
        out, stats = res[dp, lm]
        i, j = divmod(r, lm)
        cols = slice(j * rows, (j + 1) * rows)
        assert out.poses.shape[0] == 1 and out.landmarks.shape == (1, rows, 3)
        for want_p, want_l in ((ref.poses.numpy(), ref.landmarks.numpy()[cols]),
                               (np.asarray(jout.poses)[i], np.asarray(jout.landmarks)[i, cols])):
            np.testing.assert_allclose(out.poses[0].numpy(), want_p, rtol=BA_TOL, atol=BA_TOL)
            np.testing.assert_allclose(out.landmarks[0].numpy(), want_l, rtol=BA_TOL,
                                       atol=BA_TOL)
        np.testing.assert_allclose(float(stats.chi[0]), float(ref_stats.chi), rtol=CHI_RTOL)
        np.testing.assert_allclose(float(stats.chi[0]), float(jstats.chi[i]), rtol=CHI_RTOL)
        assert int(stats.num_obs[0]) == int(ref_stats.num_obs) == int(jstats.num_obs[i])


@pytest.mark.parametrize("label", ["unpacked", "packed"])
def test_sharded_sparse_step_matches_single_and_jax(scenes, world, label):
    import jax
    import jax.numpy as jnp

    from visual_odometry_tpu.parallel import sparse_ba as jsba
    from visual_odometry_tpu.parallel import mesh as jmesh

    _, _, k, sparse = scenes
    arrays, degree = _layouts(sparse)[label]
    ref, ref_stats = tsba.sparse_ba_step(T(k), tsba.SparseBAProblem(*(T(x) for x in sparse)),
                                         **SPARSE)
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 virtual devices")
    jout, jstats = jsba.make_sharded_sparse_ba_step(
        jmesh.single_axis_mesh(WORLD, "lm"), lm_degree=degree, **SPARSE)(
        jnp.asarray(k), jsba.SparseBAProblem(*(jnp.asarray(x) for x in arrays)))
    l = sparse[1].shape[0]
    landmarks = torch.cat([res[label][0].landmarks for res in world]).numpy()[:l]
    for res in world:
        out, stats = res[label]
        for want_p, want_l, want_n in (
                (ref.poses.numpy(), ref.landmarks.numpy(), int(ref_stats.num_obs)),
                (np.asarray(jout.poses), np.asarray(jout.landmarks)[:l], int(jstats.num_obs))):
            np.testing.assert_allclose(out.poses.numpy(), want_p, atol=POSE_TOL)
            np.testing.assert_allclose(landmarks, want_l, atol=LM_TOL)
            assert int(stats.num_obs) == want_n
        # Every rank holds the same replicated poses and stats.
        assert torch.equal(out.poses, world[0][label][0].poses)
        assert torch.equal(stats.chi, world[0][label][1].chi)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed,shards", [(0, 4), (1, 3), (2, 8)])
def test_partition_observations_match_jax(scenes, packed, seed, shards):
    """The scene's observations and a random ragged list (masked slots,
    landmarks seen up to 6 times), array for array."""
    from visual_odometry_tpu.parallel import sparse_ba as jsba

    if seed == 0:
        _, fi, li, uv, mask = (None, *scenes[3][2:])
        l = scenes[3][1].shape[0]
    else:
        rng = np.random.default_rng(seed)
        l, n = 37, 150
        fi = rng.integers(0, 9, n).astype(np.int32)
        li = rng.integers(0, l, n).astype(np.int32)
        uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
        mask = rng.uniform(size=n) > 0.2
    fn = "partition_observations_packed" if packed else "partition_observations"
    got = getattr(tsba, fn)(shards, l, fi, li, uv, mask)
    want = getattr(jsba, fn)(shards, l, np.asarray(fi), np.asarray(li), np.asarray(uv),
                             np.asarray(mask))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
