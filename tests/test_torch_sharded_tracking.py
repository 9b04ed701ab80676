"""The port's multi-device tracking and refinement entry points, on the CPU,
in one world of 4 ranks over gloo: dp serving
(``multiseq.run_sequences_batched(mesh=)``), sequence-parallel chunking
(``posegraph.run_sequence_chunked(mesh=)``), ``refinement.refine_trajectory[_sparse](mesh=)``
and ``posegraph.refine_stitched(mesh=)``.

Inputs. Serving: 4 sequences of ``generate_tracking_sequence(default_rng(7 + i),
10, 64, seed_motion=6)`` (tests/test_torch_serving.py's kind, one more to fill
the dp axis of 2) on a (2, 2) mesh. Chunking: tests/test_torch_posegraph.py's
sequence (32 frames x 64 slots, overlap 6, no slack) in 4 chunks over a (4, 1)
mesh. Refinement: tests/test_torch_refinement.py's generated dataset (40
frames, 400 landmarks) tracked once, refined 5 iterations.

Tolerances. Tracking moves nothing between ranks, so dp and sp equal the
port's unsharded calls bit for bit (rank 0 runs those in the same process).
Against the JAX package's mesh runs, each package bootstrapping itself (the
JAX 8-point step in float64, test_torch_pipeline.jax_bootstrap_in_double),
the bounds the unsharded forms are held to: trajectories within 5e-4, map
counts and validity exact (tests/test_torch_serving.py); chunk scales within
1e-4 relative, trajectories within 5e-4 (tests/test_torch_posegraph.py).
Sharded refinement sums each pose-space term over the ranks in another
order: positions and landmarks within 1e-3 of the single-device run
(tests/test_torch_refinement.py's bound against the JAX package), chi within
1e-3 relative. refine_stitched over a mesh without an ``lm`` axis refines on
one device: bit for bit. JAX and the helpers that use it are imported inside
the tests only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.models import refinement as tref
from visual_odometry_tpu_torch.parallel import mesh as tmesh
from visual_odometry_tpu_torch.parallel import multiseq as tmulti
from visual_odometry_tpu_torch.parallel import posegraph as tpg
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

WORLD = 4
SERVE = dict(n_slots=64, map_capacity=256, gn_iterations=30)
CHUNK = dict(n_slots=64, map_capacity=1024)
CHUNKS, OVERLAP = 4, 6
POSE_TOL, SCALE_RTOL, REFINE_TOL = 5e-4, 1e-4, 1e-3
REFINE_ITERATIONS = 5


def _rank_runs(serve_batch, chunk_seq, tracked):
    """Every rank: each entry point over its mesh; rank 0 also runs each
    unsharded, in this process."""
    rank = torch.distributed.get_rank()
    out = {}
    cam = tsyn.deep_camera()
    batch = tuple(torch.from_numpy(x) for x in serve_batch)
    seq = tuple(torch.from_numpy(x) for x in chunk_seq)
    square = tmesh.make_mesh(device="cpu")                 # (dp, lm) = (2, 2)
    tall = tmesh.make_mesh(dp_size=WORLD, device="cpu")    # (4, 1)
    wide = tmesh.make_mesh(dp_size=1, device="cpu")        # (1, 4)
    line = tmesh.single_axis_mesh(name="lm", device="cpu")
    only_dp = tmesh.single_axis_mesh(name="dp", device="cpu")

    out["dp"] = tmulti.run_sequences_batched(cam, VOConfig(**SERVE), *batch, mesh=square)
    out["sp"] = tpg.run_sequence_chunked(cam, VOConfig(**CHUNK), *seq, num_chunks=CHUNKS,
                                         overlap=OVERLAP, slack=0, mesh=tall)
    k, traj, map_state, points, apps, mask = tracked
    args = (k, traj, map_state, points, apps, mask)
    kw = dict(num_iterations=REFINE_ITERATIONS, device="cpu")
    out["dense"] = tref.refine_trajectory(*args, mesh=wide, **kw)
    out["sparse"] = tref.refine_trajectory_sparse(*args, mesh=line, **kw)
    camera = tsyn.default_camera()._replace(camera_matrix=torch.from_numpy(k))
    stitched = (camera, DEFAULT_CONFIG, torch.from_numpy(traj), map_state,
                *(torch.from_numpy(x) for x in (points, apps, mask)))
    out["stitched_lm"] = tpg.refine_stitched(*stitched, num_iterations=REFINE_ITERATIONS,
                                             mesh=wide)
    out["stitched_dp"] = tpg.refine_stitched(*stitched, num_iterations=REFINE_ITERATIONS,
                                             mesh=only_dp)
    errors = {}
    for label, call in (
            ("dp", lambda: tmulti.run_sequences_batched(
                cam, VOConfig(**SERVE), *(x[:3] for x in batch), mesh=square)),
            ("sp", lambda: tpg.run_sequence_chunked(cam, VOConfig(**CHUNK), *seq, num_chunks=3,
                                                    overlap=OVERLAP, slack=0, mesh=tall)),
            ("dense_dp", lambda: tref.refine_trajectory(*args, mesh=square, **kw)),
            ("dense_lm_only", lambda: tref.refine_trajectory(*args, mesh=line, **kw))):
        try:
            call()
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    if rank == 0:
        out["ref"] = dict(
            dp=tmulti.run_sequences_batched(cam, VOConfig(**SERVE), *batch),
            sp=tpg.run_sequence_chunked(cam, VOConfig(**CHUNK), *seq, num_chunks=CHUNKS,
                                        overlap=OVERLAP, slack=0),
            dense=tref.refine_trajectory(*args, **kw),
            sparse=tref.refine_trajectory_sparse(*args, **kw),
            stitched=tpg.refine_stitched(*stitched, num_iterations=REFINE_ITERATIONS))
    return out


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(serving batch, chunked sequence, tracked dataset) as numpy, the last
    as (camera matrix, trajectory, map, points, appearances, mask)."""
    import os

    from visual_odometry_tpu.utils import dataset_gen as jdg
    from visual_odometry_tpu.utils import synthetic as jsyn
    from visual_odometry_tpu_torch.models import pipeline as tpipe
    from visual_odometry_tpu_torch.ops.camera import Camera
    from visual_odometry_tpu_torch.utils import io

    seqs = [jsyn.generate_tracking_sequence(np.random.default_rng(7 + i), 10, 64,
                                            seed_motion=6.0) for i in range(4)]
    batch = tuple(np.stack([s[k] for s in seqs]) for k in range(3))
    chunk_seq = jsyn.generate_tracking_sequence(np.random.default_rng(0), 32, 64,
                                                seed_motion=6.0)
    data = str(tmp_path_factory.mktemp("dataset") / "data")
    jdg.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    params = io.load_camera_params(os.path.join(data, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device="cpu")
    seq = io.load_sequence(data, DEFAULT_CONFIG.n_slots)
    traj, map_state, _ = tpipe.run_sequence(
        camera, DEFAULT_CONFIG, *(torch.from_numpy(x) for x in (seq.points, seq.appearances,
                                                                seq.mask)))
    tracked = (np.asarray(params.camera_matrix, np.float32), traj.numpy(), map_state,
               seq.points, seq.appearances, seq.mask)
    return batch, tuple(np.ascontiguousarray(x) for x in chunk_seq), tracked


@pytest.fixture(scope="module")
def world(inputs):
    return tmesh.run_local(_rank_runs, WORLD, *inputs)


def _same(a, b) -> bool:
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _flat(out):
    """The tensors of a (trajectory, map, outputs) triple in order."""
    return [out[0], *out[1], *out[2]]


@pytest.mark.parametrize("entry", ["dp", "sp"])
def test_sharded_tracking_equals_unsharded(world, entry):
    """Every rank returns the whole result, equal bit for bit to the unsharded call."""
    ref = _flat(world[0]["ref"][entry])
    for res in world:
        got = _flat(res[entry])
        assert len(got) == len(ref) and all(_same(a, b) for a, b in zip(got, ref))


def test_dp_serving_matches_jax_mesh(inputs, world):
    """Against JAX ``run_sequences_batched`` over make_mesh(2, dp_size=2)."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_tpu.parallel import multiseq as jmulti
    from visual_odometry_tpu.parallel.mesh import make_mesh
    from visual_odometry_tpu.utils import synthetic as jsyn
    from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
    from test_torch_pipeline import jax_bootstrap_in_double

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    batch = inputs[0]
    with jax_bootstrap_in_double():
        jtraj, jmaps, jouts = jmulti.run_sequences_batched(
            jsyn.deep_camera(), JaxConfig(**SERVE), *(jnp.asarray(x) for x in batch),
            mesh=make_mesh(2, ("dp", "lm"), dp_size=2))
        jtraj = np.asarray(jtraj)
    traj, maps, outs = world[0]["dp"]
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=POSE_TOL)
    np.testing.assert_array_equal(maps.count.numpy(), np.asarray(jmaps.count))
    np.testing.assert_array_equal(maps.valid.numpy(), np.asarray(jmaps.valid))
    np.testing.assert_array_equal(outs.num_matches.numpy(), np.asarray(jouts.num_matches))


def test_sp_chunking_matches_jax_mesh(inputs, world):
    """Against JAX ``run_sequence_chunked`` over make_mesh(4, dp_size=4), its
    fused path through the Pallas interpreter (tests/test_torch_posegraph.py)."""
    import jax
    import jax.numpy as jnp

    from visual_odometry_tpu.parallel import posegraph as jpg
    from visual_odometry_tpu.parallel.mesh import make_mesh
    from visual_odometry_tpu.utils import synthetic as jsyn
    from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
    from test_torch_pipeline import jax_bootstrap_in_double
    from test_torch_posegraph import JAX_FUSED

    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 virtual devices")
    with jax_bootstrap_in_double():
        jtraj, jmap, jdiags = jpg.run_sequence_chunked(
            jsyn.deep_camera(), JaxConfig(**CHUNK, **JAX_FUSED),
            *(jnp.asarray(x) for x in inputs[1]), num_chunks=CHUNKS, overlap=OVERLAP, slack=0,
            mesh=make_mesh(WORLD, ("dp", "lm"), dp_size=WORLD))
        jtraj = np.asarray(jtraj)
    traj, final_map, diags = world[0]["sp"]
    np.testing.assert_allclose(traj.numpy(), jtraj, atol=POSE_TOL)
    np.testing.assert_allclose(diags.scales.numpy(), np.asarray(jdiags.scales), rtol=SCALE_RTOL)
    np.testing.assert_array_equal(diags.num_ratio_obs.numpy(), np.asarray(jdiags.num_ratio_obs))
    assert int(final_map.count) == int(jmap.count)


@pytest.mark.parametrize("form", ["dense", "sparse"])
def test_sharded_refinement_matches_single_device(world, form):
    rel_ref, lms_ref, apps_ref, stats_ref = world[0]["ref"][form]
    for res in world:
        rel, lms, apps, stats = res[form]
        np.testing.assert_array_equal(apps, apps_ref)
        np.testing.assert_allclose(rel[:, :3, 3], rel_ref[:, :3, 3], atol=REFINE_TOL)
        np.testing.assert_allclose(rel[:, :3, :3], rel_ref[:, :3, :3], atol=REFINE_TOL)
        np.testing.assert_allclose(lms, lms_ref, atol=REFINE_TOL)
        chi, chi_ref = (float(np.asarray(s.chi).reshape(-1)[0]) for s in (stats, stats_ref))
        np.testing.assert_allclose(chi, chi_ref, rtol=REFINE_TOL)
        assert int(np.asarray(stats.num_obs).reshape(-1)[0]) == int(stats_ref.num_obs)


def test_refine_stitched_over_a_mesh(world):
    """With an ``lm`` axis: sharded, within the refinement bound; on a ('dp',)
    mesh: one device, bit for bit."""
    traj_ref, map_ref = world[0]["ref"]["stitched"]
    for res in world:
        traj, refined = res["stitched_lm"]
        np.testing.assert_allclose(traj.numpy(), traj_ref.numpy(), atol=REFINE_TOL)
        np.testing.assert_allclose(refined.points.numpy(), map_ref.points.numpy(),
                                   atol=REFINE_TOL)
        assert int(refined.count) == int(map_ref.count)
        traj, refined = res["stitched_dp"]
        assert _same(traj, traj_ref) and all(_same(a, b) for a, b in zip(refined, map_ref))


def test_mesh_shapes_that_do_not_divide_raise(world):
    errors = world[0]["errors"]
    assert errors["dp"] == "the mesh axis 'dp' of size 2 does not divide 3 sequences"
    assert errors["sp"] == "the mesh axis 'dp' of size 4 does not divide 3 chunks"
    assert errors["dense_dp"] == ("a batch of one sequence does not divide the mesh's dp axis "
                                  "of size 2")
    assert errors["dense_lm_only"] == "mesh axes ('lm',) have no axis 'dp'"
