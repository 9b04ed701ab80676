"""The port's device meshes (parallel/mesh) against the JAX package's, on the CPU.

One world of 4 ranks over gloo (``mesh.run_local``) runs every rank-side
case once; each test reads its part of the ranks' results. Sums of small
integers in float32 are exact, so the collectives are held to numpy exactly.
The JAX side of ``make_mesh``'s ``dp_size`` rule runs on the virtual 8-device
CPU mesh of tests/conftest.py. JAX is imported inside the tests only: the
ranks import this module.
"""

import time

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.parallel import mesh as tmesh

WORLD = 4


def _rank_cases():
    """Every rank: a (2, 2) mesh, a one-axis mesh, a (4, 1) mesh, the three
    collectives, and the calls that must raise."""
    rank = torch.distributed.get_rank()
    m = tmesh.make_mesh(device="cpu")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    out = dict(
        rank=rank, shape=m.shape, axis_names=m.axis_names, device=str(m.device),
        backend=m.backend, dp=m.axis_index("dp"), lm=m.axis_index("lm"),
        psum_lm=tmesh.psum(m, x, "lm"), psum_dp=tmesh.psum(m, x, "dp"),
        pmin_lm=tmesh.pmin(m, torch.tensor([rank, -rank], dtype=torch.int32), "lm"),
        pmin_dp=tmesh.pmin(m, x - 10.0 * rank, "dp"),
        gather_dp=tmesh.all_gather(m, x, "dp"),
        gather_bool=tmesh.all_gather(m, torch.tensor([rank % 2 == 0, rank == 3]), "lm"),
        staged_bytes=m.staged_bytes, init_again=tmesh.init_distributed())
    line = tmesh.single_axis_mesh(name="lm", device="cpu")
    out.update(line_shape=line.shape, line_index=line.axis_index("lm"),
               line_psum=tmesh.psum(line, torch.ones(2, dtype=torch.int64), "lm"))
    out["tall_shape"] = tmesh.make_mesh(dp_size=4, device="cpu").shape
    errors = {}
    for label, call in (("n_devices", lambda: tmesh.make_mesh(2, device="cpu")),
                        ("dp_size", lambda: tmesh.make_mesh(dp_size=3, device="cpu")),
                        ("backend", lambda: tmesh.make_mesh(device="cpu", backend="nccl"))):
        try:
            call()
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    return out


def _fail_on_rank_one():
    """Rank 1 raises while rank 0 waits: the world must end, not hang."""
    tmesh.single_axis_mesh(device="cpu")
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank one fails")
    time.sleep(600)


@pytest.fixture(scope="module")
def world():
    return tmesh.run_local(_rank_cases, WORLD)


@pytest.mark.parametrize("n", range(1, 9))
def test_default_dp_size_matches_jax(n):
    from visual_odometry_tpu.parallel import mesh as jmesh

    assert tmesh.default_dp_size(n) == jmesh.make_mesh(n).devices.shape[0]


@pytest.mark.parametrize("shape,axis,multiple,fill", [
    ((10, 3), 0, 4, 0), ((8, 3), 0, 4, 0), ((2, 5, 2), 1, 4, -1), ((0, 2), 0, 3, 0)])
def test_pad_to_multiple_matches_jax(shape, axis, multiple, fill):
    from visual_odometry_tpu.parallel import mesh as jmesh

    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got, n = tmesh.pad_to_multiple(x, axis, multiple, fill)
    want, n_want = jmesh.pad_to_multiple(x, axis, multiple, fill)
    assert n == n_want
    np.testing.assert_array_equal(got, want)


def test_mesh_layout_is_jax_reshape(world):
    """Rank r sits at (r // lm, r % lm), as JAX's reshape(dp, lm) of the devices."""
    for r, res in enumerate(world):
        assert res["rank"] == r and res["backend"] == "gloo" and res["device"] == "cpu"
        assert res["shape"] == {"dp": 2, "lm": 2} and res["axis_names"] == ("dp", "lm")
        assert (res["dp"], res["lm"]) == divmod(r, 2)
        assert res["line_shape"] == {"lm": WORLD} and res["line_index"] == r
        assert res["tall_shape"] == {"dp": 4, "lm": 1}


def test_psum(world):
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) * (r + 1) for r in range(WORLD)]
    for r, res in enumerate(world):
        row, col = divmod(r, 2)
        np.testing.assert_array_equal(res["psum_lm"].numpy(), x[2 * row] + x[2 * row + 1])
        np.testing.assert_array_equal(res["psum_dp"].numpy(), x[col] + x[col + 2])
        assert res["line_psum"].dtype == torch.int64
        np.testing.assert_array_equal(res["line_psum"].numpy(), [WORLD, WORLD])


def test_pmin(world):
    for r, res in enumerate(world):
        row, col = divmod(r, 2)
        assert res["pmin_lm"].dtype == torch.int32
        np.testing.assert_array_equal(res["pmin_lm"].numpy(), [2 * row, -(2 * row + 1)])
        x = [np.arange(6, dtype=np.float32).reshape(2, 3) * (q + 1) - 10.0 * q
             for q in (col, col + 2)]
        np.testing.assert_array_equal(res["pmin_dp"].numpy(), np.minimum(*x))


def test_all_gather_in_axis_order(world):
    for r, res in enumerate(world):
        row, col = divmod(r, 2)
        want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) * (q + 1)
                               for q in (col, col + 2)])
        np.testing.assert_array_equal(res["gather_dp"].numpy(), want)
        assert res["gather_bool"].dtype == torch.bool
        np.testing.assert_array_equal(res["gather_bool"].numpy(),
                                      [q % 2 == 0 if i == 0 else q == 3
                                       for q in (2 * row, 2 * row + 1) for i in (0, 1)])
        assert res["staged_bytes"] == 0   # CPU tensors are never staged


def test_a_mesh_spans_the_world(world):
    errors = world[0]["errors"]
    assert errors["n_devices"] == "a mesh spans the whole world of 4 ranks, got n_devices=2"
    assert errors["dp_size"] == "dp_size 3 does not divide 4"   # JAX's message
    assert errors["backend"] == "backend='nccl', but the world runs 'gloo'"
    assert all(res["init_again"] == WORLD for res in world)


def test_no_world_raises():
    """Outside a world a mesh cannot be made; a CUDA mesh without a card raises."""
    with pytest.raises(RuntimeError, match="torch.distributed"):
        tmesh.make_mesh(1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh._rank_device(None)


def test_a_failing_rank_ends_the_world():
    with pytest.raises(Exception, match="rank one fails"):
        tmesh.run_local(_fail_on_rank_one, 2, timeout=120.0)
