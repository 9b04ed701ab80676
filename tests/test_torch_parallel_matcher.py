"""The sharded matcher of the port (parallel/matcher) against the JAX
package's and a numpy oracle, on the CPU: the three cases of
tests/test_parallel_matcher.py in one world of 4 ranks over gloo, the
database in 4 blocks over the ``lm`` axis. Indices equal the oracle and JAX's
``sharded_best_match`` on 4 of the 8 virtual devices; distances equal the
port's unsharded ``best_match`` bit for bit (each block's top-1 distance is
the winner's own key, and a minimum does not round). JAX is imported inside
the tests only: the ranks import this module.
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.ops import matching
from visual_odometry_tpu_torch.parallel import matcher as tmatch
from visual_odometry_tpu_torch.parallel import mesh as tmesh

WORLD = 4


def _cases():
    """{name: (db, db_mask, queries, q_mask, radius)}: tests/test_parallel_matcher.py's."""
    rng = np.random.default_rng(0)
    l, q_n = 512, 64
    db = rng.uniform(-1, 1, (l, 10)).astype(np.float32)
    q = db[rng.integers(0, l, q_n)].copy()
    q[:10] = rng.uniform(5, 6, (10, 10))     # unmatched far queries
    db_mask = np.ones(l, bool)
    db_mask[100:120] = False
    q_mask = np.ones(q_n, bool)
    q_mask[-5:] = False
    cases = {"oracle": (db, db_mask, q, q_mask, 0.1)}
    # The best match in the last block; every block holds a decoy.
    db = np.full((64, 10), 5.0, np.float32)
    db[7::8] = 1.0
    db[-1] = 0.02
    cases["last_block"] = (db, np.ones(64, bool), np.zeros((1, 10), np.float32),
                           np.ones(1, bool), 100.0)
    # Exact duplicates in blocks 0 and 2: the smaller global index wins.
    db = np.full((64, 10), 3.0, np.float32)
    db[5] = 0.0
    db[37] = 0.0
    cases["tie"] = (db, np.ones(64, bool), np.zeros((1, 10), np.float32), np.ones(1, bool), 0.1)
    return cases


def _rank_matches(cases):
    mesh = tmesh.single_axis_mesh(name="lm", device="cpu")
    out = {}
    for name, (db, db_mask, q, q_mask, radius) in cases.items():
        db, db_mask = (tmatch.shard_rows(mesh, torch.from_numpy(x)) for x in (db, db_mask))
        q, q_mask = (tmatch.replicate(mesh, torch.from_numpy(x)) for x in (q, q_mask))
        out[name] = tmatch.sharded_best_match(mesh, db, db_mask, q, q_mask, radius=radius)
    try:
        tmatch.shard_rows(mesh, torch.zeros(510, 10))
    except ValueError as e:
        out["error"] = str(e)
    return out


@pytest.fixture(scope="module")
def world():
    cases = _cases()
    return cases, tmesh.run_local(_rank_matches, WORLD, cases)


def _oracle(db, db_mask, q, q_mask, radius):
    out = []
    for i in range(len(q)):
        if not q_mask[i]:
            out.append(-1)
            continue
        d = ((db - q[i]) ** 2).sum(1)
        d[~db_mask] = np.inf
        j = int(np.argmin(d))
        out.append(j if d[j] < radius * radius else -1)
    return np.array(out, np.int32)


@pytest.mark.parametrize("name", ["oracle", "last_block", "tie"])
def test_sharded_best_match_matches_jax(world, name):
    import jax
    import jax.numpy as jnp

    from visual_odometry_tpu.parallel import matcher as jmatch
    from visual_odometry_tpu.parallel import mesh as jmesh

    cases, ranks = world
    db, db_mask, q, q_mask, radius = cases[name]
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 virtual devices")
    j_idx, _ = jmatch.sharded_best_match(
        jmesh.single_axis_mesh(WORLD, "lm"), jnp.asarray(db), jnp.asarray(db_mask),
        jnp.asarray(q), jnp.asarray(q_mask), radius=radius)
    dist, _ = matching.best_match(*(torch.from_numpy(x) for x in (q, q_mask, db, db_mask)))
    for idx_r, dist_r in (r[name] for r in ranks):
        np.testing.assert_array_equal(idx_r.numpy(), _oracle(db, db_mask, q, q_mask, radius))
        np.testing.assert_array_equal(idx_r.numpy(), np.asarray(j_idx))
        assert torch.equal(dist_r.view(torch.int32), dist.view(torch.int32))
    if name == "last_block":
        assert int(ranks[0][name][0][0]) == 63
    if name == "tie":
        assert int(ranks[0][name][0][0]) == 5


def test_shard_rows_refuses_a_ragged_database(world):
    assert {r["error"] for r in world[1]} == {"database size 510 not divisible by mesh axis 4"}
