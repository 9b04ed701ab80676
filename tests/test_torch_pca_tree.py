"""The port's PCA-split tree (ops/pca_tree) against the JAX package's, on the
CPU: ports of tests/test_pca_tree.py's cases, and both packages on the same
inputs.

An eigenvector's sign differs between eigensolvers, and a flipped axis swaps
a node's children: a tree the port builds is held to the JAX tree's leaf
partition (the sets of live points sharing a code are equal), not to its
codes. The queries do not depend on the labelling: on a tree the port builds,
``best_match_fast``'s indices and found flags and ``fast_radius_search``'s
masks equal the JAX package's exactly, and so does ``descend`` on the JAX
tree carried across (``utils/convert.pca_tree_from_arrays``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops import matching as jmat
from visual_odometry_tpu.ops import pca_tree as jpt
from visual_odometry_tpu_torch.ops import matching as tmat
from visual_odometry_tpu_torch.ops import pca_tree as tpt
from visual_odometry_tpu_torch.utils import convert


def T(x):
    return torch.from_numpy(np.array(x))


def _random_set(rng, n, d=10):
    return rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32), np.ones(n, bool)


def _partition(codes):
    """The live points grouped by leaf, as a set of frozensets of indices."""
    codes = np.asarray(codes)
    return {frozenset(np.flatnonzero(codes == c).tolist()) for c in np.unique(codes[codes >= 0])}


CASES = [(256, 10, 4, 0.8), (200, 10, 3, 0.8), (500, 3, 4, 0.2), (300, 3, 5, 0.5)]


def _both_trees(seed, n, d, levels, dead=0):
    rng = np.random.default_rng(seed)
    db, mask = _random_set(rng, n, d)
    if dead:
        mask[rng.permutation(n)[:dead]] = False
    jtree = jpt.build_tree(jnp.asarray(db), jnp.asarray(mask), levels)
    ttree = tpt.build_tree(T(db), T(mask), levels)
    return rng, db, mask, jtree, ttree


@pytest.mark.parametrize("n,d,levels,radius", CASES)
def test_leaf_partition_matches_jax(n, d, levels, radius):
    """The same leaves as the JAX tree, with a fifth of the slots dead."""
    _, _, mask, jtree, ttree = _both_trees(n, n, d, levels, dead=n // 5)
    assert ttree.levels == levels and ttree.codes.dtype == torch.int32
    assert ttree.axes.shape == (2 ** levels - 1, d) and ttree.thresholds.shape == (2 ** levels - 1,)
    assert _partition(ttree.codes.numpy()) == _partition(jtree.codes)
    np.testing.assert_array_equal(ttree.codes.numpy() >= 0, mask)


@pytest.mark.parametrize("n,d,levels,radius", CASES)
def test_queries_on_a_carried_tree_equal_jax(n, d, levels, radius):
    """descend, best_match_fast and fast_radius_search on the JAX tree carried
    across: equal to the JAX package's, element for element."""
    rng, db, mask, jtree, _ = _both_trees(n, n, d, levels, dead=n // 7)
    q = (db[rng.integers(0, n, 64)] + rng.normal(0, radius / 4, (64, d))).astype(np.float32)
    q_mask = rng.uniform(size=64) > 0.1
    tree = convert.pca_tree_from_arrays(**jtree._asdict())
    np.testing.assert_array_equal(tree.codes.numpy(), np.asarray(jtree.codes))
    np.testing.assert_array_equal(tpt.descend(tree, T(q)).numpy(),
                                  np.asarray(jpt.descend(jtree, jnp.asarray(q))))
    jidx, jfound = jpt.best_match_fast(jtree, jnp.asarray(db), jnp.asarray(q),
                                       jnp.asarray(q_mask), radius)
    idx, found = tpt.best_match_fast(tree, T(db), T(q), T(q_mask), radius)
    assert idx.dtype == torch.int32 and found.dtype == torch.bool
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found.any() and not found.all()
    np.testing.assert_array_equal(
        tpt.fast_radius_search(tree, T(db), T(q), T(q_mask), radius).numpy(),
        np.asarray(jpt.fast_radius_search(jtree, jnp.asarray(db), jnp.asarray(q),
                                          jnp.asarray(q_mask), radius)))


def test_ties_go_to_the_first_index():
    """Rows repeated in the database: a query on one of them gets the lowest
    index of its copies in its leaf, as in the JAX package."""
    rng = np.random.default_rng(11)
    base, _ = _random_set(rng, 64, 3)
    db = np.concatenate([base, base, base[:16]])             # each row at i, i + 64, ...
    mask = np.ones(len(db), bool)
    mask[3] = False                                          # row 3's first copy is dead
    jtree = jpt.build_tree(jnp.asarray(db), jnp.asarray(mask), 3)
    tree = convert.pca_tree_from_arrays(**jtree._asdict())
    q, q_mask = base[:32].copy(), np.ones(32, bool)
    jidx, jfound = jpt.best_match_fast(jtree, jnp.asarray(db), jnp.asarray(q),
                                       jnp.asarray(q_mask), 0.1)
    idx, found = tpt.best_match_fast(tree, T(db), T(q), T(q_mask), 0.1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert found.all() and int(idx[3]) == 67
    assert (idx.numpy()[np.arange(32) != 3] == np.delete(np.arange(32), 3)).all()


@pytest.mark.parametrize("n,d,levels,radius", CASES)
def test_queries_on_a_port_tree_equal_jax(n, d, levels, radius):
    """On the tree each package builds for itself: the same indices, found
    flags and radius masks."""
    rng, db, mask, jtree, ttree = _both_trees(n, n, d, levels, dead=n // 7)
    q = (db[rng.integers(0, n, 64)] + rng.normal(0, radius / 4, (64, d))).astype(np.float32)
    q_mask = rng.uniform(size=64) > 0.1
    jidx, jfound = jpt.best_match_fast(jtree, jnp.asarray(db), jnp.asarray(q),
                                       jnp.asarray(q_mask), radius)
    idx, found = tpt.best_match_fast(ttree, T(db), T(q), T(q_mask), radius)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(
        tpt.fast_radius_search(ttree, T(db), T(q), T(q_mask), radius).numpy(),
        np.asarray(jpt.fast_radius_search(jtree, jnp.asarray(db), jnp.asarray(q),
                                          jnp.asarray(q_mask), radius)))


def test_codes_partition_points(rng):
    pts, mask = _random_set(rng, 256)
    codes = tpt.build_tree(T(pts), T(mask), levels=4).codes.numpy()
    assert codes.min() >= 0 and codes.max() < 16
    assert np.bincount(codes, minlength=16).max() < 256 // 2   # splits at the mean balance


def test_dead_slots_get_code_minus_one(rng):
    pts, _ = _random_set(rng, 64)
    mask = np.arange(64) < 40
    codes = tpt.build_tree(T(pts), T(mask), levels=3).codes.numpy()
    assert (codes[40:] == -1).all() and (codes[:40] >= 0).all()


def test_fast_match_is_the_leafs_exact_match(rng):
    """Whenever fast finds a match, it is the exact nearest row of the leaf."""
    db, db_mask = _random_set(rng, 200)
    q, q_mask = _random_set(rng, 64)
    tree = tpt.build_tree(T(db), T(db_mask), levels=3)
    idx, found = tpt.best_match_fast(tree, T(db), T(q), T(q_mask), radius=0.8)
    codes, q_codes = tree.codes.numpy(), tpt.descend(tree, T(q)).numpy()
    for i in range(64):
        leaf = np.flatnonzero(codes == q_codes[i])
        if len(leaf) == 0:
            assert not bool(found[i]) and int(idx[i]) == 0
            continue
        d = np.sum((db[leaf] - q[i]) ** 2, axis=1)
        if bool(found[i]):
            assert int(idx[i]) == leaf[int(np.argmin(d))] and d.min() < 0.8 ** 2
        else:
            assert d.min() >= 0.8 ** 2


def test_fast_vs_full_cross_check(rng):
    """eigen_kdtree_test: each point finds itself; perturbed queries agree
    with the dense search on more than 90% of the queries."""
    db, db_mask = _random_set(rng, 500, d=3)
    tree = tpt.build_tree(T(db), T(db_mask), levels=4)
    idx, found = tpt.best_match_fast(tree, T(db), T(db), T(db_mask), 0.2)
    assert bool(found.all())
    np.testing.assert_array_equal(idx.numpy(), np.arange(500))
    q = db + np.random.default_rng(7).normal(0, 0.01, (500, 3)).astype(np.float32)
    idx, found = tpt.best_match_fast(tree, T(db), T(q), T(db_mask), 0.2)
    d = tmat.pairwise_sq_dists(T(q), T(db)).numpy()
    exact_idx, exact_found = d.argmin(1), d.min(1) < 0.2 ** 2
    agree = (found.numpy() == exact_found) & (~exact_found | (idx.numpy() == exact_idx))
    assert agree.mean() > 0.9


def test_fast_radius_is_subset_of_full_radius(rng):
    """Every fast hit is a true within-radius hit of matching.radius_search,
    which equals the JAX package's."""
    db, db_mask = _random_set(rng, 128)
    q, q_mask = _random_set(rng, 32)
    tree = tpt.build_tree(T(db), T(db_mask), levels=3)
    fast = tpt.fast_radius_search(tree, T(db), T(q), T(q_mask), 0.9).numpy()
    full = tmat.radius_search(T(q), T(q_mask), T(db), T(db_mask), 0.9).numpy()
    np.testing.assert_array_equal(full, np.asarray(jmat.radius_search(q, q_mask, db, db_mask,
                                                                      0.9)))
    assert (fast <= full).all() and fast.sum() > 0
