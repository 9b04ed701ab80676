"""The port's map-scale top-1 matcher (kernel K7's plain version) against the
JAX package's ``best_match``, on the CPU: the dense ``xla`` backend and the
Pallas streaming kernel in interpret mode, exact and fast.

Tolerances: indices are exact on margin-separated data (each query's nearest
row is closer than any other by far more than float32 or bfloat16 rounding).
Gram-form distances ``|q|^2 + |k|^2 - 2 q.k`` cancel, so they agree to 1e-6
of ``|q|^2 + |k|^2``, the operands' size (the JAX gram is a matmul, the port
sums the ten products in descriptor order); the fast mode's re-scored
distances are sums of squared differences and agree to rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops import matching as jmatching
from visual_odometry_tpu_torch.ops import matching
from visual_odometry_tpu_torch.ops.kernels import matcher_kernel

BIG = np.float32(3.4e38)


def _scene(nq=96, nk=4096, seed=0, sigma=1e-3):
    rng = np.random.default_rng(seed)
    db = rng.uniform(-1, 1, (nk, 10)).astype(np.float32)
    pick = rng.permutation(nk)[:nq]
    q = (db[pick] + rng.normal(0, sigma, (nq, 10))).astype(np.float32)
    return q, np.ones(nq, bool), db, np.ones(nk, bool), pick


def _port(q, qm, db, dbm, **kw):
    d, i = matching.best_match(*(torch.from_numpy(x) for x in (q, qm, db, dbm)), **kw)
    return d.numpy(), i.numpy()


def _jax(q, qm, db, dbm, **kw):
    d, i = jmatching.best_match(*(jnp.asarray(x) for x in (q, qm, db, dbm)), **kw)
    return np.asarray(d), np.asarray(i)


@pytest.mark.parametrize("jax_kw", [dict(backend="xla"), dict(backend="pallas", interpret=True)])
@pytest.mark.parametrize("chunk", [16384, 1000])   # one step, and several ragged steps
def test_best_match_matches_jax(jax_kw, chunk, monkeypatch):
    monkeypatch.setattr(matcher_kernel, "PLAIN_CHUNK", chunk)
    q, qm, db, dbm, pick = _scene()
    qm[:7] = False
    dbm[::5] = False
    d, i = _port(q, qm, db, dbm)
    jd, ji = _jax(q, qm, db, dbm, **jax_kw)
    live = qm & dbm[pick]
    np.testing.assert_array_equal(i[live], pick[live])
    np.testing.assert_array_equal(i[qm], ji[qm])
    operands = (q ** 2).sum(-1) + (db[pick] ** 2).sum(-1)
    assert (np.abs(d - jd)[live] <= 1e-6 * operands[live]).all()
    assert (d[~qm] == BIG).all() and (jd[~qm] == BIG).all()   # masked queries give 3.4e38
    assert dbm[i[qm]].all()                                   # a masked row never wins


def test_first_index_wins_on_exact_duplicates():
    q, qm, db, dbm, pick = _scene(nq=32, nk=2048)
    later = (pick + 700) % 2048
    db[later] = db[pick]                   # an exact copy of each target row
    first = np.minimum(pick, later)
    for precision in ("highest", "fast"):
        d, i = _port(q, qm, db, dbm, precision=precision)
        np.testing.assert_array_equal(i, first)
    _, ji = _jax(q, qm, db, dbm, backend="pallas", interpret=True)
    np.testing.assert_array_equal(ji, first)


@pytest.mark.parametrize("precision", ["highest", "fast"])
def test_masked_rows_with_nan_never_win(precision):
    q, qm, db, dbm, pick = _scene(nq=64, nk=1024)
    dbm[pick[:20]] = False                 # the true nearest rows of 20 queries are masked...
    db[~dbm] = np.nan                      # ...and hold NaN; inf elsewhere in masked rows
    dbm[5], db[5] = False, np.inf
    d, i = _port(q, qm, db, dbm, precision=precision)
    assert np.isfinite(d).all() and dbm[i].all()
    np.testing.assert_array_equal(i[20:], pick[20:])
    assert (d[:20] > 0.01).all()           # their nearest live row is far away
    # An all-masked database: index 0 at 3.4e38, as the JAX kernel's accumulator start.
    d, i = _port(q, qm, db, np.zeros_like(dbm), precision=precision)
    assert (d == BIG).all() and (i == 0).all()


def test_strict_radius_boundary():
    """A distance of exactly r^2 is no match: the comparison is strict '<'.
    Powers of two keep every operation exact, so the boundary is hit exactly."""
    db = np.zeros((16, 10), np.float32)
    db[1:, 0] = 4.0
    q = np.zeros((2, 10), np.float32)
    q[0, 0] = 0.25                         # distance^2 = 0.0625 to row 0
    q[1, 0] = 0.25 - 2.0 ** -10
    ones = np.ones(2, bool), np.ones(16, bool)
    for precision in ("highest", "fast"):
        d, i = _port(q, ones[0], db, ones[1], precision=precision)
        assert d[0] == np.float32(0.0625) and (i == 0).all()
        r2 = np.float32(0.25) ** 2
        assert not d[0] < r2 and d[1] < r2
    jd, _ = _jax(q, ones[0], db, ones[1], backend="pallas", interpret=True)
    np.testing.assert_array_equal(d[:1], jd[:1])


def test_fast_mode_rescores_exactly_and_matches_jax_fast():
    q, qm, db, dbm, pick = _scene(nq=128, nk=4096, sigma=3e-3)
    dbm[::11] = False
    d, i = _port(q, qm, db, dbm, precision="fast")
    dh, ih = _port(q, qm, db, dbm, precision="highest")
    jd, ji = _jax(q, qm, db, dbm, backend="pallas", interpret=True, precision="fast")
    np.testing.assert_array_equal(i, ih)   # margin-separated: the same selection
    np.testing.assert_array_equal(i, ji)
    # The returned distance is the exact float32 one of the returned index.
    exact = ((q - db[i]) ** 2).astype(np.float32)
    acc = exact[:, 0]
    for k in range(1, 10):
        acc = acc + exact[:, k]
    live = dbm[i]
    np.testing.assert_array_equal(d[live], acc[live])
    np.testing.assert_allclose(d[live], jd[live], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(d[live], dh[live], rtol=0, atol=4e-6)   # differences vs gram form
    # Queries whose true row is masked land elsewhere, beyond the match radius.
    assert (d[~dbm[pick]] > 0.01).all()


def test_best_match_rejects_bad_arguments():
    q, qm, db, dbm, _ = _scene(nq=4, nk=8)
    args = tuple(torch.from_numpy(x) for x in (q, qm, db, dbm))
    with pytest.raises(ValueError, match="precision"):
        matching.best_match(*args, precision="bf16")
    with pytest.raises(ValueError, match="backend"):
        matching.best_match(*args, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        matching.best_match(*args, backend="cuda")
