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


# --------------------------------------------------------------------------
# K7's fast mode on the card computes its bf16 gram on the tensor cores, in
# their own summation order, and re-selects exactly among the rows that an
# error bound cannot rule out (csrc/best_match.cu). The tests below emulate
# that filter in PyTorch on the CPU, with a gram summed in another order
# standing in for the tensor core, and hold it to best_match_plain(fast=True)
# bit for bit on data built to trip it (synthetic.generate_match_ties).
# --------------------------------------------------------------------------

U = 2.0 ** -24
ALPHA, BETA, TAU = 1.0 - 2.0 ** -17, 1.0 + 2.0 ** -17, 2.0 ** -96
INF = float("inf")


def _ties(nq=64, nk=4096, seed=0):
    from visual_odometry_tpu_torch.utils import synthetic

    return tuple(torch.from_numpy(x) for x in synthetic.generate_match_ties(
        np.random.default_rng(seed), nq, nk))


def _reversed_gram(qb, kb):
    acc = qb[:, None, -1] * kb[None, :, -1]
    for k in range(qb.shape[1] - 2, -1, -1):
        acc = acc + qb[:, None, k] * kb[None, :, k]
    return acc


def _double_gram(qb, kb):
    return (qb.double() @ kb.double().T).float()


def _parts(q, db, dbm):
    """The plain version's operands: f32 norms, bf16-rounded rows (masked
    rows zeroed, norm 3.4e38)."""
    qn = matcher_kernel._sq_norms(q)
    rows = torch.where(dbm[:, None], db, 0.0)
    n = torch.where(dbm, matcher_kernel._sq_norms(rows), float(BIG))
    return qn, n, q.bfloat16().float(), rows.bfloat16().float()


def _plain_keys(qn, n, qb, kb):
    """The plain version's (Q, K) selection keys."""
    v = (qn[:, None] + n[None, :]) - 2.0 * matcher_kernel._ordered_dot(qb, kb)
    v = torch.where(v.isnan(), INF, v)
    v = torch.where(v < 0.0, 0.0, v)
    cols = torch.arange(kb.shape[0], dtype=torch.int64)
    return (v.view(torch.int32).to(torch.int64) << 32) | cols[None, :]


def _finish(best_key, q, qm, db, dbm):
    """The fold: the winner's exact distance, as the plain version finishes."""
    start = int(np.float32(BIG).view(np.int32)) << 32
    arg = torch.minimum(best_key, torch.tensor(start)) & 0xFFFFFFFF
    row = arg.clamp(0, db.shape[0] - 1)
    best = torch.where(dbm[row], matcher_kernel._sq_norms(q - db[row]), float(BIG))
    dist = torch.where(best < 0.0, 0.0, best)
    return torch.where(qm, dist, float(BIG)), arg.to(torch.int32)


def _select(keys, survive):
    return torch.where(survive, keys, torch.iinfo(torch.int64).max).amin(dim=1)


def _eps_filter(q, qm, db, dbm, gram, clamp=True):
    """The filter in its bound form: eps = 113 u (qn + n_j) + 2^-23 |v'| with
    v' the float32 distance from the stand-in gram, U the smallest v' + eps
    over all rows (the tightest U there is), a row skipped iff
    max(v' - eps, 0) > max(U, 0) (a NaN bound survives). ``clamp=False``
    compares the unclamped values instead."""
    qn, n, qb, kb = _parts(q, db, dbm)
    vp = ((qn[:, None] + n[None, :]) - 2.0 * gram(qb, kb)).double()
    eps = 113 * U * (qn[:, None].double() + n[None, :].double()) + 2.0 ** -23 * vp.abs()
    lo, hi = vp - eps, vp + eps
    u = torch.where(hi.isnan(), INF, hi).amin(dim=1, keepdim=True)
    if clamp:
        skip = torch.where(lo.isnan(), 0.0, lo.clamp_min(0.0)) > u.clamp_min(0.0)
    else:
        skip = lo > u
    keys = _plain_keys(qn, n, qb, kb)
    return _finish(_select(keys, ~skip), q, qm, db, dbm), int((~skip).sum())


def _kernel_filter(q, qm, db, dbm, gram):
    """The kernel's own inequalities and bookkeeping: z_lo and z_hi in float32
    with alpha, beta and tau (the fma's single rounding taken from float64);
    the seed U of each query from every 32nd row; then each database split as
    the wrapper cuts it, restarted at the start key (3.4e38, 0), and in it each
    of the 4 lanes of a query row on its own columns (2t, 2t + 1, 8 + 2t and
    9 + 2t of every 16-row step) in ascending order, a column skipped iff z_lo
    >= min(T or -inf at T = 0, next float above U), T the distance of the
    lane's smallest exact key so far. The lanes' keys and then the splits'
    are folded by their minimum."""
    nq, nk = q.shape[0], db.shape[0]
    qn, n, qb, kb = _parts(q, db, dbm)
    acc2 = 2.0 * gram(qb, kb).double()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731

    def bound(scale, tau):
        aq = (qn * f32(scale)) + f32(tau)
        an = torch.where(dbm, n * f32(scale), INF)
        return ((aq[:, None] + an[None, :]).double() - acc2).float()

    z_lo, z_hi = bound(ALPHA, -TAU), bound(BETA, TAU)
    sampled = z_hi[:, ::32]
    seed = torch.where(sampled.isnan(), INF, sampled).clamp_min(0.0).amin(dim=1)
    seed = torch.where(seed == INF, float("nan"), seed)   # no bound from the sample
    above = torch.nextafter(seed, torch.tensor(INF))[:, None, None]
    keys = _plain_keys(qn, n, qb, kb)
    # The wrapper's splits, each a whole number of 256-row tiles.
    tk = matcher_kernel._TK
    splits = max(1, min(-(-nk // tk), -(-2048 // max(1, -(-nq // matcher_kernel._TQ)))))
    per = -(-(-(-nk // splits)) // tk) * tk
    pad = splits * per - nk
    z_lo = torch.nn.functional.pad(z_lo, (0, pad), value=INF)   # past the end: never rescored
    keys = torch.nn.functional.pad(keys, (0, pad))
    # (query, split, lane, the lane's columns in ascending order)
    t = torch.arange(4)[:, None]
    offsets = torch.cat([2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t], dim=1)   # (lane, 4)

    def by_lane(x):
        x = x.reshape(nq, splits, per // 16, 16)[..., offsets]   # (Q, S, steps, lane, 4)
        return x.permute(0, 1, 3, 2, 4).reshape(nq, splits, 4, per // 4)

    z_lo, keys = by_lane(z_lo), by_lane(keys)
    start = int(np.float32(BIG).view(np.int32)) << 32
    best = torch.full((nq, splits, 4), start, dtype=torch.int64)
    survivors = 0
    for i in range(per // 4):
        dist = (best >> 32).to(torch.int32).view(torch.float32)
        thr = torch.fmin(torch.where(dist > 0.0, dist, -INF), above)
        survive = ~(z_lo[..., i] >= thr)
        survivors += int(survive.sum())
        best = torch.where(survive, torch.minimum(best, keys[..., i]), best)
    return _finish(best.amin(dim=2).amin(dim=1), q, qm, db, dbm), survivors


@pytest.mark.parametrize("masked", [False, True], ids=["ties", "all_masked"])
@pytest.mark.parametrize("gram", [_reversed_gram, _double_gram], ids=["reversed", "float64"])
@pytest.mark.parametrize("emulate", [_eps_filter, _kernel_filter], ids=["eps", "kernel"])
def test_fast_filter_emulation_equals_plain(emulate, gram, masked):
    """Negative gram distances that clamp and tie, duplicates 256 rows apart,
    rows one bfloat16 ulp apart, NaN and inf in masked and live rows, and an
    all-masked database: the filtered selection equals the plain fast mode bit
    for bit, and rescores under 2% of the rows."""
    q, qm, db, dbm = _ties()
    if masked:
        dbm = torch.zeros_like(dbm)
    want = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=True)
    (dist, idx), survivors = emulate(q, qm, db, dbm, gram)
    assert torch.equal(idx, want[1]) and torch.equal(dist, want[0])
    if masked:   # the kernel's bound rules masked rows out; eps alone cannot
        assert bool((idx == 0).all()) and bool((dist[qm] == BIG).all())
        assert emulate is _eps_filter or survivors == 0
    else:        # about 10 a query here
        assert q.shape[0] <= survivors <= 64 * q.shape[0]


def test_unclamped_filter_picks_the_wrong_row():
    """The trap the clamp guards: a query whose gram distances to its own row
    and to a lower-column neighbour are both negative ties them at 0 (the
    neighbour wins); filtering on unclamped values drops the neighbour."""
    q, qm, db, dbm = _ties()
    want = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=True)
    (_, idx), _ = _eps_filter(q, qm, db, dbm, _reversed_gram, clamp=False)
    wrong = idx != want[1]
    assert bool(wrong.any())
    assert bool((idx[wrong] > want[1][wrong]).all())     # a later column took the tie
    assert bool((want[0][wrong] > 0).all())              # the exact distances differ
