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


def test_fp32_scan_route():
    """Which K7 calls take the FP32 scan rather than the tensor-core filter:
    the exact mode at D = 10 below EXACT_SCAN_PAIRS (path A's relocalization,
    128 queries x 1,024 rows) but not at path C's 1,024 x 2^20 nor at another
    width; the fast mode past D = 16 only."""
    pairs = matcher_kernel.EXACT_SCAN_PAIRS
    assert matcher_kernel.fp32_scan(128, 1024, 10, False)
    assert matcher_kernel.fp32_scan(1, pairs - 1, 10, False)
    assert not matcher_kernel.fp32_scan(1, pairs, 10, False)
    assert not matcher_kernel.fp32_scan(1024, 1 << 20, 10, False)
    assert not any(matcher_kernel.fp32_scan(128, 1024, d, False) for d in (1, 9, 11, 16, 32))
    assert [matcher_kernel.fp32_scan(128, 1024, d, True) for d in (10, 16, 17, 32)] == [
        False, False, True, True]


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


def _lane_walk(z_lo, keys, above, start, lane_threshold):
    """The kernel's bookkeeping over (Q, K) bounds and keys: each database
    split as the wrapper cuts it (whole 256-row tiles), restarted at the start
    key, and in it each of the 4 lanes of a query row on its own columns (2t,
    2t + 1, 8 + 2t and 9 + 2t of every 16-row step) in ascending order, a
    column skipped iff z_lo >= min(T, ``above``), T = lane_threshold(the
    lane's smallest key so far). Returns each query's smallest key over its
    lanes and splits, and the columns rescored."""
    nq, nk = keys.shape
    splits, per = matcher_kernel.split_geometry(nq, nk)
    pad = splits * per - nk
    z_lo = torch.nn.functional.pad(z_lo, (0, pad), value=INF)   # past the end: never rescored
    keys = torch.nn.functional.pad(keys, (0, pad))
    t = torch.arange(4)[:, None]
    offsets = torch.cat([2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t], dim=1)   # (lane, 4)

    def by_lane(x):
        x = x.reshape(nq, splits, per // 16, 16)[..., offsets]   # (Q, S, steps, lane, 4)
        return x.permute(0, 1, 3, 2, 4).reshape(nq, splits, 4, per // 4)

    z_lo, keys = by_lane(z_lo), by_lane(keys)
    best = torch.full((nq, splits, 4), start, dtype=torch.int64)
    survivors = 0
    for i in range(per // 4):
        thr = torch.fmin(lane_threshold(best), above[:, None, None])
        survive = ~(z_lo[..., i] >= thr)
        survivors += int(survive.sum())
        best = torch.where(survive, torch.minimum(best, keys[..., i]), best)
    return best.amin(dim=2).amin(dim=1), survivors


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
    above = torch.nextafter(seed, torch.tensor(INF))
    keys = _plain_keys(qn, n, qb, kb)
    start = int(np.float32(BIG).view(np.int32)) << 32

    def lane_threshold(best):   # T = 0 rules out every later column of the lane
        dist = (best >> 32).to(torch.int32).view(torch.float32)
        return torch.where(dist > 0.0, dist, -INF)

    best, survivors = _lane_walk(z_lo, keys, above, start, lane_threshold)
    return _finish(best, q, qm, db, dbm), survivors


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


# --------------------------------------------------------------------------
# K7's exact mode on the card rules rows out on a gram of bf16 split terms
# (hi.hi + mid.hi + hi.mid of each float32, hi = bf16(x), mid = bf16(x - hi))
# chained over m16n8k16 MMAs, inside a proven interval, and takes the plain
# exact key on the rows it cannot rule out (csrc/best_match.cu). The tests
# below emulate that filter with three stand-ins for the tensor cores (the
# split products summed in reversed order in float32, in float64, and
# through a truncating accumulation model of the chained MMAs) and hold it to
# best_match_plain(fast=False) bit for bit, on synthetic.generate_exact_match_ties
# (ulp pairs, negative keys that differ, duplicates a tile apart, bf16's
# subnormal edge, norms near overflow, NaN and inf rows), generate_match_ties
# and _scene.
# --------------------------------------------------------------------------

EXACT_M = 2.0 ** -13   # the exact mode's margin: alpha, beta = 1 -+ M
EXACT_C = 1394         # 2 |dot - acc| <= 1394 u R, the header's bound
EXACT_C_PARTS = {"plain_roundings": 32.01, "split": 775.0, "accumulation": 586.0}
START = int(np.float32(BIG).view(np.int32)) << 32   # the start key (3.4e38, 0), ordered


def _exact_data(name, nq=64, nk=4096, seed=0):
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    if name == "scene":
        q, qm, db, dbm, _ = _scene(nq, nk, seed)
        qm[:5], dbm[::7] = False, False
        db[~dbm] = np.nan
    elif name == "match_ties":
        q, qm, db, dbm = synthetic.generate_match_ties(rng, nq, nk)
    else:
        q, qm, db, dbm = synthetic.generate_exact_match_ties(rng, nq, nk)
        if name == "exact_all_masked":
            dbm = np.zeros_like(dbm)
    return tuple(torch.from_numpy(x) for x in (q, qm, db, dbm))


def _packed_split(q, rows):
    """The packed rows the exact kernel stages: the query side (hi, mid, hi)
    and the database side (hi, hi, mid), D each, zero-padded to whole
    16-wide k-chunks."""
    def split(x):
        hi = x.bfloat16().float()
        return hi, (x - hi).bfloat16().float()   # x - hi is exact in float32

    (qh, qm), (kh, km) = split(q), split(rows)
    a, b = torch.cat([qh, qm, qh], 1), torch.cat([kh, kh, km], 1)
    pad = -a.shape[1] % 16
    return torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad))


def _truncating_split_gram(a, b):
    """Chained m16n8k16 MMAs as a truncating accumulator: per 16-wide
    k-chunk, the running sum and the chunk's 16 products aligned to the
    largest one's exponent and cut toward zero to 24 bits below it, summed,
    and the sum cut toward zero to 24 significant bits (an error under 36 u
    of their absolute sum, inside the header's allowance of 96 u)."""
    def cut(x, ref):
        ulp = torch.exp2(torch.floor(torch.log2(ref)) - 23)
        return torch.where(ref > 0, torch.trunc(x / ulp) * ulp, x)

    a, b = a.double(), b.double()
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float64)
    for ch in range(0, a.shape[1], 16):
        terms = torch.cat([acc[..., None], a[:, None, ch:ch + 16] * b[None, :, ch:ch + 16]], -1)
        big = terms.abs().amax(-1, keepdim=True)
        s = cut(terms, big).sum(-1)
        s = cut(s, s.abs())
        acc = torch.where(torch.isfinite(terms).all(-1), s, terms.sum(-1))
    return acc.float()


def _exact_parts(q, db, dbm):
    """The plain exact mode's operands: f32 norms, rows zeroed and their norm
    3.4e38 where masked."""
    rows = torch.where(dbm[:, None], db, 0.0)
    n = torch.where(dbm, matcher_kernel._sq_norms(rows), float(BIG))
    return matcher_kernel._sq_norms(q), n, rows


def _ordered(v):
    """float32 -> int64 in the same order (negative bits flipped), as the
    kernel's ordered bits read as signed."""
    s = v.view(torch.int32)
    return torch.where(s < 0, s ^ 0x7FFFFFFF, s).to(torch.int64)


def _from_ordered(o):
    s = o.to(torch.int32)
    return torch.where(s < 0, s ^ 0x7FFFFFFF, s).view(torch.float32)


def _exact_keys(q, qn, n, rows, clamp=False):
    """The plain exact mode's (Q, K) keys, the ordered v high and the column
    low; ``clamp`` takes max(v, 0), the fast mode's key."""
    v = (qn[:, None] + n[None, :]) - 2.0 * matcher_kernel._ordered_dot(q, rows)
    v = torch.where(v.isnan(), INF, v)
    if clamp:
        v = torch.where(v < 0.0, 0.0, v)
    cols = torch.arange(rows.shape[0], dtype=torch.int64)
    return (_ordered(v) << 32) | cols[None, :]


def _exact_finish(best_key, qm):
    best_key = torch.minimum(best_key, torch.tensor(START))
    best = _from_ordered(best_key >> 32)
    dist = torch.where(best < 0.0, 0.0, best)
    return torch.where(qm, dist, float(BIG)), (best_key & 0xFFFFFFFF).to(torch.int32)


def _exact_eps_filter(q, qm, db, dbm, gram, c=EXACT_C, clamp=False):
    """The exact filter in its bound form: v' the float32 key from the
    stand-in gram, eps = c u (qn + n_j) + 2^-22 |v'| + 2^-96 (the roundings of
    v and v'), U the smallest v' + eps over all rows and the start key's
    3.4e38, a row skipped iff v' - eps > U or v' = +inf (a NaN survives).
    ``clamp`` compares max(., 0) and selects on clamped keys, as the fast
    mode does."""
    qn, n, rows = _exact_parts(q, db, dbm)
    acc = gram(*_packed_split(q, rows))
    vp = ((qn[:, None] + n[None, :]) - 2.0 * acc).double()
    eps = c * U * (qn[:, None].double() + n[None, :].double()) + 2.0 ** -22 * vp.abs() + 2.0 ** -96
    lo = torch.where(vp == INF, INF, vp - eps)   # v' = +inf: s = inf, so v = inf
    hi = vp + eps
    top = torch.where(hi.isnan(), INF, hi).amin(dim=1, keepdim=True).clamp_max(float(BIG))
    if clamp:
        skip = torch.where(lo.isnan(), 0.0, lo.clamp_min(0.0)) > top.clamp_min(0.0)
    else:
        skip = lo > top
    keys = _exact_keys(q, qn, n, rows, clamp)
    return _exact_finish(_select(keys, ~skip), qm), int((~skip).sum())


def _exact_kernel_filter(q, qm, db, dbm, gram, clamp=False, margin=EXACT_M):
    """The kernel's own inequalities and bookkeeping, as _kernel_filter
    emulates the fast mode's: z_lo and z_hi in float32 with alpha, beta =
    1 -+ ``margin`` and tau; the seed U of each query, the smallest z_hi over
    every 32nd row; each database split as the wrapper cuts it, from the
    start key, and in it each lane of a query row on its own columns in
    ascending order, a column skipped iff z_lo >= min(T, next float above U),
    T the v of the lane's smallest exact key. ``clamp`` puts the fast mode's
    clamp back: keys on max(v, 0), the seed on max(z_hi, 0), T = 0 ruling out
    every later column of the lane."""
    qn, n, rows = _exact_parts(q, db, dbm)
    acc2 = 2.0 * gram(*_packed_split(q, rows)).double()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)   # noqa: E731

    def bound(scale, tau):
        aq = (qn * f32(scale)) + f32(tau)
        an = torch.where(dbm, n * f32(scale), INF)
        return ((aq[:, None] + an[None, :]).double() - acc2).float()

    z_lo, z_hi = bound(1.0 - margin, -TAU), bound(1.0 + margin, TAU)
    sampled = z_hi[:, ::32]
    if clamp:
        sampled = sampled.clamp_min(0.0)
    seed = torch.where(sampled.isnan(), INF, sampled).amin(dim=1)
    seed = torch.where(seed == INF, float("nan"), seed)   # no bound from the sample
    above = torch.nextafter(seed, torch.tensor(INF))
    keys = _exact_keys(q, qn, n, rows, clamp)

    def lane_threshold(best):
        dist = _from_ordered(best >> 32)
        return torch.where(dist > 0.0, dist, -INF) if clamp else dist

    best, survivors = _lane_walk(z_lo, keys, above, START, lane_threshold)
    return _exact_finish(best, qm), survivors


EXACT_GRAMS = [_reversed_gram, _double_gram, _truncating_split_gram]


@pytest.mark.parametrize("data", ["exact_ties", "exact_all_masked", "match_ties", "scene"])
@pytest.mark.parametrize("gram", EXACT_GRAMS, ids=["reversed", "float64", "truncating"])
@pytest.mark.parametrize("emulate", [_exact_eps_filter, _exact_kernel_filter],
                         ids=["eps", "kernel"])
def test_exact_filter_emulation_equals_plain(emulate, gram, data):
    """The exact filter the header of csrc/best_match.cu describes selects
    what best_match_plain(fast=False) selects, bit for bit (indices and
    distances), and rescores a few rows a query."""
    q, qm, db, dbm = _exact_data(data)
    want = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=False)
    (dist, idx), survivors = emulate(q, qm, db, dbm, gram)
    assert torch.equal(idx, want[1]) and torch.equal(dist, want[0])
    if data == "exact_all_masked":   # the kernel's bound rules masked rows out
        assert bool((idx == 0).all()) and bool((dist[qm] == BIG).all())
        assert emulate is _exact_eps_filter or survivors == 0
    else:   # about 30 a query here
        assert q.shape[0] <= survivors <= 64 * q.shape[0]


def test_exact_bound_sums_its_parts():
    """The header's constants: 2 |dot - acc| <= 1394 u R from its three
    parts and the norms' (1 + 33 u), inside alpha's margin of 2044 u R."""
    total = sum(EXACT_C_PARTS.values()) * (1.0 + 33 * U)
    assert total <= EXACT_C < EXACT_M / U - 4
    # the split's dropped terms: hi r + mid mid + r hi + mid r + r mid + r r
    split = 2 ** 8 * ((1 + 2 ** -8) * 2 + (1 + 2 ** -8) ** 2) + 2 * (1 + 2 ** -8) + 2 ** -8
    assert split <= EXACT_C_PARTS["split"]
    # six chained MMAs at 96 u over P_G <= (1 + 2^-8)^2 (1 + 2^-7) P
    p_g = (1 + 2 ** -8) ** 2 * (1 + 2 ** -7)
    assert 96 * 6 * p_g * (1 + 576 * U) <= EXACT_C_PARTS["accumulation"]


def test_exact_filter_with_the_fast_clamp_picks_a_wrong_row():
    """The trap the exact mode's unclamped filter guards: a query whose keys
    to two rows are both negative takes the more negative, the later row;
    with the fast mode's clamp the two tie at 0 and the earlier row wins."""
    q, qm, db, dbm = _exact_data("exact_ties")
    want = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=False)
    (_, idx), _ = _exact_kernel_filter(q, qm, db, dbm, _truncating_split_gram, clamp=True)
    wrong = idx != want[1]
    assert bool(wrong.any())
    qn, n, rows = _exact_parts(q, db, dbm)
    v = (qn[:, None] + n[None, :]) - 2.0 * matcher_kernel._ordered_dot(q, rows)
    rows_w = torch.nonzero(wrong)[:, 0]
    got, right = v[rows_w, idx[wrong].long()], v[rows_w, want[1][wrong].long()]
    assert bool((right < got).all() and (got <= 0).all())     # the exact winner is more negative
    assert bool((idx[wrong] < want[1][wrong]).all())          # an earlier column took the tie


def test_exact_filter_without_its_margin_picks_a_wrong_row():
    """The data bites the interval: with no margin (z_lo = z_hi = the stand-in
    gram's float32 key) the filter rules out a winner on
    generate_exact_match_ties, where rows one ulp apart and negative keys sit
    closer than the split gram can see."""
    q, qm, db, dbm = _exact_data("exact_ties")
    want = matcher_kernel.best_match_plain(q, qm, db, dbm, fast=False)
    (_, idx), _ = _exact_kernel_filter(q, qm, db, dbm, _truncating_split_gram, margin=0.0)
    assert bool((idx != want[1]).any())


def test_generate_exact_match_ties_plants_every_trap():
    from visual_odometry_tpu_torch.utils import synthetic

    q, qm, db, dbm = synthetic.generate_exact_match_ties(np.random.default_rng(0), 64, 4096)
    live = dbm & np.isfinite(db).all(1)
    # rows one float32 ulp apart in one component
    diff = db[1:].view(np.int32) - db[:-1].view(np.int32)
    pair = live[1:] & live[:-1] & ((diff != 0).sum(1) == 1) & (np.abs(diff).sum(1) == 1)
    assert pair.sum() >= 2
    # exact duplicates one tile (and, at this size, one split) apart
    assert matcher_kernel.split_geometry(64, 4096)[1] == 256
    assert ((db[256:] == db[:-256]).all(1) & live[256:] & live[:-256]).sum() >= 2
    # queries whose keys to two rows are negative and differ, the later row's smaller
    v = synthetic.exact_keys(q[:, None, :], np.where(dbm[:, None], db, 0)[None])
    v = np.where(dbm[None], v, BIG)
    neg = [(i, np.flatnonzero(v[i] < 0)) for i in range(q.shape[0])]
    assert any(len(c) >= 2 and v[i, c[-1]] < v[i, c[0]] for i, c in neg)
    # components at bf16's subnormal edge, and norms that overflow float32
    tiny = (np.abs(db) >= 2.0 ** -134) & (np.abs(db) < 2.0 ** -117)
    assert tiny[live].any() and ((np.abs(q) >= 2.0 ** -134) & (np.abs(q) < 2.0 ** -117)).any()
    norms = (db.astype(np.float64) ** 2).sum(1)
    huge = (np.abs(db) > 5e18).any(1) & dbm
    assert (huge & (norms < 3.4e38)).any() and (huge & (norms > 3.4e38)).any()
    with np.errstate(over="ignore"):
        assert (np.isinf((q ** 2).sum(1)) & qm).any()   # |q|^2 overflows float32
    # NaN and inf in masked rows and in live rows; a twentieth of the queries masked
    for bad in (np.isnan(db).any(1), np.isinf(db).any(1)):
        assert (bad & ~dbm).any() and (bad & dbm).any()
    assert 0 < (~qm).sum() <= 0.15 * q.shape[0]


def test_exact_plain_agrees_with_float64():
    """best_match_plain(fast=False) on generate_exact_match_ties picks the
    float64 nearest row wherever float64 puts it ahead of every other row by
    more than twice the float32 keys' rounding bound, (2 D + 2) u (|q|^2 +
    |k|^2) + u |v| + 3 D 2^-149 (D products and sums in each of the norms and
    the dot, the sum of the norms, the difference; the last term products
    below float32's smallest normal, which the tiny traps make), over
    queries and rows whose norms stay finite in float32."""
    from visual_odometry_tpu_torch.utils import synthetic

    q, qm, db, dbm = synthetic.generate_exact_match_ties(np.random.default_rng(1), 64, 4096)
    d = q.shape[1]
    _, idx = matcher_kernel.best_match_plain(*(torch.from_numpy(x) for x in (q, qm, db, dbm)))
    q64, k64 = q.astype(np.float64), np.where(dbm[:, None], db, 0).astype(np.float64)
    qn, n = (q64 ** 2).sum(1), (k64 ** 2).sum(1)
    ok_rows = dbm & np.isfinite(n) & (n < 1e38)
    ok_q = np.isfinite(qn) & (qn < 1e38)
    with np.errstate(invalid="ignore"):
        v = qn[:, None] + n[None, :] - 2.0 * q64 @ k64.T
    v = np.where(ok_rows[None], v, np.inf)
    bound = (2 * d + 2) * U * (qn[:, None] + n[None, :]) + U * np.abs(v) + 3 * d * 2.0 ** -149
    order = np.argsort(v, axis=1)
    first, second = order[:, 0], order[:, 1]
    rows = np.arange(q.shape[0])
    clear = ok_q & (v[rows, second] - v[rows, first] > bound[rows, first] + bound[rows, second])
    assert clear.sum() >= q.shape[0] // 2
    np.testing.assert_array_equal(idx.numpy()[clear], first[clear])
