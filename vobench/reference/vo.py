"""Plain reference of the tracking pipeline the benchmark times: the reference
program's ``vo_complete`` (lucanunz/Visual-odometry) as
``visual_odometry_tpu_torch`` defines it at commit 9bfc263 (``models/pipeline``
``run_sequence``, ``parallel/multiseq`` ``run_sequences_batched``), written
again from its semantics, batched over sequences, in float64 by default.

Per sequence (frames F, slots S):

1. Association of every consecutive pair (k-1, k): top-1 appearance match
   within the strict radius (d^2 < r^2, r^2 rounded in float32), queried from
   the frame with fewer live slots into the other (from frame k when the
   counts tie); correspondence s is query slot s.
2. Bootstrap on frames 0/1: the eight-point fundamental matrix on
   [-1, 1]-normalized points (the normal matrix's null vector by ``eigh``),
   the rank-2 projection, E = K^T F K, the four candidates of E's SVD (R = V W
   U^T and V W^T U^T made proper, t = unskew(R E) and -t), the cheirality vote
   by mid-point triangulation (the first candidate with the most points in
   front of both cameras; the identity when none has one), then the
   triangulation of the valid correspondences with the chosen pose.
3. Each tracked frame k: every correspondence of (k-1, k) joins the first
   correspondence of (k-2, k-1) that triangulated its frame-(k-1)
   measurement; the joined points, moved into frame k-1 by the previous pose,
   and the frame-k measurements feed a damped Gauss-Newton solve from the
   identity on the Euler chart (projective error, robust kernel, (H + damping
   I) dx = -b, X <- Rxyz(dx_rot) X + dx_t) until ||dx||^2 <= tolerance or the
   budget; the pair is triangulated with the solved pose.
4. The map: the bootstrap's triangulation, then every tracked frame's moved
   into frame-0 coordinates, folded by exact appearance: a key's position is
   its last observation, keys enter in first-observation order, up to the
   capacity.

``dtype`` sets the arithmetic. Where it has no ``torch.linalg`` (bfloat16,
the benchmark's lower-precision control) the eigen-solve, the SVDs, the
determinant and the 6x6 solve take float32 copies and round back. Those
small solves run on the host.
"""

from __future__ import annotations


import torch

_DET_EPS = 1e-12
_MATCH_BYTES = 1 << 28   # distance matrices held at once by the matcher


def _lin(x: torch.Tensor) -> torch.Tensor:
    """A copy for torch.linalg: on the host (the small matrices here solve
    faster there than through the card's solvers, which sync), in float32
    where the dtype has no linalg."""
    x = x.detach().to("cpu")
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def match(app1, mask1, app2, mask2, radius: float, dtype):
    """Correspondences of B frame pairs: app (B, S, D), mask (B, S) ->
    (idx1, idx2, valid), each (B, S)."""
    b, s, _ = app1.shape
    x, y = app1.to(dtype), app2.to(dtype)
    d = ((x * x).sum(-1)[:, :, None] + (y * y).sum(-1)[:, None, :]) - 2.0 * (x @ y.transpose(1, 2))
    d = torch.where(mask1[:, :, None] & mask2[:, None, :], d.clamp_min(0.0),
                    torch.full_like(d, float("inf")))
    best1_d, best1 = d.min(dim=1)   # per frame-2 slot, the best frame-1 slot
    best2_d, best2 = d.min(dim=2)   # per frame-1 slot, the best frame-2 slot
    slots = torch.arange(s, device=app1.device)[None, :]
    tree_is_1 = (mask1.sum(1) >= mask2.sum(1))[:, None]
    idx1 = torch.where(tree_is_1, best1, slots)
    idx2 = torch.where(tree_is_1, slots, best2)
    best = torch.where(tree_is_1, best1_d, best2_d)
    query_mask = torch.where(tree_is_1, mask2, mask1)
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    return idx1, idx2, query_mask & (best < r2)


def match_sequences(appearances, masks, radius: float, dtype):
    """All consecutive pairs of (N, F, S, D) sequences: (idx1, idx2, valid),
    each (N, F - 1, S); pair k - 1 is frames (k - 1, k)."""
    n, f, s, d = appearances.shape
    a1 = appearances[:, :-1].reshape(-1, s, d)
    a2 = appearances[:, 1:].reshape(-1, s, d)
    m1 = masks[:, :-1].reshape(-1, s)
    m2 = masks[:, 1:].reshape(-1, s)
    step = max(1, _MATCH_BYTES // (s * s * 8))
    parts = [match(a1[i:i + step], m1[i:i + step], a2[i:i + step], m2[i:i + step], radius,
                   dtype) for i in range(0, a1.shape[0], step)]
    return tuple(torch.cat([p[k] for p in parts]).reshape(n, f - 1, s) for k in range(3))


def _take(rows, idx):
    """rows (N, S, C) at idx (N, S) -> (N, S, C)."""
    return torch.gather(rows, 1, idx.long()[..., None].expand(idx.shape + rows.shape[-1:]))


def _pose(r, t):
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=r.dtype, device=r.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inverse(x):
    r_t = x[..., :3, :3].transpose(-1, -2)
    return _pose(r_t, -(r_t @ x[..., :3, 3:])[..., 0])


def triangulate(k_mat, x, p1, p2, valid):
    """Mid-point triangulation of pixel pairs p1, p2 (..., S, 2) under x
    (..., 4, 4), the pose of camera 1 in camera 2: (points (..., S, 3) in
    camera-1 coordinates, ok (..., S))."""
    dt = p1.dtype
    ik = torch.linalg.inv(_lin(k_mat)).to(device=p1.device, dtype=dt)
    r_t = x[..., :3, :3].transpose(-1, -2)
    ir_ik = r_t @ ik
    tv = -(r_t @ x[..., :3, 3:])[..., 0]
    one = torch.ones_like(p1[..., :1])
    d1 = torch.cat([p1, one], -1) @ ik.T
    d2 = torch.cat([p2, one], -1) @ ir_ik.transpose(-1, -2)
    tv = tv[..., None, :]
    a00 = (d1 * d1).sum(-1)
    a01 = -(d1 * d2).sum(-1)
    a11 = (d2 * d2).sum(-1)
    b0 = (d1 * tv).sum(-1)
    b1 = -(d2 * tv).sum(-1)
    det = a00 * a11 - a01 * a01
    safe = torch.where(det.abs() < _DET_EPS, torch.ones_like(det), det)
    s0 = (a11 * b0 - a01 * b1) / safe
    s1 = (a00 * b1 - a01 * b0) / safe
    ok = valid & (s0 >= 0.0) & (s1 >= 0.0) & (det.abs() >= _DET_EPS)
    pts = 0.5 * (s0[..., None] * d1 + tv + s1[..., None] * d2)
    ok = ok & (pts.abs() < 1e18).all(-1)
    return torch.where(ok[..., None], pts, torch.zeros_like(pts)), ok


def eight_point(k_mat, idx1, idx2, valid, p1, p2, mask1, mask2):
    """The two-view pose (N, 4, 4) of camera 1 in camera 2 (module docstring, step 2)."""
    dt = p1.dtype
    n = p1.shape[0]

    def normalized(p, m):
        half = torch.where(m[..., None], p, torch.zeros_like(p)).amax(dim=1) * 0.5
        half = torch.where(half == 0.0, torch.ones_like(half), half)
        return p / half[:, None, :] - 1.0, half

    q1, h1 = normalized(p1, mask1)
    q2, h2 = normalized(p2, mask2)
    one = torch.ones_like(q1[..., :1])
    d1 = torch.cat([_take(q1, idx1), one], -1)
    d2 = torch.cat([_take(q2, idx2), one], -1)
    rows = (d1[..., :, None] * d2[..., None, :]).reshape(n, -1, 9)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    ata = rows.transpose(1, 2) @ rows
    dev = p1.device
    f = torch.linalg.eigh(_lin(ata))[1][..., 0].reshape(n, 3, 3)
    u, s, vh = torch.linalg.svd(f)
    s = s.clone()
    s[:, 2] = 0.0
    f2 = (u * s[:, None, :]) @ vh

    def denorm(h):
        t = torch.zeros((n, 3, 3), dtype=f2.dtype)
        t[:, 0, 0] = 1.0 / _lin(h[:, 0])
        t[:, 1, 1] = 1.0 / _lin(h[:, 1])
        t[:, 0, 2] = t[:, 1, 2] = -1.0
        t[:, 2, 2] = 1.0
        return t

    k = _lin(k_mat.to(dt))
    e = k.T @ (denorm(h1).transpose(1, 2) @ f2 @ denorm(h2)) @ k
    u, _, vh = torch.linalg.svd(e)
    v = vh.transpose(1, 2)
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=e.dtype,
                     device=e.device)
    r1 = v @ w @ u.transpose(1, 2)
    r2 = v @ w.T @ u.transpose(1, 2)
    sign = torch.where(torch.linalg.det(r1) < 0.0, -1.0, 1.0).to(r1.dtype)[:, None, None]
    r1, r2 = sign * r1, sign * r2

    def unskew(m):
        return torch.stack([m[:, 2, 1], m[:, 0, 2], m[:, 1, 0]], -1)

    t1, t2 = unskew(r1 @ e), unskew(r2 @ e)
    cands = _pose(torch.stack([r1, r1, r2, r2], 1),
                  torch.stack([t1, -t1, t2, -t2], 1)).to(device=dev, dtype=dt)
    _, ok = triangulate(k_mat.to(dt), cands, _take(p1, idx1)[:, None], _take(p2, idx2)[:, None],
                        valid[:, None])
    votes = ok.sum(-1)
    best = votes.argmax(dim=1)   # the first maximum
    x = cands[torch.arange(n, device=cands.device), best]
    won = votes.max(dim=1).values > 0
    eye = torch.eye(4, dtype=dt, device=x.device).expand_as(x)
    return torch.where(won[:, None, None], x, eye)


def lookup(idx2, live, s: int):
    """(N, S): measurement m of the newer frame -> the first live
    correspondence slot on it, or -1."""
    slots = torch.arange(s, device=idx2.device).expand_as(idx2)
    target = torch.where(live, idx2.long(), s)
    lut = torch.full((idx2.shape[0], s + 1), s, dtype=torch.long, device=idx2.device)
    lut = lut.scatter_reduce(1, target, torch.where(live, slots, s), reduce="amin")[:, :s]
    return torch.where(lut < s, lut, -1)


def _euler(a):
    """(N, 3) angles -> Rx(a0) Ry(a1) Rz(a2) (N, 3, 3)."""
    sa, sb, sc = torch.sin(a).unbind(-1)
    ca, cb, cc = torch.cos(a).unbind(-1)
    rows = [[cb * cc, -cb * sc, sb],
            [ca * sc + sa * sb * cc, ca * cc - sa * sb * sc, -sa * cb],
            [sa * sc - ca * sb * cc, sa * cc + ca * sb * sc, ca * cb]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def gauss_newton(k_mat, cam, vo, world, meas, weight):
    """Damped GN pose of N point sets (N, S, 3) against measurements (N, S, 2)
    with weights (N, S): (pose (N, 4, 4), num_inliers (N,) of the last round,
    rounds (N,))."""
    n = world.shape[0]
    dt, dev = world.dtype, world.device
    k = k_mat.to(dt)
    r = torch.eye(3, dtype=dt, device=dev).expand(n, 3, 3).clone()
    t = torch.zeros((n, 3), dtype=dt, device=dev)
    n_in = torch.zeros((n,), dtype=dt, device=dev)
    rounds = torch.zeros((n,), dtype=torch.long, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    kt = float(vo["kernel_threshold"])
    keep_out = 1.0 if vo["keep_outliers"] else 0.0
    damp = torch.eye(6, dtype=_lin(world[:1, :1]).dtype) * float(vo["damping"])
    lo = torch.tensor([0.0, 0.0], dtype=dt, device=dev)
    hi = torch.tensor([cam["cols"] - 1.0, cam["rows"] - 1.0], dtype=dt, device=dev)
    for _ in range(int(vo["gn_iterations"])):
        p = world @ r.transpose(1, 2) + t[:, None, :]               # camera frame (N, S, 3)
        h = p @ k.T
        iz = 1.0 / torch.where(h[..., 2] == 0.0, torch.ones_like(h[..., 2]), h[..., 2])
        uv = h[..., :2] * iz[..., None]
        seen = ((p[..., 2] <= cam["z_far"]) & (p[..., 2] >= cam["z_near"]) & (h[..., 2] > 1e-6)
                & (uv >= lo).all(-1) & (uv <= hi).all(-1))
        e = uv - meas
        chi = (e * e).sum(-1)
        out = chi > kt
        lam = torch.where(out, torch.sqrt(kt / chi.clamp_min(1e-30)), torch.ones_like(chi))
        live = weight * seen.to(dt)
        w = live * torch.where(out, keep_out, 1.0).to(dt) * lam
        # d(uv)/d(p) (N, S, 2, 3): K's rows over z minus its last row times uv over z.
        a = (k[None, None, :2, :] - uv[..., :, None] * k[None, None, 2:3, :]) * iz[..., None, None]
        zero = torch.zeros_like(p[..., 0])
        skew_t = torch.stack([torch.stack([zero, p[..., 2], -p[..., 1]], -1),
                              torch.stack([-p[..., 2], zero, p[..., 0]], -1),
                              torch.stack([p[..., 1], -p[..., 0], zero], -1)], -2)
        jac = torch.cat([a, a @ skew_t], -1)                         # (N, S, 2, 6)
        wj = w[..., None, None] * jac
        h_mat = torch.einsum("nsri,nsrj->nij", wj, jac)
        b = torch.einsum("nsri,nsr->ni", wj, e)
        inl = (live * (~out).to(dt)).sum(-1)
        dx = torch.linalg.solve(_lin(h_mat) + damp, -_lin(b)).to(device=dev, dtype=dt)
        enough = inl >= float(vo["min_num_inliers"])
        dx = torch.where(enough[:, None], dx, torch.zeros_like(dx))
        rd = _euler(dx[:, 3:])
        upd = active[:, None]
        r = torch.where(upd[..., None], rd @ r, r)
        t = torch.where(upd, (rd @ t[..., None])[..., 0] + dx[:, :3], t)
        n_in = torch.where(active, inl, n_in)
        rounds = rounds + active.long()
        moving = enough & ((dx * dx).sum(-1) > float(vo["gn_tolerance"]))
        active = active & (moving | (rounds < int(vo["gn_min_iterations"])))
        if not bool(active.any()):
            break
    return _pose(r, t), n_in, rounds


def fold(points, keys, valid, capacity: int):
    """Fold (N, T) observation streams into maps by exact key (module
    docstring, step 4): (points (N, C, 3), keys (N, C, D), valid (N, C),
    count (N,))."""
    n, tt, d = keys.shape
    dev = points.device
    flat = (keys.reshape(-1, d) + 0.0).contiguous()         # -0.0 -> +0.0
    rows = torch.nonzero(valid.reshape(-1)).squeeze(1)
    out_pts = torch.zeros((n, capacity, 3), dtype=points.dtype, device=dev)
    out_keys = torch.full((n, capacity, d), float("inf"), dtype=keys.dtype, device=dev)
    out_valid = torch.zeros((n, capacity), dtype=torch.bool, device=dev)
    count = torch.zeros((n,), dtype=torch.long, device=dev)
    if rows.numel() == 0:
        return out_pts, out_keys, out_valid, count
    bits = flat[rows].view(torch.int32).long()
    seq = rows // tt
    _, group = torch.unique(torch.cat([seq[:, None], bits], 1), dim=0, return_inverse=True)
    g = int(group.max()) + 1
    first = torch.full((g,), n * tt, dtype=torch.long, device=dev).scatter_reduce(
        0, group, rows, reduce="amin")
    last = torch.full((g,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, group, rows, reduce="amax")
    order = torch.argsort(first)
    first, last = first[order], last[order]
    owner = first // tt
    per_seq = torch.bincount(owner, minlength=n)
    rank = torch.arange(g, device=dev) - (torch.cumsum(per_seq, 0) - per_seq)[owner]
    keep = rank < capacity
    at = (owner[keep], rank[keep])
    out_pts[at] = points.reshape(-1, 3)[last[keep]]
    out_keys[at] = flat[first[keep]]
    out_valid[at] = True
    return out_pts, out_keys, out_valid, per_seq.clamp(max=capacity)


def track(points, appearances, masks, vo: dict, cam: dict, dtype=torch.float64) -> dict:
    """The pipeline over N sequences (N, F, S, ...) on their device: a dict of
    the trajectories (N, F, 4, 4) (identity, the bootstrap pose, the tracked
    relative poses), per tracked frame num_matches, num_solver_corr,
    num_inliers and the GN rounds (N, F - 2), tri_points (N, F - 2, S, 3) in
    the previous frame's coordinates and tri_valid, and the maps
    (map_points (N, C, 3) in frame-0 coordinates, map_apps, map_valid,
    map_count)."""
    n, f, s, _ = points.shape
    dev = points.device
    k_mat = torch.tensor(cam["camera_matrix"], dtype=torch.float64, device=dev).to(dtype)
    p = points.to(dtype)
    apps = appearances.to(dtype)
    idx1, idx2, valid = match_sequences(apps, masks, float(vo["match_radius"]), dtype)

    x_init = eight_point(k_mat, idx1[:, 0], idx2[:, 0], valid[:, 0], p[:, 0], p[:, 1],
                         masks[:, 0], masks[:, 1])
    tri, ok = triangulate(k_mat, x_init, _take(p[:, 0], idx1[:, 0]), _take(p[:, 1], idx2[:, 0]),
                          valid[:, 0])
    # Keys are the appearance rows as given (float32), whatever the arithmetic.
    stream_pts, stream_keys, stream_ok = [tri], [_take(appearances[:, 1], idx2[:, 0])], [ok]
    table = lookup(idx2[:, 0], valid[:, 0] & ok, s)
    x_prev, chain = x_init, inverse(x_init)
    poses, outs = [], {name: [] for name in ("num_matches", "num_solver_corr", "num_inliers",
                                             "rounds", "tri_points", "tri_valid")}
    for kf in range(2, f):
        i1, i2, v = idx1[:, kf - 1], idx2[:, kf - 1], valid[:, kf - 1]
        slot = torch.gather(table, 1, i1.long())
        has = v & (slot >= 0)
        joined = _take(tri, slot.clamp_min(0))
        world = joined @ x_prev[:, :3, :3].transpose(1, 2) + x_prev[:, None, :3, 3]
        world = torch.where(has[..., None], world, torch.ones_like(world))
        meas = torch.where(has[..., None], _take(p[:, kf], i2), torch.zeros_like(world[..., :2]))
        pose, n_in, rounds = gauss_newton(k_mat, cam, vo, world, meas, has.to(dtype))
        tri, ok = triangulate(k_mat, pose, _take(p[:, kf - 1], i1), _take(p[:, kf], i2), v)
        stream_pts.append(tri @ chain[:, :3, :3].transpose(1, 2) + chain[:, None, :3, 3])
        stream_keys.append(_take(appearances[:, kf], i2))
        stream_ok.append(ok)
        table = lookup(i2, v & ok, s)
        chain = chain @ inverse(pose)
        x_prev = pose
        poses.append(pose)
        for name, val in (("num_matches", v.sum(-1)), ("num_solver_corr", has.sum(-1)),
                          ("num_inliers", n_in), ("rounds", rounds), ("tri_points", tri),
                          ("tri_valid", ok)):
            outs[name].append(val)
    out = {name: torch.stack(vals, 1) for name, vals in outs.items()}
    eye = torch.eye(4, dtype=dtype, device=dev).expand(n, 1, 4, 4)
    out["trajectory"] = torch.cat([eye, x_init[:, None], torch.stack(poses, 1)], 1)
    m_pts, m_keys, m_valid, m_count = fold(
        torch.stack(stream_pts, 1).reshape(n, -1, 3),
        torch.stack(stream_keys, 1).reshape(n, -1, appearances.shape[-1]),
        torch.stack(stream_ok, 1).reshape(n, -1), int(vo["map_capacity"]))
    out.update(map_points=m_pts, map_apps=m_keys, map_valid=m_valid, map_count=m_count)
    return out

