"""K2 (world-join candidate chains), K4 and K5 (the fused tracked-frame loop,
SE(3) and planar) and K8 (that loop over a batch of sequences in one launch).

Replaces ``visual_odometry_tpu/ops/pallas/frame_kernel.py``:
``join_candidates`` -> ``csrc/join_candidates.cu`` and ``track_frames_fused``
-> ``csrc/track_frames.cu``, with ``picp_kernel.gn_loop`` inside (K4) or,
with ``planar=True``, ``picp_kernel.gn_loop_se2`` (K5); the device GN loops
are ``csrc/gn_loop.cuh``. The sources' headers give each design and what
bounds it on the card.

The plain version (:func:`track_frames_plain`) is a Python loop over frames
that mirrors the TPU kernel's ``_kernel``/``gn_loop``/``gn_loop_se2`` term by
term — lane work as PyTorch ops on the input device, the lane sums (30 for
SE(3), 12 planar) added in the kernel's own order (:func:`_block_sum`), the
small solve on float32 scalars on the host with a correctly rounded sqrt and
sin/cos taken on the lanes' device. With the library built --fmad=false the
two agree bit for bit on the card; any last-ulp difference would otherwise
grow to ~1e-3 over hundreds of frames through the monocular chain.

K8 (:func:`track_frames_batched`) replaces ``track_frames_fused_serving`` with
``gn_loop_batched``/``gn_loop_se2_batched`` inside: N independent sequences,
one shared camera and one set of knobs, one CTA per sequence of the same
``__global__`` as K4/K5, so a sequence's result equals its single launch bit
for bit. Not carried over from the TPU design: ``inner_batch`` and the sublane
lock-step with frozen converged sequences (a CTA simply leaves its loop), the
``(G, F, 5, B, S)`` transposes, the frame blocking and its zero-validity
padding frames, and ``interpret``. Its plain version is a loop of
:func:`track_frames_plain` over the sequences.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import se3
from . import _lib

_DET_EPS = 1e-12
_EYE12 = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)


class JoinCandidates(NamedTuple):
    """First-wins candidate chains of the frame-to-frame world join."""

    idx: torch.Tensor       # (F, D, S) int32 candidate source lane (0 where absent)
    ok: torch.Tensor        # (F, D, S) bool candidate exists and the lane is valid
    overflow: torch.Tensor  # (F, S) bool multiplicity > D on this lane


# --------------------------------------------------------------------------
# K2: join candidates
# --------------------------------------------------------------------------


def join_candidates_plain(src_idx2, src_valid, dst_idx1, dst_valid, depth: int) -> JoinCandidates:
    """(F, S, S) equality matrix and depth+1 masked min-reductions, as the TPU
    kernel computes it; the extra level is the overflow flag."""
    f, s = src_idx2.shape
    big = 2**30
    eq = (src_idx2[:, :, None] == dst_idx1[:, None, :]) & src_valid[:, :, None]
    rows = torch.arange(s, dtype=torch.int32, device=src_idx2.device)[None, :, None]
    m = torch.where(eq, rows, big)
    prev = torch.full((f, 1, s), -1, dtype=torch.int32, device=src_idx2.device)
    idx, ok = [], []
    for _ in range(depth + 1):
        m = torch.where(rows > prev, m, big)
        c = m.amin(dim=1, keepdim=True)                       # (F, 1, S)
        found = (c < big) & dst_valid[:, None, :]
        idx.append(torch.where(found, c, 0))
        ok.append(found)
        prev = c
    return JoinCandidates(
        idx=torch.cat(idx[:depth], dim=1).to(torch.int32),
        ok=torch.cat(ok[:depth], dim=1),
        overflow=ok[depth][:, 0],
    )


def join_candidates_cuda(src_idx2, src_valid, dst_idx1, dst_valid, depth: int) -> JoinCandidates:
    """Launch K2. Index rows (F, S) int32 and validity rows (F, S) bool."""
    f, s = src_idx2.shape
    dev = _lib.cuda_device(src_idx2)
    _lib.check(src_idx2, "src_idx2", torch.int32, (f, s), dev)
    _lib.check(src_valid, "src_valid", torch.bool, (f, s), dev)
    _lib.check(dst_idx1, "dst_idx1", torch.int32, (f, s), dev)
    _lib.check(dst_valid, "dst_valid", torch.bool, (f, s), dev)
    idx = torch.empty((f, depth, s), dtype=torch.int32, device=dev)
    ok = torch.empty((f, depth, s), dtype=torch.bool, device=dev)
    overflow = torch.empty((f, s), dtype=torch.bool, device=dev)
    _lib.launch(
        "join_candidates", "vo_join_candidates", dev,
        *(t.data_ptr() for t in (src_idx2, src_valid, dst_idx1, dst_valid, idx, ok, overflow)),
        f, s, depth,
    )
    return JoinCandidates(idx=idx, ok=ok, overflow=overflow)


def join_candidates(src_idx2, src_valid, dst_idx1, dst_valid, depth: int,
                    backend: str = "auto") -> JoinCandidates:
    """For output lane j' of frame f, candidate k is the k-th smallest source
    lane j with ``src_idx2[f, j] == dst_idx1[f, j']`` among valid source lanes
    (the static part of vo_complete.cpp:55-63's first-wins join)."""
    if _lib.use_kernel(backend, src_idx2):
        return join_candidates_cuda(src_idx2, src_valid, dst_idx1, dst_valid, depth)
    return join_candidates_plain(src_idx2, src_valid, dst_idx1, dst_valid, depth)


# --------------------------------------------------------------------------
# K4: fused frame loop
# --------------------------------------------------------------------------


def _inv3(m):
    """3x3 inverse via the adjugate; m is a row-major 9-sequence."""
    a, b, c, d, e, f, g, h, i = m
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / det
    return tuple(x * inv_det for x in (A, B, C, D, E, F, G, H, I))


def _mat3mul(m, n):
    return tuple(
        m[3 * r] * n[c] + m[3 * r + 1] * n[3 + c] + m[3 * r + 2] * n[6 + c]
        for r in range(3) for c in range(3)
    )


def _mat3vec(m, v):
    return tuple(m[3 * r] * v[0] + m[3 * r + 1] * v[1] + m[3 * r + 2] * v[2] for r in range(3))


def _transpose3(m):
    return (m[0], m[3], m[6], m[1], m[4], m[7], m[2], m[5], m[8])


def pack_params(camera_matrix, cam_params, x_init, kernel_threshold, damping, tolerance,
                keep_outliers: bool, warm_start: bool, min_num_inliers,
                planar: bool = False, cam_in_robot=None, k_inverse: bool = True) -> torch.Tensor:
    """The float32 parameter row the frame kernels and the standalone solves
    read: [z_near, z_far, cols, rows, kt, keep_outliers, damping, tol,
    warm_start, min_inliers, K (9), K^-1 (9), initial pose 3x4 (12)] — 40
    floats, the TPU kernel's SMEM row — and, when ``planar``, the camera
    mount [R|t] (12) and its rigid inverse (12): 64 floats. ``cam_in_robot``
    None is the identity mount. The standalone solves read no K^-1 and pass
    ``k_inverse=False``, which leaves that block zero. The knobs and the mount
    are laid out on the host and cross to the card in one copy."""
    dev = camera_matrix.device
    host = [torch.tensor(
        [float(kernel_threshold), 1.0 if keep_outliers else 0.0, float(damping),
         float(tolerance), 1.0 if warm_start else 0.0, float(min_num_inliers)],
        dtype=torch.float32,
    )]
    if planar:
        if cam_in_robot is None:
            mount = torch.eye(4, dtype=torch.float32)
        else:
            mount = torch.as_tensor(cam_in_robot, dtype=torch.float32).cpu()
        host += [mount[:3, :4].reshape(12), se3.inverse(mount)[:3, :4].reshape(12)]
    host = torch.cat(host).to(dev)
    k = camera_matrix.to(torch.float32)
    k_inv = torch.linalg.inv(k) if k_inverse else torch.zeros_like(k)
    return torch.cat([
        cam_params.to(torch.float32).reshape(4), host[:6], k.reshape(9), k_inv.reshape(9),
        x_init[:3, :4].to(torch.float32).reshape(12), host[6:],
    ]).contiguous()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on any device, as the CUDA kernel's
    ``sqrtf``: PyTorch's vectorized CPU float32 sqrt is not (about 0.7% of
    results are off by an ulp), its float64 sqrt rounded once to float32 is."""
    return torch.sqrt(x.double()).to(torch.float32)


def _gn_update(sums, pose, damping, tol, min_inl, device):
    """One damped GN solve + Euler-chart update on float32 host scalars, the
    TPU kernel's expressions in its order (picp_kernel.py:362-424)."""
    s = sums.unbind(0)
    hm = {}
    q = 0
    for i in range(6):
        for j in range(i, 6):
            hm[(i, j)] = s[q]
            q += 1
    bv = s[21:27]
    new_chi_in, new_chi_out, new_n_in = s[27], s[28], s[29]

    sc = [1.0 / _sqrt(torch.clamp_min(hm[(i, i)] + damping, 1e-30)) for i in range(6)]

    def se(i, j):
        return hm[(min(i, j), max(i, j))] * sc[i] * sc[j]

    one = torch.ones((), dtype=torch.float32)
    A = (one, se(0, 1), se(0, 2), se(0, 1), one, se(1, 2), se(0, 2), se(1, 2), one)
    B = (se(0, 3), se(0, 4), se(0, 5), se(1, 3), se(1, 4), se(1, 5), se(2, 3), se(2, 4), se(2, 5))
    D = (one, se(3, 4), se(3, 5), se(3, 4), one, se(4, 5), se(3, 5), se(4, 5), one)
    r1 = (-bv[0] * sc[0], -bv[1] * sc[1], -bv[2] * sc[2])
    r2 = (-bv[3] * sc[3], -bv[4] * sc[4], -bv[5] * sc[5])
    Ai = _inv3(A)
    Bt = _transpose3(B)
    S = tuple(d - x for d, x in zip(D, _mat3mul(Bt, _mat3mul(Ai, B))))
    Si = _inv3(S)
    t_r2 = tuple(x - y for x, y in zip(r2, _mat3vec(Bt, _mat3vec(Ai, r1))))
    x2 = _mat3vec(Si, t_r2)
    t_r1 = tuple(x - y for x, y in zip(r1, _mat3vec(B, x2)))
    x1 = _mat3vec(Ai, t_r1)
    y = x1 + x2
    enough = bool(new_n_in >= min_inl)
    dx = [y[i] * sc[i] if enough else torch.zeros((), dtype=torch.float32) for i in range(6)]
    dx2 = dx[0] * dx[0]
    for d in dx[1:]:
        dx2 = dx2 + d * d

    # sin/cos on the lanes' device: on a card that is the libm of the CUDA
    # kernel's sinf/cosf, so the two stay bitwise equal.
    angles = torch.stack(dx[3:6]).to(device)
    sa, sb, ss = torch.sin(angles).cpu().unbind(0)
    ca, cb, cc = torch.cos(angles).cpu().unbind(0)
    rd = (
        cb * cc, -cb * ss, sb,
        ca * ss + sa * sb * cc, ca * cc - sa * sb * ss, -sa * cb,
        sa * ss - ca * sb * cc, sa * cc + ca * sb * ss, ca * cb,
    )
    r_old = (pose[0], pose[1], pose[2], pose[4], pose[5], pose[6], pose[8], pose[9], pose[10])
    r_new = _mat3mul(rd, r_old)
    t_new = tuple(a + b for a, b in zip(_mat3vec(rd, (pose[3], pose[7], pose[11])), dx[:3]))
    new_pose = (
        r_new[0], r_new[1], r_new[2], t_new[0],
        r_new[3], r_new[4], r_new[5], t_new[1],
        r_new[6], r_new[7], r_new[8], t_new[2],
    )
    active = enough and bool(dx2 > tol)
    return new_pose, active, (new_chi_in, new_chi_out, new_n_in)


def _gn_update_se2(sums, pose, par, device):
    """The planar twin (picp_kernel.py:719-766) on the 12 sums: a Jacobi-scaled
    3x3 solve through the adjugate inverse, then ``X <- c^-1 T(d) c X`` with
    ``incr_R = c_inv_R (T(dtheta) c_R)``; ``par`` holds the mount at 40:52 and
    its inverse at 52:64."""
    damping, tol, min_inl = par[6], par[7], par[9]
    c, ci = par[40:52], par[52:64]
    s = sums.unbind(0)
    h00, h01, h02, h11, h12, h22 = s[0:6]
    bv = s[6:9]
    new_chi_in, new_chi_out, new_n_in = s[9], s[10], s[11]
    sc = [1.0 / _sqrt(torch.clamp_min(h + damping, 1e-30)) for h in (h00, h11, h22)]
    s01, s02, s12 = h01 * sc[0] * sc[1], h02 * sc[0] * sc[2], h12 * sc[1] * sc[2]
    one = torch.ones((), dtype=torch.float32)
    Ai = _inv3((one, s01, s02, s01, one, s12, s02, s12, one))
    y = _mat3vec(Ai, (-bv[0] * sc[0], -bv[1] * sc[1], -bv[2] * sc[2]))
    enough = bool(new_n_in >= min_inl)
    dx = [y[i] * sc[i] if enough else torch.zeros((), dtype=torch.float32) for i in range(3)]
    dx2 = dx[0] * dx[0]
    dx2 = dx2 + dx[1] * dx[1]
    dx2 = dx2 + dx[2] * dx[2]

    angle = dx[2].reshape(1).to(device)
    sth, cth = torch.sin(angle).cpu()[0], torch.cos(angle).cpu()[0]
    z = 0.0 * cth
    tr = (cth, -sth, z, sth, cth, z, z, z, 1.0 + z)
    c_r = (c[0], c[1], c[2], c[4], c[5], c[6], c[8], c[9], c[10])
    ci_r = (ci[0], ci[1], ci[2], ci[4], ci[5], ci[6], ci[8], ci[9], ci[10])
    incr_r = _mat3mul(ci_r, _mat3mul(tr, c_r))
    trc = _mat3vec(tr, (c[3], c[7], c[11]))
    trc = (trc[0] + dx[0], trc[1] + dx[1], trc[2])
    incr_t = tuple(a + b for a, b in zip(_mat3vec(ci_r, trc), (ci[3], ci[7], ci[11])))
    r_old = (pose[0], pose[1], pose[2], pose[4], pose[5], pose[6], pose[8], pose[9], pose[10])
    r_new = _mat3mul(incr_r, r_old)
    t_new = tuple(a + b for a, b in zip(_mat3vec(incr_r, (pose[3], pose[7], pose[11])), incr_t))
    new_pose = (
        r_new[0], r_new[1], r_new[2], t_new[0],
        r_new[3], r_new[4], r_new[5], t_new[1],
        r_new[6], r_new[7], r_new[8], t_new[2],
    )
    active = enough and bool(dx2 > tol)
    return new_pose, active, (new_chi_in, new_chi_out, new_n_in)


def _block_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum (R, N) lane rows -> (R,) on the host, in the CUDA kernels' order
    (csrc/gn_loop.cuh). The block has T = min(1024, N rounded up to whole
    warps, at least 64) threads; thread j first adds the terms of points j,
    j + T, j + 2T, ... in ascending order (only the standalone solves have
    N > T), then a shuffle-down tree inside each warp (offsets 16, 8, 4, 2,
    1), then the warps' partials added in warp order. The same order makes the
    plain versions track the kernels bit for bit instead of drifting apart
    through the ill-conditioned monocular triangulation chain."""
    r, n = rows.shape
    lanes = min(1024, max(64, -(-n // 32) * 32))
    per_thread = -(-n // lanes)
    x = torch.nn.functional.pad(rows, (0, per_thread * lanes - n)).reshape(r, per_thread, lanes)
    acc = x[:, 0]
    for i in range(1, per_thread):
        acc = acc + x[:, i]
    x = acc.reshape(r, lanes // 32, 32)
    for o in (16, 8, 4, 2, 1):
        x = x[..., :o] + x[..., o:2 * o]
    parts = x[..., 0].cpu().unbind(1)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _gn_lane_rows(par, pose, wx, wy, wz, mx, my, wgt, planar: bool = False) -> torch.Tensor:
    """One GN round's lane terms under ``pose`` (csrc/gn_loop.cuh
    gn_point_terms): (30, N) rows for SE(3) — H's upper triangle row-major, b,
    chi_in, chi_out, n_in — or (12, N) planar, whose Jacobian is the conjugated
    SE(2) one (picp_kernel.py:680-706); projection and robust kernel are shared."""
    z_near, z_far, cols, rows, kt, keep_out = par[0:6]
    k = par[10:19]
    keep_out = float(keep_out)
    r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = pose
    px = r00 * wx + r01 * wy + r02 * wz + t0
    py = r10 * wx + r11 * wy + r12 * wz + t1
    pz = r20 * wx + r21 * wy + r22 * wz + t2
    hx = k[0] * px + k[1] * py + k[2] * pz
    hy = k[3] * px + k[4] * py + k[5] * pz
    hz = k[6] * px + k[7] * py + k[8] * pz
    iz = 1.0 / torch.where(hz == 0.0, 1.0, hz)
    u = hx * iz
    v = hy * iz
    valid = (
        (pz <= z_far) & (pz >= z_near) & (hz > 1e-6)
        & (u >= 0.0) & (u <= cols - 1.0) & (v >= 0.0) & (v <= rows - 1.0)
    )
    ex = u - mx
    ey = v - my
    chi = ex * ex + ey * ey
    is_out = chi > kt
    lam = torch.where(is_out, _sqrt(kt / torch.clamp_min(chi, 1e-30)), 1.0)
    live = wgt * valid.to(torch.float32)
    w = live * torch.where(is_out, keep_out, 1.0) * lam
    iz2 = iz * iz
    a00 = k[0] * iz - k[6] * hx * iz2
    a01 = k[1] * iz - k[7] * hx * iz2
    a02 = k[2] * iz - k[8] * hx * iz2
    a10 = k[3] * iz - k[6] * hy * iz2
    a11 = k[4] * iz - k[7] * hy * iz2
    a12 = k[5] * iz - k[8] * hy * iz2
    if planar:
        c = par[40:52]
        qx = c[0] * px + c[1] * py + c[2] * pz + c[3]
        qy = c[4] * px + c[5] * py + c[6] * pz + c[7]
        ctx = tuple(qx * b - qy * a for a, b in zip(c[0:3], c[4:7]))
        jx = (a00 * c[0] + a01 * c[1] + a02 * c[2], a00 * c[4] + a01 * c[5] + a02 * c[6],
              a00 * ctx[0] + a01 * ctx[1] + a02 * ctx[2])
        jy = (a10 * c[0] + a11 * c[1] + a12 * c[2], a10 * c[4] + a11 * c[5] + a12 * c[6],
              a10 * ctx[0] + a11 * ctx[1] + a12 * ctx[2])
    else:
        jx = (a00, a01, a02, a01 * (-pz) + a02 * py, a00 * pz + a02 * (-px),
              a00 * (-py) + a01 * px)
        jy = (a10, a11, a12, a11 * (-pz) + a12 * py, a10 * pz + a12 * (-px),
              a10 * (-py) + a11 * px)
    dof = len(jx)
    is_out_f = is_out.to(torch.float32)
    inl = live * (1.0 - is_out_f)
    rows_l = []
    for i in range(dof):
        for j in range(i, dof):
            rows_l.append(w * (jx[i] * jx[j] + jy[i] * jy[j]))
    for i in range(dof):
        rows_l.append(w * (jx[i] * ex + jy[i] * ey))
    rows_l += [chi * inl, chi * live * is_out_f, inl]
    return torch.stack(rows_l)


def _gn_loop_plain(num_iterations, min_iterations, par, pose0, wx, wy, wz, mx, my, wgt,
                   planar: bool = False, rounds_out=None):
    """The GN early-exit loop: lane sums on the lanes' device, solve on host.
    ``planar`` swaps the 6-DoF Jacobian and update for the conjugated SE(2)
    ones. The number of rounds run is appended to the list ``rounds_out``, if
    given (the kernels run the same number: they agree bit for bit)."""
    damping, tol, min_inl = par[6], par[7], par[9]
    pose = pose0
    zero = torch.zeros((), dtype=torch.float32)
    stats = (zero, zero, zero)
    it, active = 0, True
    while it < num_iterations and (active or it < min_iterations):
        sums = _block_sum(_gn_lane_rows(par, pose, wx, wy, wz, mx, my, wgt, planar))
        if planar:
            pose, active, stats = _gn_update_se2(sums, pose, par, wx.device)
        else:
            pose, active, stats = _gn_update(sums, pose, damping, tol, min_inl, wx.device)
        it += 1
    if rounds_out is not None:
        rounds_out.append(it)
    return pose, stats


def track_frames_plain(params, init_tri, init_tri_ok, cand: JoinCandidates, prev_al, cur_al,
                       corr_valid, num_iterations: int, min_iterations: int = 1,
                       planar: bool = False, rounds_out=None):
    """Plain PyTorch version of K4 (and of K5 with ``planar``), frame by frame;
    each frame's GN round count is appended to the list ``rounds_out``, if given."""
    dev = prev_al.device
    f, depth, s = cand.idx.shape
    par = params.cpu().unbind(0)
    warm = float(par[8]) > 0.5
    ik = par[19:28]
    pose = tuple(par[28:40])
    tri_rows = torch.cat([init_tri.T.to(torch.float32), init_tri_ok.to(torch.float32)[None]])
    poses, tris, oks, stats = [], [], [], []
    for i in range(f):
        u1, v1 = prev_al[i, :, 0], prev_al[i, :, 1]
        u2, v2 = cur_al[i, :, 0], cur_al[i, :, 1]
        # ---- world join: first valid candidate of the chain ----
        tx, ty, tz, tok = tri_rows
        px = pose[0] * tx + pose[1] * ty + pose[2] * tz + pose[3]
        py = pose[4] * tx + pose[5] * ty + pose[6] * tz + pose[7]
        pz = pose[8] * tx + pose[9] * ty + pose[10] * tz + pose[11]
        rows4 = torch.stack([px, py, pz, tok])
        g = rows4[:, cand.idx[i, 0].long()]
        wx, wy, wz = g[0], g[1], g[2]
        have = cand.ok[i, 0] & (g[3] > 0.5)
        for d in range(1, depth):
            g = rows4[:, cand.idx[i, d].long()]
            ok_d = cand.ok[i, d] & (g[3] > 0.5)
            take = ok_d & ~have
            wx = torch.where(take, g[0], wx)
            wy = torch.where(take, g[1], wy)
            wz = torch.where(take, g[2], wz)
            have = have | ok_d
        weight = have.to(torch.float32)

        # ---- GN with dead slots sanitized (0 * NaN never reaches H) ----
        pose0 = pose if warm else tuple(torch.tensor(e, dtype=torch.float32) for e in _EYE12)
        new_pose, (chi_in, chi_out, n_in) = _gn_loop_plain(
            num_iterations, min_iterations, par, pose0,
            torch.where(have, wx, 1.0), torch.where(have, wy, 1.0), torch.where(have, wz, 1.0),
            torch.where(have, u2, 0.0), torch.where(have, v2, 0.0), weight, planar, rounds_out,
        )

        # ---- mid-point triangulation, previous-frame coordinates ----
        p = new_pose
        rt = _transpose3((p[0], p[1], p[2], p[4], p[5], p[6], p[8], p[9], p[10]))
        it = tuple(-x for x in _mat3vec(rt, (p[3], p[7], p[11])))
        ir_ik = _mat3mul(rt, ik)
        d1x = ik[0] * u1 + ik[1] * v1 + ik[2]
        d1y = ik[3] * u1 + ik[4] * v1 + ik[5]
        d1z = ik[6] * u1 + ik[7] * v1 + ik[8]
        d2x = ir_ik[0] * u2 + ir_ik[1] * v2 + ir_ik[2]
        d2y = ir_ik[3] * u2 + ir_ik[4] * v2 + ir_ik[5]
        d2z = ir_ik[6] * u2 + ir_ik[7] * v2 + ir_ik[8]
        a00 = d1x * d1x + d1y * d1y + d1z * d1z
        a01 = -(d1x * d2x + d1y * d2y + d1z * d2z)
        a11 = d2x * d2x + d2y * d2y + d2z * d2z
        b0 = d1x * it[0] + d1y * it[1] + d1z * it[2]
        b1 = -(d2x * it[0] + d2y * it[1] + d2z * it[2])
        det = a00 * a11 - a01 * a01
        safe_det = torch.where(det.abs() < _DET_EPS, 1.0, det)
        s0 = (a11 * b0 - a01 * b1) / safe_det
        s1 = (a00 * b1 - a01 * b0) / safe_det
        new_ok = corr_valid[i] & (s0 >= 0.0) & (s1 >= 0.0) & (det.abs() >= _DET_EPS)
        vx = 0.5 * (s0 * d1x + it[0] + s1 * d2x)
        vy = 0.5 * (s0 * d1y + it[1] + s1 * d2y)
        vz = 0.5 * (s0 * d1z + it[2] + s1 * d2z)
        new_ok = new_ok & (vx.abs() < 1e18) & (vy.abs() < 1e18) & (vz.abs() < 1e18)
        tri_rows = torch.stack([
            torch.where(new_ok, vx, 0.0), torch.where(new_ok, vy, 0.0),
            torch.where(new_ok, vz, 0.0), new_ok.to(torch.float32),
        ])
        poses.append(torch.stack(new_pose))
        stats.append(torch.stack([chi_in, chi_out, n_in, weight.sum().cpu()]))
        tris.append(tri_rows[:3].T)
        oks.append(new_ok)
        pose = new_pose

    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
    if f:
        pose_rows = torch.stack(poses).reshape(f, 3, 4)
        out_poses = torch.cat([pose_rows, bottom.expand(f, 1, 4)], dim=1).to(dev)
        return out_poses, torch.stack(tris), torch.stack(oks), torch.stack(stats).to(dev)
    return (torch.zeros((0, 4, 4), device=dev), torch.zeros((0, s, 3), device=dev),
            torch.zeros((0, s), dtype=torch.bool, device=dev), torch.zeros((0, 4), device=dev))


def track_frames_cuda(params, init_tri, init_tri_ok, cand: JoinCandidates, prev_al, cur_al,
                      corr_valid, num_iterations: int, min_iterations: int = 1,
                      planar: bool = False):
    """Launch K4, or K5 with ``planar``: one CTA, one thread per lane (S <= 1024)."""
    f, depth, s = cand.idx.shape
    dev = _lib.cuda_device(prev_al)
    if s > 1024:
        raise ValueError(f"track_frames kernel takes S <= 1024 lanes, got {s}")
    _lib.check(params, "params", torch.float32, (64 if planar else 40,), dev)
    _lib.check(init_tri, "init_tri", torch.float32, (s, 3), dev)
    _lib.check(init_tri_ok, "init_tri_ok", torch.bool, (s,), dev)
    _lib.check(cand.idx, "cand.idx", torch.int32, (f, depth, s), dev)
    _lib.check(cand.ok, "cand.ok", torch.bool, (f, depth, s), dev)
    _lib.check(prev_al, "prev_al", torch.float32, (f, s, 2), dev)
    _lib.check(cur_al, "cur_al", torch.float32, (f, s, 2), dev)
    _lib.check(corr_valid, "corr_valid", torch.bool, (f, s), dev)
    poses = torch.empty((f, 4, 4), dtype=torch.float32, device=dev)
    tri = torch.empty((f, s, 3), dtype=torch.float32, device=dev)
    tri_ok = torch.empty((f, s), dtype=torch.bool, device=dev)
    stats = torch.empty((f, 4), dtype=torch.float32, device=dev)
    _lib.launch(
        *(("track_frames_planar", "vo_track_frames_planar") if planar
          else ("track_frames", "vo_track_frames")), dev,
        *(t.data_ptr() for t in (params, init_tri, init_tri_ok, cand.idx, cand.ok, prev_al,
                                 cur_al, corr_valid, poses, tri, tri_ok, stats)),
        f, s, depth, int(num_iterations), int(min_iterations),
    )
    return poses, tri, tri_ok, stats


def track_frames(
    camera_matrix, cam_params, x_init, init_tri, init_tri_ok, cand: JoinCandidates,
    prev_al, cur_al, corr_valid, num_iterations: int, kernel_threshold, damping, tolerance,
    keep_outliers: bool = False, warm_start: bool = False, min_num_inliers=0.0,
    min_iterations: int = 1, backend: str = "auto", planar: bool = False, cam_in_robot=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the whole F-frame tracking loop (the JAX ``track_frames_fused``
    contract). ``planar`` runs the conjugated-SE(2) solve with ``cam_in_robot``
    as the mount (None = identity); callers planarize ``x_init`` so the carried
    trajectory stays in the conjugated subgroup. Pixel rows come pre-gathered to correspondence lanes
    (``prev_al[i] = prev_pts[i][idx1[i]]``, ``cur_al[i] = cur_pts[i][idx2[i]]``)
    and the join chains from :func:`join_candidates`. Returns poses (F, 4, 4),
    tri_points (F, S, 3), tri_valid (F, S) and stats (F, 4) =
    [chi_inliers, chi_outliers, num_inliers, num_solver_corr]."""
    params = pack_params(camera_matrix, cam_params, x_init, kernel_threshold, damping,
                         tolerance, keep_outliers, warm_start, min_num_inliers, planar,
                         cam_in_robot)
    args = (params, init_tri, init_tri_ok, cand, prev_al, cur_al, corr_valid,
            num_iterations, min_iterations, planar)
    if _lib.use_kernel(backend, prev_al):
        return track_frames_cuda(*args)
    return track_frames_plain(*args)


# --------------------------------------------------------------------------
# K8: the frame loop over a batch of sequences
# --------------------------------------------------------------------------


def track_frames_batched_plain(params, pose0, init_tri, init_tri_ok, cand: JoinCandidates,
                               prev_al, cur_al, corr_valid, num_iterations: int,
                               min_iterations: int = 1, planar: bool = False):
    """Plain PyTorch version of K8: :func:`track_frames_plain` on each sequence
    in turn, the shared parameter row with that sequence's start pose in it."""
    outs = []
    for i in range(pose0.shape[0]):
        row = params.clone()
        row[28:40] = pose0[i]
        outs.append(track_frames_plain(
            row, init_tri[i], init_tri_ok[i], JoinCandidates(*(x[i] for x in cand)), prev_al[i],
            cur_al[i], corr_valid[i], num_iterations, min_iterations, planar))
    return tuple(torch.stack(x) for x in zip(*outs))


def track_frames_batched_cuda(params, pose0, init_tri, init_tri_ok, cand: JoinCandidates,
                              prev_al, cur_al, corr_valid, num_iterations: int,
                              min_iterations: int = 1, planar: bool = False):
    """Launch K8: one CTA per sequence, one thread per lane (S <= 1024)."""
    n, f, depth, s = cand.idx.shape
    dev = _lib.cuda_device(prev_al)
    if s > 1024:
        raise ValueError(f"track_frames_batched kernel takes S <= 1024 lanes, got {s}")
    _lib.check(params, "params", torch.float32, (64 if planar else 40,), dev)
    _lib.check(pose0, "pose0", torch.float32, (n, 12), dev)
    _lib.check(init_tri, "init_tri", torch.float32, (n, s, 3), dev)
    _lib.check(init_tri_ok, "init_tri_ok", torch.bool, (n, s), dev)
    _lib.check(cand.idx, "cand.idx", torch.int32, (n, f, depth, s), dev)
    _lib.check(cand.ok, "cand.ok", torch.bool, (n, f, depth, s), dev)
    _lib.check(prev_al, "prev_al", torch.float32, (n, f, s, 2), dev)
    _lib.check(cur_al, "cur_al", torch.float32, (n, f, s, 2), dev)
    _lib.check(corr_valid, "corr_valid", torch.bool, (n, f, s), dev)
    poses = torch.empty((n, f, 4, 4), dtype=torch.float32, device=dev)
    tri = torch.empty((n, f, s, 3), dtype=torch.float32, device=dev)
    tri_ok = torch.empty((n, f, s), dtype=torch.bool, device=dev)
    stats = torch.empty((n, f, 4), dtype=torch.float32, device=dev)
    _lib.launch(
        *(("track_frames_batched_planar", "vo_track_frames_batched_planar") if planar
          else ("track_frames_batched", "vo_track_frames_batched")), dev,
        *(t.data_ptr() for t in (params, pose0, init_tri, init_tri_ok, cand.idx, cand.ok, prev_al,
                                 cur_al, corr_valid, poses, tri, tri_ok, stats)),
        n, f, s, depth, int(num_iterations), int(min_iterations),
    )
    return poses, tri, tri_ok, stats


def track_frames_batched(
    camera_matrix, cam_params, x_init, init_tri, init_tri_ok, cand: JoinCandidates,
    prev_al, cur_al, corr_valid, num_iterations: int, kernel_threshold, damping, tolerance,
    keep_outliers: bool = False, warm_start: bool = False, min_num_inliers=0.0,
    min_iterations: int = 1, backend: str = "auto", planar: bool = False, cam_in_robot=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track N independent sequences in one launch (the JAX
    ``track_frames_fused_serving`` contract): one shared camera and one set of
    knobs; ``x_init`` (N, 4, 4), ``init_tri`` (N, S, 3), ``init_tri_ok``
    (N, S), ``cand`` with (N, F, D, S) chains, ``prev_al``/``cur_al``
    (N, F, S, 2), ``corr_valid`` (N, F, S). Returns poses (N, F, 4, 4), tri
    (N, F, S, 3), tri_ok (N, F, S) and stats (N, F, 4); per sequence the
    result of :func:`track_frames` on that sequence's inputs. A sequence with
    no valid correspondence runs ``min_iterations`` rounds a frame (the whole
    budget under ``tolerance < 0``) on zero sums and keeps its start pose or
    the identity; nothing in it is NaN."""
    params = pack_params(camera_matrix, cam_params, x_init[0], kernel_threshold, damping,
                         tolerance, keep_outliers, warm_start, min_num_inliers, planar,
                         cam_in_robot)
    pose0 = x_init[:, :3, :4].to(torch.float32).reshape(-1, 12).contiguous()
    args = (params, pose0, init_tri, init_tri_ok, cand, prev_al, cur_al, corr_valid,
            num_iterations, min_iterations, planar)
    if _lib.use_kernel(backend, prev_al):
        return track_frames_batched_cuda(*args)
    return track_frames_batched_plain(*args)
