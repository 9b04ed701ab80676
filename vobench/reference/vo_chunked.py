"""Plain reference of the sequence-parallel tracking path the benchmark times:
``visual_odometry_tpu_torch``'s ``parallel/posegraph.run_sequence_chunked``
(what ``apps.run_vo_complete`` runs when ``num_chunks`` > 1), written again
from the semantics its module states, batched over sequences, in float64 by
default. Every chunk is tracked by ``vo.track``; the plan, the stitch and the
one map are this module's.

Per sequence (frames F, chunks C, overlap O = ``chunk_overlap``):

1. Scores: every consecutive pair (k, k + 1) matched at radius 0.1
   (``vo.match``), a DLT homography fitted to its correspondences on
   [-1, 1]-normalized points (the normal matrix's null vector by ``eigh``),
   and the lower median of the transfer residuals (a correspondence counts
   where the homography's third row is at least 1e-12 in magnitude there);
   a pair with fewer than 8 residuals scores 0.
2. Slack: the longest run of scores below 0.4 x the median of the positive
   scores, plus 2, capped at max(F // C - 2, 4) and then floored at 8.
3. Starts: stride ceil((F - O) / C), chunk length L = stride + O + slack,
   chunk c nominally at c x stride and the last at F - L. Chunk 0 stays at
   frame 0; each chunk between slides earlier, by up to the slack, to the
   first best score of its window; the last only later (not past F - 4). A
   chunk's frames past the sequence's end repeat its last frame. A start
   whose score lies within ``TIE`` of its window's best is a choice that the
   program's float32 scores may make as well: each such plan is tracked too,
   as an alternative, and the comparison holds the program to the plan whose
   starts it took.
4. Tracking: every chunk as a sequence of its own (``vo.track``).
5. Boundary scales, chained from chunk 0's 1: over the frames both chunks
   track after their bootstraps, the lower median of the norm ratios of the
   triangulations valid in both (the earlier chunk's over the later's, where
   the later's exceeds 1e-8) where there are 8 or more; otherwise the lower
   median of the tracked poses' translation-length ratios over the poses that
   move in both chunks (a length above 0.2 of the overlap's longest and above
   1e-4), 1 where none does. ``num_ratio_obs`` is the count used.
6. Splice: chunk c's own poses are global entries [e_c, e_{c+1}) with e_0 = 0,
   e_c = min(start_{c-1} + L, F) and the last chunk's end F, translations
   times the chunk's scale.
7. The map: chunk 0's bootstrap triangulation, then every tracked frame's,
   from the chunk whose poses hold that frame, times its scale, moved into
   frame-0 coordinates by the spliced trajectory's chain, keyed by the newer
   frame's appearance rows, folded in observation order (``vo.fold``).

Tracking is causal, so every chunk is tracked at the longest chunk length
the plans ask for and each keeps its own first L frames. The outputs, a
leading sequence axis on each: the spliced trajectory, the map, ``scales``
(N, C), ``num_ratio_obs`` (N, C - 1), ``starts`` (N, C), ``rounds`` (a list:
per sequence the GN rounds (C, L - 2) of its chunks' tracked frames) and
``alternatives`` (a list: per sequence the outputs of its other plans).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from vobench import compare
from vobench.reference import vo

SCORE_RADIUS = 0.1
MIN_RESIDUALS = 8
BAD_SCORE = 0.4
MIN_SLACK = 8
MIN_SHARED = 8
EPS = 1e-8
MOTION_FRACTION = 0.2
MIN_MOTION = 1e-4
# A start whose score lies within this share of its window's best is a plan
# the program's float32 scores may choose too: on the card they lie within
# 1.8e-4 of these (PERF.md), so two of them within 3.6e-4 of each other.
TIE = 1e-3
MAX_PLANS = 8
PLANNED = ("trajectory", "scales", "num_ratio_obs", "starts", "map_points", "map_apps",
           "map_valid", "map_count")


def _lower_median(values, valid):
    """(the entry at (count - 1) // 2 of the valid entries of the last axis,
    sorted; 1 where none is valid, count)."""
    count = valid.sum(-1)
    ordered = torch.sort(torch.where(valid, values, torch.full_like(values, float("inf"))),
                         dim=-1).values
    med = ordered.gather(-1, ((count - 1).clamp_min(0) // 2)[..., None])[..., 0]
    return torch.where(count > 0, med, torch.ones_like(med)), count


def scores(points, appearances, masks, dtype) -> torch.Tensor:
    """Step 1 over (N, F, S, ...) sequences: (N, F - 1) in float64."""
    n, f, s, _ = points.shape
    idx1, idx2, valid = vo.match_sequences(appearances.to(dtype), masks, SCORE_RADIUS, dtype)
    p = points.to(dtype)
    half = torch.where(masks[..., None], p, torch.zeros_like(p)).amax(dim=2, keepdim=True) * 0.5
    q = p / torch.where(half == 0.0, torch.ones_like(half), half) - 1.0
    a = vo._take(q[:, :-1].reshape(-1, s, 2), idx1.reshape(-1, s))
    b = vo._take(q[:, 1:].reshape(-1, s, 2), idx2.reshape(-1, s))
    ok = valid.reshape(-1, s)
    x1, y1, x2, y2 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    rows = torch.cat([torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], -1),
                      torch.stack([zero, zero, zero, x1, y1, one, -y2 * x1, -y2 * y1, -y2], -1)],
                     dim=1)
    rows = torch.where(torch.cat([ok, ok], 1)[..., None], rows, torch.zeros_like(rows))
    h = torch.linalg.eigh(vo._lin(rows.transpose(1, 2) @ rows))[1][..., 0]
    h = h.to(device=p.device, dtype=dtype).reshape(-1, 3, 3)
    hx = h[:, :, 0, None] * x1[:, None] + h[:, :, 1, None] * y1[:, None] + h[:, :, 2, None]
    ok = ok & (hx[:, 2].abs() >= 1e-12)
    z = torch.where(ok, hx[:, 2], torch.ones_like(hx[:, 2]))
    dx, dy = hx[:, 0] / z - x2, hx[:, 1] / z - y2
    med, count = _lower_median(torch.sqrt(dx * dx + dy * dy).double(), ok)
    return torch.where(count >= MIN_RESIDUALS, med, torch.zeros_like(med)).reshape(n, f - 1)


def slack(score: np.ndarray, frames: int, chunks: int) -> int:
    """Step 2 for one sequence's scores (F - 1,)."""
    good = score[score > 0]
    bar = BAD_SCORE * (float(np.median(good)) if good.size else 0.0)
    run = max((len(list(g)) for bad, g in itertools.groupby(score < bar) if bad), default=0)
    return max(MIN_SLACK, min(run + 2, max(frames // chunks - 2, 4)))


def plans(score: np.ndarray, frames: int, chunks: int, overlap: int) -> list:
    """Steps 2-3 for one sequence: [(chunk starts, chunk length)], the plan
    first, then the plans that float32 scores may choose as well: each start
    its window's first best or within ``TIE`` of that best (at most
    ``MAX_PLANS`` in all)."""
    room = slack(score, frames, chunks)
    stride = -(-(frames - overlap) // chunks)
    length = stride + overlap + room
    options = [[0]]
    for c in range(1, chunks):
        if c < chunks - 1:
            nominal = c * stride
            window = range(max(nominal - room, 0), nominal + 1)
        else:
            nominal = frames - length
            window = range(nominal, min(nominal + room, frames - 4) + 1)
        best = max(float(score[s]) for s in window)
        first = next(s for s in window if float(score[s]) == best)
        options.append([first] + [s for s in window
                                  if s != first and float(score[s]) >= best * (1.0 - TIE)])
    return [(list(starts), length)
            for starts in itertools.islice(itertools.product(*options), MAX_PLANS)]


def _scales(trajs, tri, tri_ok, starts, length, frames):
    """Step 5 for one sequence's chunks: (scales (C,), counts (C - 1,))."""
    scales = [torch.ones((), dtype=trajs.dtype, device=trajs.device)]
    counts = []
    for c in range(1, len(starts)):
        lo, hi = starts[c] + 2, min(starts[c - 1] + length, frames)
        ja = lo - starts[c - 1] - 2
        na = torch.linalg.vector_norm(tri[c - 1, ja:ja + hi - lo], dim=-1).reshape(-1)
        nb = torch.linalg.vector_norm(tri[c, :hi - lo], dim=-1).reshape(-1)
        shared = (tri_ok[c - 1, ja:ja + hi - lo] & tri_ok[c, :hi - lo]).reshape(-1) & (nb > EPS)
        tri_ratio, tri_count = _lower_median(na / nb.clamp_min(EPS), shared)
        ta = torch.linalg.vector_norm(trajs[c - 1, lo - starts[c - 1]:hi - starts[c - 1], :3, 3],
                                      dim=-1)
        tb = torch.linalg.vector_norm(trajs[c, 2:hi - starts[c], :3, 3], dim=-1)
        moving = ((ta > (MOTION_FRACTION * ta.max()).clamp_min(MIN_MOTION))
                  & (tb > (MOTION_FRACTION * tb.max()).clamp_min(MIN_MOTION)))
        pose_ratio, pose_count = _lower_median(ta / tb.clamp_min(EPS), moving)
        use_tri = tri_count >= MIN_SHARED
        scales.append(scales[-1] * torch.where(use_tri, tri_ratio, pose_ratio))
        counts.append(torch.where(use_tri, tri_count, pose_count))
    return torch.stack(scales), torch.stack(counts)


def _run(points, appearances, masks, vo_cfg: dict, cam: dict, dtype, jobs: list) -> dict:
    """Steps 4-7 for ``jobs``, each (sequence, chunk starts, chunk length):
    their outputs on a leading job axis, ``rounds`` a list."""
    f, s, d = appearances.shape[1:]
    dev = points.device
    j, chunks = len(jobs), len(jobs[0][1])
    longest = max(length for _, _, length in jobs)
    frame = torch.tensor([[min(s0 + k, f - 1) for k in range(longest)]
                          for _, starts, _ in jobs for s0 in starts], device=dev)
    seq = torch.tensor([i for i, _, _ in jobs], device=dev)
    rows = seq.repeat_interleave(chunks)[:, None]
    chunked = vo.track(points[rows, frame], appearances[rows, frame], masks[rows, frame], vo_cfg,
                       cam, dtype)
    trajs = chunked["trajectory"].reshape(j, chunks, longest, 4, 4)
    tri = chunked["tri_points"].reshape(j, chunks, longest - 2, s, 3)
    tri_ok = chunked["tri_valid"].reshape(j, chunks, longest - 2, s)
    rounds = chunked["rounds"].reshape(j, chunks, longest - 2)
    del chunked

    # Steps 5-6, and for each tracked frame g >= 2 the chunk whose poses
    # hold it (its triangulation's chunk and output index).
    traj, scales, counts = [], [], []
    owner_chunk = torch.zeros((j, f - 2), dtype=torch.long)
    owner_out = torch.zeros((j, f - 2), dtype=torch.long)
    for b, (_, starts, length) in enumerate(jobs):
        sc, cnt = _scales(trajs[b], tri[b], tri_ok[b], starts, length, f)
        ends = [min(s0 + length, f) for s0 in starts[:-1]] + [f]
        firsts = [0] + ends[:-1]
        pieces = []
        for c, (lo, hi) in enumerate(zip(firsts, ends)):
            own = trajs[b, c, lo - starts[c]:hi - starts[c]]
            pieces.append(vo._pose(own[:, :3, :3], own[:, :3, 3] * sc[c]))
            g = torch.arange(max(lo, 2), hi)
            owner_chunk[b, g - 2] = c
            owner_out[b, g - 2] = g - starts[c] - 2
        traj.append(torch.cat(pieces))
        scales.append(sc)
        counts.append(cnt)
    traj, scales = torch.stack(traj), torch.stack(scales)

    # Step 7: chains[:, k] moves frame-k coordinates into frame 0's.
    chains = [torch.eye(4, dtype=dtype, device=dev).expand(j, 4, 4)]
    for k in range(1, f - 1):
        chains.append(chains[-1] @ vo.inverse(traj[:, k]))
    chains = torch.stack(chains, 1)
    idx1, idx2, valid = vo.match_sequences(appearances.to(dtype), masks,
                                           float(vo_cfg["match_radius"]), dtype)
    idx1, idx2, valid = idx1[seq], idx2[seq], valid[seq]
    k_mat = torch.tensor(cam["camera_matrix"], dtype=torch.float64, device=dev).to(dtype)
    p = points[seq].to(dtype)
    boot, boot_ok = vo.triangulate(k_mat, traj[:, 1], vo._take(p[:, 0], idx1[:, 0]),
                                   vo._take(p[:, 1], idx2[:, 0]), valid[:, 0])
    b = torch.arange(j, device=dev)[:, None]
    owner_chunk, owner_out = owner_chunk.to(dev), owner_out.to(dev)
    local = tri[b, owner_chunk, owner_out] * scales[b, owner_chunk][..., None, None]
    moved = local @ chains[:, 1:, :3, :3].transpose(-1, -2) + chains[:, 1:, None, :3, 3]
    stream = torch.cat([boot[:, None], moved], 1).reshape(j, -1, 3)
    stream_ok = torch.cat([boot_ok[:, None], tri_ok[b, owner_chunk, owner_out]], 1)
    # The keys: the newer frame's appearance rows, as given (float32).
    keys = vo._take(appearances[seq, 1:].reshape(-1, s, d), idx2.reshape(-1, s))
    m_pts, m_keys, m_valid, m_count = vo.fold(stream, keys.reshape(j, -1, d),
                                              stream_ok.reshape(j, -1),
                                              int(vo_cfg["map_capacity"]))
    return {"trajectory": traj, "scales": scales, "num_ratio_obs": torch.stack(counts),
            "starts": torch.tensor([starts for _, starts, _ in jobs], device=dev),
            "map_points": m_pts, "map_apps": m_keys, "map_valid": m_valid, "map_count": m_count,
            "rounds": [rounds[k, :, :length - 2] for k, (_, _, length) in enumerate(jobs)]}


def track(points, appearances, masks, vo_cfg: dict, cam: dict, dtype=torch.float64) -> dict:
    """The chunked pipeline over N sequences (N, F, S, ...) on their device
    (module docstring), of each sequence's plan; ``alternatives`` holds per
    sequence the outputs of its other plans (``plans``), one dict each."""
    n, f = points.shape[:2]
    chunks, overlap = int(vo_cfg["num_chunks"]), int(vo_cfg["chunk_overlap"])
    score = scores(points, appearances, masks, dtype).cpu().numpy()
    jobs = [(i, starts, length) for i in range(n)
            for starts, length in plans(score[i], f, chunks, overlap)]
    out = _run(points, appearances, masks, vo_cfg, cam, dtype, jobs)
    rounds = out.pop("rounds")
    first = [next(b for b, job in enumerate(jobs) if job[0] == i) for i in range(n)]
    result = {k: v[first] for k, v in out.items()}
    result["rounds"] = [rounds[b] for b in first]
    result["alternatives"] = [[{k: v[b] for k, v in out.items()}
                               for b, job in enumerate(jobs) if job[0] == i and b != first[i]]
                              for i in range(n)]
    return result


def _plan_taken(prog: dict, ref: dict) -> dict:
    """``ref`` with each sequence's outputs those of the plan whose starts
    the program took, where that is one of its alternatives."""
    rows = []
    for i in range(ref["starts"].shape[0]):
        row = {k: ref[k][i] for k in PLANNED}
        taken = prog["starts"][i].to(ref["starts"].device)
        if not torch.equal(row["starts"], taken):
            row = next((alt for alt in ref["alternatives"][i]
                        if torch.equal(alt["starts"], taken)), row)
        rows.append(row)
    return {k: torch.stack([row[k] for row in rows]) for k in PLANNED}


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers ``compare.NUMBERS`` names, for the chunked path, of one
    call: ``prog`` and ``ref`` hold the same sequences on a leading axis.

    * ``boot_gap``: chunk 0's bootstrap pose (entry 1), as ``compare.gaps``;
    * ``pose_gap``: every spliced pose (entries 2 on), translations over the
      length of the reference's entry 1 (chunk 0's monocular scale);
    * ``tri_gap``: the cumulative boundary scales' largest difference over
      the reference's scale: what the overlaps' triangulations decide here;
    * ``map_gap``: as ``compare.gaps``;
    * ``count_gap``: the largest difference of the map's entry count or of a
      boundary's scale observations (``num_ratio_obs``);
    * ``mismatch``: map flags and keys that differ, and a map's capacity for
      every chunk start that differs from the reference's plan, where the
      program's starts are no alternative of it, so that no other plan passes.

    Where the program took an alternative plan, every number is of that plan.

    A NaN anywhere makes its number NaN, which no limit passes."""
    dev = ref["trajectory"].device
    p = {k: v.to(dev) for k, v in prog.items() if torch.is_tensor(v)}
    r = _plan_taken(p, ref)
    f64 = torch.float64
    traj_p, traj_r = p["trajectory"].to(f64), r["trajectory"].to(f64)
    scale = torch.linalg.vector_norm(traj_r[:, 1, :3, 3], dim=-1)
    boot = compare._pose_gap(traj_p[:, 1], traj_r[:, 1], scale)
    poses = compare._pose_gap(traj_p[:, 2:], traj_r[:, 2:], scale[:, None])
    scales_r = r["scales"].to(f64)
    scale_gap = (p["scales"].to(f64) - scales_r).abs() / scales_r.abs().clamp_min(1e-30)

    keys_equal = (p["map_apps"].to(f64) == r["map_apps"].to(f64)).all(-1)
    both = p["map_valid"] & r["map_valid"] & keys_equal
    dist = torch.linalg.vector_norm(p["map_points"].to(f64) - r["map_points"].to(f64), dim=-1)
    map_rel = (dist / torch.linalg.vector_norm(r["map_points"].to(f64), dim=-1)
               .clamp_min(1e-30))[both]
    counts = max(int((p[k].long() - r[k].long()).abs().max()) if r[k].numel() else 0
                 for k in ("map_count", "num_ratio_obs"))
    capacity = r["map_valid"].shape[-1]
    mismatch = ((p["map_valid"] != r["map_valid"]).sum()
                + (p["map_valid"] & r["map_valid"] & ~keys_equal).sum()
                + capacity * (p["starts"].long() != r["starts"].long()).sum())
    return {
        "boot_gap": compare._max(boot),
        "pose_gap": compare._max(poses),
        "tri_gap": compare._max(scale_gap),
        "map_gap": compare._max(map_rel),
        "count_gap": float(counts),
        "mismatch": float(mismatch),
    }

