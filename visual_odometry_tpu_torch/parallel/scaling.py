"""1 -> N scaling measurement on a world of ranks (port of
visual_odometry_tpu.parallel.scaling; BASELINE.md's ">=80% frames/s from 1
chip to N>=2" acceptance criterion).

The reference is single-threaded; nothing there scales. The scaling axes
(SURVEY.md §5) are measured over ``parallel/mesh`` meshes:

  * ``dp`` — the data-parallel multi-sequence tracker
    (``multiseq.run_sequences_batched(mesh=)``): a FIXED total batch of
    independent sequences split over 1, 2, 4, ... ranks (strong scaling; the
    ranks exchange only the gathered results);
  * ``sp`` — the sequence-parallel chunked tracker
    (``posegraph.run_sequence_chunked(mesh=)``): ONE fixed sequence in n
    chunks, a chunk a rank; n = 1 is the serial pipeline, as in the JAX
    module;
  * ``lm`` — the landmark-sharded sparse Schur-CG bundle adjustment
    (``sparse_ba.sparse_ba_step`` over an ``lm`` axis): landmarks and their
    observations in n blocks, (F, 6)-sized sums over the axis.

Worlds. A ``torch.distributed`` world has one size, so each n is a world of
its own, started by ``parallel.mesh.run_local`` (a process a rank), and every
workload of one measurement runs in the same world for each n: starting a
world costs seconds. Inside a world that is already initialised
(``torchrun``), a measurement measures that world's size only, and its rows
carry no speedup or partition efficiency: those need the n = 1 row. Every world of
one measurement runs one transport, so a row set shares it: NCCL where each
rank of the largest world has a card of its own, else gloo (NCCL refuses two
ranks on one card; under gloo a card's collectives are staged through the
host, ``Mesh.staged_bytes`` in each row). The device is the card unless the
caller passes ``device="cpu"``.

Measurement honesty. n ranks that share one card, or the host's cores (CPU
ranks each take ``cpu_count / n`` threads, ``mesh.run_local``), cap the
wall-clock speedup whatever the design; on n cards of their own the cap does
not exist. Each row therefore reports two things:

  * Wall clock at fixed TOTAL work: ``wall_ms`` is the best of ``reps``
    calls after a warm call (a fresh process's first calls take 0.2-5 s), each
    call started on every rank after a barrier and ended by
    ``utils/timing.sync``, timed by its slowest rank; ``speedup`` = T(1)/T(n),
    ``efficiency`` = T(1)/(n T(n)). Ranks sharing one card give no scaling
    figure.
  * ``work_per_device``, the counterpart of XLA's compiled per-device FLOP
    count, which PyTorch does not have: inside ``ops/kernels/_lib.counting_work``
    every kernel-function dispatcher adds its ``utils/roofline`` model at the
    call's shapes to a per-process tally, whichever backend runs it, with GN
    rounds at the config's budget and CG at its iteration count (the steps
    here run with tolerance 0), so the count depends on shapes alone and the CPU and
    the card count the same. A rank's work is the sum of its calls' least
    times on an H100 (``roofline.H100``); the row holds the largest over the
    ranks, with that rank's tensor-core FLOPs, FP32 operations and bytes.
    ``partition_efficiency`` = (work(1) / n) / work(n): 1.0 means each rank
    does exactly 1/n of the kernel work. This partition is the evidence that
    transfers to machines with a card a rank.

Not counted: the host bootstraps (the float64 8-point step), the torch
operations between kernel functions (chain products, map folds, the sparse
CG's O(F) vector algebra and the unpacked layout's landmark sums) and the
stitch. Repeated on every rank and counted: sp's plan, ``posegraph._plan``
(chunk 0's bootstrap check, one K1 pair; with ``slack > 0`` also the scoring
pass over all F - 1 pairs, which these measurements never run: ``slack=0``,
as in the JAX module). Each sp row gives that share as ``replicated_work``.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import default_device
from ..ops.kernels import _lib
from ..utils import synthetic
from ..utils.config import VOConfig
from ..utils.timing import sync
from . import mesh as mesh_mod

DP, SP, LM = "scaling_dp", "scaling_sp", "scaling_lm_sparse_ba"


def _host_cores() -> int:
    return os.cpu_count() or 1


def _dp_batch(seqs_total: int, frames: int, n_slots: int, first_seed: int = 1000):
    pts, apps, masks = [], [], []
    for s in range(seqs_total):
        rng = np.random.default_rng(first_seed + s)
        p, a, m = synthetic.generate_tracking_sequence(rng, frames, n_slots)
        pts.append(p)
        apps.append(a)
        masks.append(m)
    return np.stack(pts), np.stack(apps), np.stack(masks)


def _digest(t: torch.Tensor) -> str:
    t = t.detach().cpu().contiguous()
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def _measured(call, reps: int, meshes) -> dict:
    """This rank's warm call with the work tally reset before it, then ``reps``
    timed calls, each after a barrier: the tally, the times, the first
    output's digest (the trajectories, or the poses), the kernel launches of
    all the calls and the bytes the meshes staged meanwhile."""
    staged = sum(m.staged_bytes for m in meshes)
    _lib.reset_launches()
    with _lib.counting_work() as work:
        out = sync(call())
    tally = {k: list(v) for k, v in work.items()}
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        sync(call())
        times.append(time.perf_counter() - t0)
    return {"tally": tally, "times": times, "output_sha256": _digest(out),
            "launches": {k: v for k, v in _lib.launches.items() if v},
            "staged_bytes": sum(m.staged_bytes for m in meshes) - staged}


def _dp(meshes, n: int, seqs_total, frames, n_slots, gn_iterations, reps, first_seed=1000):
    from . import multiseq

    if seqs_total % n:
        return {"skipped": f"{seqs_total} sequences do not split over {n} ranks"}
    mesh = meshes[0]
    config = VOConfig(n_slots=n_slots, map_capacity=2 * n_slots, gn_iterations=gn_iterations)
    # Deep-frustum tracking camera: the monocular rescale puts synthetic
    # triangulations past z_far=5 and tracking degenerates to zero-inlier
    # no-ops (see synthetic.deep_camera) — the partition must run REAL work.
    camera = synthetic.deep_camera(device=mesh.device)
    batch = [torch.from_numpy(x).to(mesh.device)
             for x in _dp_batch(seqs_total, frames, n_slots, first_seed)]
    # n = 1 is the single-device program (no gather through the host).
    dp_mesh = mesh if n > 1 else None
    res = _measured(lambda: multiseq.run_sequences_batched(camera, config, *batch,
                                                           mesh=dp_mesh)[0], reps, meshes)
    res["frames"] = seqs_total * frames
    return res


def _sp(meshes, n: int, frames, n_slots, overlap, gn_iterations, reps):
    from . import posegraph

    mesh = meshes[0]
    config = VOConfig(n_slots=n_slots, map_capacity=2 * n_slots, gn_iterations=gn_iterations)
    camera = synthetic.deep_camera(device=mesh.device)
    rng = np.random.default_rng(7)
    pts, apps, masks = (torch.from_numpy(x).to(mesh.device)
                        for x in synthetic.generate_tracking_sequence(rng, frames, n_slots))
    plan = {}
    if n > 1:
        try:
            starts, chunk_len = posegraph.plan_chunks(frames, n, overlap, None, 0)
        except ValueError as e:
            return {"skipped": str(e)}   # the sequence is too short for n chunks
        plan = {"starts": list(starts), "chunk_len": chunk_len}

    def call():
        return posegraph.run_sequence_chunked(
            camera, config, pts, apps, masks, num_chunks=n, overlap=overlap, slack=0,
            mesh=mesh if n > 1 else None, sp_axis="dp")[0]

    try:
        res = _measured(call, reps, meshes)
    except posegraph.StitchError as e:
        # This (frames, n, overlap) point cannot stitch reliably (a boundary
        # with zero scale observations): an honest skip, not a measurement.
        # Every rank raises alike: the stitch runs on gathered values.
        return {"skipped": str(e)}
    replicated = 0.0
    if n > 1:
        ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
        with _lib.counting_work() as work:
            sync(posegraph._plan(config, pts, apps, masks, ids, False, n, overlap, 0)[2])
        replicated = sum(v[4] for v in work.values())
    res.update(plan, frames=frames, replicated_work=replicated)
    return res


def lm_block(n: int, rank: int, frames: int, num_landmarks: int, obs_per_lm: int,
             packed: bool, device):
    """Rank ``rank``'s block of the lm workload's problem over ``n`` ranks
    (``generate_ba_corridor``, seed 3): (K, the block as a SparseBAProblem
    with the whole pose set, the packed layout's landmark degree or None)."""
    from . import sparse_ba

    k, problem, _ = synthetic.generate_ba_corridor(f=frames, l=num_landmarks,
                                                   obs_per_lm=obs_per_lm, seed=3)
    obs = tuple(x.numpy() for x in (problem.frame_idx, problem.lm_idx, problem.uv,
                                    problem.obs_mask))
    if packed:
        *shards, l_per, degree = sparse_ba.partition_observations_packed(n, num_landmarks, *obs)
    else:
        *shards, l_per = sparse_ba.partition_observations(n, num_landmarks, *obs)
        degree = None
    lms = np.zeros((n * l_per, 3), np.float32)
    lms[:num_landmarks] = problem.landmarks.numpy()

    def block(x):   # matcher.shard_rows's block of an lm axis of n ranks
        rows = x.shape[0] // n
        return torch.from_numpy(x[rank * rows:(rank + 1) * rows]).to(device)

    return (torch.from_numpy(k).to(device),
            sparse_ba.SparseBAProblem(problem.poses.to(device), *map(block, (lms, *shards))),
            degree)


def _lm(meshes, n: int, frames, num_landmarks, obs_per_lm, cg_iterations, reps, packed=False):
    from . import sparse_ba

    mesh = meshes[1]
    kj, block, degree = lm_block(n, mesh.axis_index("lm"), frames, num_landmarks, obs_per_lm,
                                 packed, mesh.device)
    frame_plan = sparse_ba.plan_frames(block)   # once a run, as refine_sparse makes it
    # n = 1 is the unsharded step on the one block.
    psum_axis = (mesh, "lm") if n > 1 else None
    res = _measured(lambda: sparse_ba.sparse_ba_step(
        kj, block, damping=0.1, cg_iterations=cg_iterations, cg_tolerance=0.0,
        psum_axis=psum_axis, lm_degree=degree, frames=frame_plan)[0].poses, reps, meshes)
    res["frames"] = frames
    return res


_KINDS = {DP: _dp, SP: _sp, LM: _lm}


def small_call_tally(device) -> dict:
    """The work tally of one small call of each dispatcher the scaling
    workloads and the graft entry run, on ``device``: run_sequence at 12
    frames x 64 slots (K1-K4), a 32 x 4,096 top-1 (K7), a sparse BA step at
    16 poses x 2,000 landmarks with 4 CG iterations (K9, K10) and the graft
    entry's step (K1, K6). It depends on shapes alone, so a card's equals the
    CPU's."""
    from .. import graft_entry
    from ..models import pipeline
    from ..ops import matching
    from . import sparse_ba

    pts, apps, masks = (torch.from_numpy(x).to(device) for x in
                        synthetic.generate_tracking_sequence(np.random.default_rng(3), 12, 64))
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(-1, 1, (32, 10)).astype(np.float32)).to(device)
    db = torch.from_numpy(rng.uniform(-1, 1, (4096, 10)).astype(np.float32)).to(device)
    ones = torch.ones(4096, dtype=torch.bool, device=device)
    k, problem, _ = synthetic.generate_ba_corridor(f=16, l=2000, device=device)
    fn, args = graft_entry.entry(device=device)
    with _lib.counting_work() as work:
        pipeline.run_sequence(synthetic.deep_camera(device=device),
                              VOConfig(n_slots=64, map_capacity=256), pts, apps, masks)
        matching.best_match(q, ones[:32], db, ones)
        sparse_ba.sparse_ba_step(torch.from_numpy(k).to(device), problem, cg_iterations=4,
                                 cg_tolerance=0.0)
        fn(*args)
    return {name: list(v) for name, v in work.items()}


def _rank_measure(spec: dict) -> dict:
    """One rank of a measurement's world: every workload of ``spec`` whose
    ``ns`` holds this world's size, on a ``dp`` and an ``lm`` line over the
    whole world."""
    n = dist.get_world_size()
    meshes = (mesh_mod.single_axis_mesh(name="dp", device=spec["device"]),
              mesh_mod.single_axis_mesh(name="lm", device=spec["device"]))
    dev = meshes[0].device
    results = []
    for w in spec["workloads"]:
        kw = {k: v for k, v in w.items() if k not in ("metric", "workload", "ns")}
        if w.get("ns") is not None and n not in w["ns"]:
            results.append({"skipped": f"not measured at n = {n}"})
            continue
        results.append(_KINDS[w["metric"]](meshes, n, **kw))
    return {"results": results, "backend": meshes[0].backend,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}


def _row(metric, n, t, t1, total_frames, work, work1):
    row = {
        "metric": metric,
        "n_devices": n,
        "wall_ms": t * 1e3,
        "fps": total_frames / t,
        "host_cores": _host_cores(),
    }
    if t1 is not None:
        row["speedup"] = t1 / t
        row["efficiency"] = t1 / (n * t)
    row["work_per_device"] = work
    if work1:
        # 1.0 = per-rank kernel work is exactly total/n: no duplicated work.
        row["partition_efficiency"] = (work1 / n) / work
    return row


def _rows(workloads, worlds: dict) -> List[dict]:
    """One row per (workload, n) measured, in workload order, n ascending."""
    rows = []
    for i, w in enumerate(workloads):
        t1 = work1 = None
        for n in sorted(worlds):
            per_rank = [r["results"][i] for r in worlds[n]]
            if "skipped" in per_rank[0]:
                continue
            reps = len(per_rank[0]["times"])
            t = min(max(r["times"][k] for r in per_rank) for k in range(reps))
            by_rank = [sum(v[4] for v in r["tally"].values()) for r in per_rank]
            top = int(np.argmax(by_rank))
            if n == 1:
                t1, work1 = t, by_rank[0]
            row = _row(w["metric"], n, t, t1, per_rank[0]["frames"], by_rank[top], work1)
            counts = [sum(v[j] for v in per_rank[top]["tally"].values()) for j in (1, 2, 3)]
            row.update(tc_flops_per_device=counts[0], fp32_ops_per_device=counts[1],
                       hbm_bytes_per_device=counts[2], work_by_rank=by_rank,
                       tally_by_rank=[r["tally"] for r in per_rank],
                       output_sha256=per_rank[0]["output_sha256"],
                       launches_by_rank=[r["launches"] for r in per_rank],
                       staged_bytes=[r["staged_bytes"] for r in per_rank],
                       transport=worlds[n][0]["backend"], device=worlds[n][0]["device"],
                       world_seconds=worlds[n][0].get("world_seconds"))
            if w["metric"] in (DP, SP):
                # Every rank returns the whole result (parallel/mesh, point 4).
                row["ranks_agree"] = all(r["output_sha256"] == row["output_sha256"]
                                         for r in per_rank)
            if w["metric"] == SP:
                row["replicated_work"] = per_rank[0]["replicated_work"]
                if n > 1:
                    row.update(starts=per_rank[0]["starts"], chunk_len=per_rank[0]["chunk_len"])
            if w.get("workload") is not None:
                row["workload"] = w["workload"]
            rows.append(row)
    return rows


def workload(metric: str, **kw) -> dict:
    """A workload of :func:`measure_workloads`: the arguments of ``metric``'s
    ``measure_*_scaling`` at their defaults, updated by ``kw`` (which may also
    give ``workload``, a label, and ``ns``)."""
    params = inspect.signature(_MEASURES[metric]).parameters
    w = {k: p.default for k, p in params.items() if k not in ("ns", "device")}
    unknown = set(kw) - set(w) - {"workload", "ns"}
    if unknown:
        raise TypeError(f"{metric} takes no argument {sorted(unknown)}")
    return {"metric": metric, **w, **kw}


def run_worlds(ns: Sequence[int], spec: dict, rank_fn=None) -> dict:
    """``{n: every rank's rank_fn(spec)}``, one world per n of ``ns`` started by
    ``mesh.run_local`` on ``spec["device"]`` (``rank_fn`` defaults to this
    module's rank of a measurement; another must be a module-level function).
    Rank 0's result gains ``world_seconds``, the start and join included."""
    backend = ("nccl" if spec["device"] == "cuda" and max(ns) <= torch.cuda.device_count()
               else "gloo")
    worlds = {}
    for n in ns:
        t0 = time.perf_counter()
        worlds[n] = mesh_mod.run_local(rank_fn or _rank_measure, n, spec, backend=backend,
                                       device=spec["device"])
        worlds[n][0]["world_seconds"] = time.perf_counter() - t0
    return worlds


def measure_workloads(ns: Optional[Sequence[int]], workloads: Sequence[dict],
                      device=None) -> List[dict]:
    """Rows of every workload, one world per n of ``ns`` (:func:`run_worlds`).

    A workload is a dict: ``metric`` (``"scaling_dp"``, ``"scaling_sp"`` or
    ``"scaling_lm_sparse_ba"``), every argument of its ``measure_*_scaling``
    but ``ns`` and ``device``, and optionally ``workload`` (a label the rows
    carry) and ``ns`` (the world sizes it is measured at). Inside an
    initialised world ``ns`` must be None or that world's size. ``device``:
    the card by default (raises without one), ``"cpu"`` for CPU ranks."""
    dev = default_device() if device is None else torch.device(device)
    spec = {"device": dev.type, "workloads": list(workloads)}
    if dist.is_initialized():
        world = dist.get_world_size()
        if ns is not None and list(ns) != [world]:
            raise ValueError(f"inside a world of {world} ranks only n = {world} is measured, "
                             f"got ns={list(ns)}")
        gathered = [None] * world
        dist.all_gather_object(gathered, _rank_measure(spec))
        return _rows(workloads, {world: gathered})
    return _rows(workloads, run_worlds(ns, spec))


def measure_dp_scaling(ns: Optional[Sequence[int]], seqs_total: int = 8, frames: int = 24,
                       n_slots: int = 256, gn_iterations: int = 100, reps: int = 3,
                       first_seed: int = 1000, device=None) -> List[dict]:
    """Strong-scaling rows for the dp multi-sequence tracker: ``seqs_total``
    sequences of ``generate_tracking_sequence(default_rng(first_seed + s),
    frames, n_slots)``; an n that does not divide ``seqs_total`` is skipped."""
    return measure_workloads(ns, [workload(
        DP, seqs_total=seqs_total, frames=frames, n_slots=n_slots, gn_iterations=gn_iterations,
        reps=reps, first_seed=first_seed)], device)


def measure_sp_scaling(ns: Optional[Sequence[int]], frames: int = 64, n_slots: int = 64,
                       overlap: int = 6, gn_iterations: int = 50, reps: int = 3,
                       device=None) -> List[dict]:
    """Strong-scaling rows for the chunked (sequence-parallel) tracker. Its
    partition efficiency is honestly < 1: every chunk re-tracks its
    ``overlap`` shared frames (bounded redundancy (F/n + overlap) / (F/n),
    NOT duplication of the whole sequence). A (frames, n) the plan cannot
    split, or whose stitch has a boundary without scale samples, is skipped."""
    return measure_workloads(ns, [workload(
        SP, frames=frames, n_slots=n_slots, overlap=overlap, gn_iterations=gn_iterations,
        reps=reps)], device)


def measure_lm_scaling(ns: Optional[Sequence[int]], frames: int = 48, num_landmarks: int = 4096,
                       obs_per_lm: int = 6, cg_iterations: int = 16, reps: int = 2,
                       packed: bool = False, device=None) -> List[dict]:
    """Strong-scaling rows for the landmark-sharded sparse Schur-CG BA: one
    fixed corridor problem (``synthetic.generate_ba_corridor``, seed 3), its
    landmarks and observations in n blocks (``partition_observations``, or
    with ``packed`` ``partition_observations_packed``), one LM step of
    ``cg_iterations`` CG iterations. Landmarks partition exactly; the
    replicated work is the O(F) pose-space CG algebra (not counted) and the
    (F, R) sums each rank writes, so partition efficiency stays near 1 while
    N >> F."""
    return measure_workloads(ns, [workload(
        LM, frames=frames, num_landmarks=num_landmarks, obs_per_lm=obs_per_lm,
        cg_iterations=cg_iterations, reps=reps, packed=packed)], device)


def measure_scaling(ns: Optional[Sequence[int]] = None, reps: int = 3, device=None,
                    **kw) -> List[dict]:
    """All scaling rows (dp + sp) in one world per n (default 1, 2, 4: ranks
    may share a card); see the module docstring."""
    if ns is None and not dist.is_initialized():
        ns = (1, 2, 4)
    dp_kw = {k: v for k, v in kw.items() if k in (
        "seqs_total", "frames", "n_slots", "gn_iterations")}
    sp_kw = {k: v for k, v in kw.items() if k in (
        "frames", "n_slots", "overlap", "gn_iterations")}
    return measure_workloads(ns, [workload(DP, reps=reps, **dp_kw),
                                  workload(SP, reps=reps, **sp_kw)], device)


_MEASURES = {DP: measure_dp_scaling, SP: measure_sp_scaling, LM: measure_lm_scaling}
