"""Entry points: one tracking step, the kernels' self-check and the
multi-device dry run (port of the JAX repository's root ``__graft_entry__``).

Every entry point runs on the card by default and raises without one;
``device="cpu"`` runs the plain versions of the kernels on the CPU.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import default_device
from .parallel import scaling


def _require(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _field(rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` landmarks in front of the synthetic cameras (the JAX dry run's draws)."""
    return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                     rng.uniform(2.0, 4.0, n)], axis=1).astype(np.float32)


def _pose(v) -> torch.Tensor:
    from .ops import se3

    return se3.v2t_euler(torch.from_numpy(np.float32(v)))


def _synthetic_state(n_slots: int = 128, map_capacity: int = 256, seed: int = 0, device=None):
    """A tiny but fully-populated tracking state on synthetic data: (camera,
    config, the state after the two-view bootstrap on frames 0 and 1, frame
    2), from the same numpy draws as the JAX entry's."""
    from .models import pipeline
    from .ops.camera import project_points
    from .utils import synthetic
    from .utils.config import VOConfig

    dev = _device(device)
    rng = np.random.default_rng(seed)
    cfg = VOConfig(n_slots=n_slots, map_capacity=map_capacity)
    camera = synthetic.default_camera(device=dev)
    world = torch.from_numpy(_field(rng, n_slots)).to(dev)
    apps = torch.from_numpy(synthetic.generate_appearances(rng, n_slots)).to(dev)

    def frame(i):
        pose = _pose([0.02 * i, -0.01 * i, 0.05 * i, 0.004 * i, -0.004 * i, 0.002 * i])
        uv, valid = project_points(synthetic.default_camera(pose, device=dev), world)
        return pipeline.FrameData(points=uv, appearances=apps, mask=valid,
                                  ids=torch.arange(n_slots, dtype=torch.int32, device=dev))

    state, _ = pipeline.initialize(camera, cfg, frame(0), frame(1))
    return camera, cfg, state, frame(2)


def tracking_state(n_slots: int = 128, seed: int = 5, device=None):
    """A state whose next step tracks inliers, in :func:`_synthetic_state`'s
    form: ``generate_tracking_sequence``'s frames 0-2 seen by the deep-frustum
    camera (the entry's default camera puts the bootstrap's rescaled map past
    its z_far, so the entry's own step tracks no inlier)."""
    from .models import pipeline
    from .utils import synthetic
    from .utils.config import VOConfig

    dev = _device(device)
    pts, apps, masks = (torch.from_numpy(x).to(dev) for x in synthetic.generate_tracking_sequence(
        np.random.default_rng(seed), 3, n_slots))
    ids = torch.arange(n_slots, dtype=torch.int32, device=dev)
    frames = [pipeline.FrameData(pts[i], apps[i], masks[i], ids) for i in range(3)]
    camera = synthetic.deep_camera(device=dev)
    cfg = VOConfig(n_slots=n_slots, map_capacity=2 * n_slots)
    state, _ = pipeline.initialize(camera, cfg, frames[0], frames[1])
    return camera, cfg, state, frames[2]


def step_fn(camera, cfg):
    """``fn(state, frame)``: ``pipeline.frame_step`` giving (pose, tri_points,
    num_inliers)."""
    from .models import pipeline

    def fn(state, frame):
        new_state, out = pipeline.frame_step(camera, cfg, state, frame)
        return out.pose, new_state.tri_points, out.num_inliers

    return fn


def selfcheck(device=None):
    """Kernel-vs-plain equality on the card: every kernel side of the JAX
    package's eight backend-equality checks against a reference that does not
    go through it (``utils/selfcheck.run_all``); returns the observed diffs
    and raises ``AssertionError`` on a mismatch."""
    from .utils import selfcheck as sc

    return sc.run_all(device)


def entry(device=None):
    """``(fn, example_args)``: one tracking step of the flagship model.

    ``fn(state, frame)`` is the full per-frame program of the vo_complete
    pipeline (``models/pipeline.frame_step``: appearance matching, K1;
    correspondence join; the PICP Gauss-Newton solve, K6 on the card;
    mid-point triangulation; landmark-map merge) and returns (pose,
    tri_points, num_inliers)."""
    camera, cfg, state, frame = _synthetic_state(device=device)
    return step_fn(camera, cfg), (state, frame)


# --------------------------------------------------------------------------
# The multi-device dry run
# --------------------------------------------------------------------------


def _sharded_checks_rank(device: str) -> dict:
    """One rank of the dry run's world: the JAX dry run's five sharded checks
    at its shapes, each asserted. The (dp, lm) mesh takes dp = 2 when the
    world size is even. Meshes span the whole world here, where JAX takes
    sub-meshes of the first devices: the sparse step runs over an ``lm`` line
    of every rank, and dp serving over the (dp, lm) mesh's ``dp`` axis."""
    import torch.distributed as dist

    from .ops.camera import project_points
    from .ops.kernels import _lib
    from .parallel import bundle_adjustment as ba
    from .parallel import matcher, multiseq, posegraph
    from .parallel import mesh as mesh_mod
    from .parallel import sparse_ba as sba
    from .utils import synthetic
    from .utils.config import VOConfig

    n = dist.get_world_size()
    dp = 2 if n % 2 == 0 and n > 1 else 1
    lm = n // dp
    mesh = mesh_mod.make_mesh(dp_size=dp, device=device)
    line = mesh_mod.single_axis_mesh(name="lm", device=device)
    dev = mesh.device
    out = {}
    _lib.reset_launches()

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    # --- a tiny BA problem, batched over the dp sequences ---
    rng = np.random.default_rng(0)
    f, l = 3, 8 * lm
    world = _field(rng, l)
    poses, obs, mask = [], [], []
    for i in range(f):
        pose = _pose([0.05 * i, -0.02 * i, 0.08 * i, 0.01 * i, -0.01 * i, 0.005 * i])
        uv, valid = project_points(synthetic.default_camera(pose), torch.from_numpy(world))
        poses.append(pose.numpy())
        obs.append(uv.numpy())
        mask.append(valid.numpy())
    poses, obs, mask = np.stack(poses), np.stack(obs), np.stack(mask)
    noisy = (world + rng.uniform(-0.05, 0.05, world.shape)).astype(np.float32)
    camera = synthetic.default_camera(device=dev)
    j, cols = mesh.axis_index("lm"), l // lm
    block = slice(j * cols, (j + 1) * cols)
    # This rank's block: its dp row of the batch (one sequence), its lm columns.
    problem = ba.BAProblem(on(poses[None]), on(noisy[None, block]), on(obs[None, :, block]),
                           on(mask[None, :, block]))
    refined, stats = ba.make_sharded_ba_step(mesh, damping=0.1)(camera.camera_matrix, problem)
    _require(bool(torch.isfinite(refined.poses).all()), "dense BA: non-finite poses")
    _require(bool(torch.isfinite(refined.landmarks).all()), "dense BA: non-finite landmarks")
    _require(int(stats.num_obs[0]) > 0, "dense BA: no observations")
    out["dense_ba_num_obs"] = int(stats.num_obs[0])

    # --- sparse (COO) BA, landmarks and observations sharded over lm ---
    fi_full, li_full = np.nonzero(mask)
    fi_s, li_s, uv_s, mask_s, l_per = sba.partition_observations(
        n, l, fi_full.astype(np.int32), li_full.astype(np.int32),
        obs[fi_full, li_full].astype(np.float32), np.ones(len(fi_full), bool))
    lms = np.zeros((n * l_per, 3), np.float32)
    lms[:l] = (world + rng.uniform(-0.05, 0.05, world.shape)).astype(np.float32)
    sp_problem = sba.SparseBAProblem(on(poses), *(
        matcher.shard_rows(line, torch.from_numpy(x)) for x in (lms, fi_s, li_s, uv_s, mask_s)))
    sp_out, sp_stats = sba.make_sharded_sparse_ba_step(line, damping=0.1, cg_iterations=32)(
        camera.camera_matrix, sp_problem)
    _require(bool(torch.isfinite(sp_out.poses).all()), "sparse BA: non-finite poses")
    _require(bool(torch.isfinite(sp_out.landmarks).all()), "sparse BA: non-finite landmarks")
    _require(int(sp_stats.num_obs) > 0, "sparse BA: no observations")
    out["sparse_ba_num_obs"] = int(sp_stats.num_obs)

    # --- the sharded matcher over the lm axis ---
    db = synthetic.generate_appearances(rng, 16 * lm * dp)
    idx, _ = matcher.sharded_best_match(
        mesh, matcher.shard_rows(mesh, torch.from_numpy(db)),
        matcher.shard_rows(mesh, torch.ones(len(db), dtype=torch.bool)), on(db[:8]),
        torch.ones(8, dtype=torch.bool, device=dev), axis="lm")
    _require(torch.equal(idx.cpu(), torch.arange(8, dtype=idx.dtype)), idx)
    out["matcher_idx"] = idx.cpu().tolist()

    # --- sequence parallelism: chunked tracking sharded over dp ---
    n_slots, n_frames = 32, 14
    world_s = _field(rng, n_slots)
    apps_s = synthetic.generate_appearances(rng, n_slots)
    seq_pts, seq_mask = [], []
    for i in range(n_frames):
        pose = _pose([0.06 * i, -0.02 * i, 0.09 * i, 0.006 * i, -0.006 * i, 0.003 * i])
        uv, valid = project_points(synthetic.default_camera(pose), torch.from_numpy(world_s))
        seq_pts.append(uv.numpy())
        seq_mask.append(valid.numpy())
    seq_pts, seq_mask = np.stack(seq_pts), np.stack(seq_mask)
    seq_apps = np.tile(apps_s[None], (n_frames, 1, 1))
    cfg = VOConfig(n_slots=n_slots, map_capacity=64, gn_iterations=10)
    deep = synthetic.deep_camera(device=dev)
    traj, _, diags = posegraph.run_sequence_chunked(
        deep, cfg, on(seq_pts), on(seq_apps), on(seq_mask), num_chunks=dp, overlap=4, slack=0,
        mesh=mesh, sp_axis="dp")
    _require(tuple(traj.shape) == (n_frames, 4, 4) and bool(torch.isfinite(traj).all()), traj.shape)
    _require(bool(torch.isfinite(diags.scales).all()), diags.scales)
    out["sp_trajectory"] = traj.cpu()

    # --- batched serving sharded over dp ---
    b_serv = 2 * dp
    serv_traj, _, _ = multiseq.run_sequences_batched(
        deep, cfg, on(np.tile(seq_pts[None], (b_serv, 1, 1, 1))),
        on(np.tile(seq_apps[None], (b_serv, 1, 1, 1))), on(np.tile(seq_mask[None], (b_serv, 1, 1))),
        mesh=mesh)
    _require(tuple(serv_traj.shape) == (b_serv, n_frames, 4, 4), serv_traj.shape)
    _require(bool(torch.isfinite(serv_traj).all()), "dp serving: non-finite poses")
    out["dp_trajectories"] = serv_traj.cpu()
    out["mesh"] = (dp, lm)
    out["launches"] = {k: v for k, v in _lib.launches.items() if v}
    return out


def _dryrun_rank(spec: dict) -> dict:
    """One rank of a dry-run world: in the world of ``spec["checks_at"]``
    ranks the five sharded checks first, then the scaling workloads measured
    at this world's size."""
    import torch.distributed as dist

    checks = (_sharded_checks_rank(spec["device"])
              if dist.get_world_size() == spec["checks_at"] else None)
    return dict(scaling._rank_measure(spec), checks=checks)


def scaling_workloads(n_max: int) -> List[dict]:
    """The JAX dry run's scaling rows: toy dp and sp; production-length sp (F
    = 1024, S = 128, overlap 10, 10 GN rounds), where the fixed overlap and
    bootstrap amortize and the >= 80% north star is meant to hold; long sp
    (F = 2048) at n = 1 and ``n_max``; sparse BA over lm at its defaults."""
    return [
        scaling.workload(scaling.DP, seqs_total=8, frames=12, n_slots=32, gn_iterations=10,
                         reps=2, workload="toy"),
        scaling.workload(scaling.SP, frames=48, n_slots=32, overlap=4, gn_iterations=10, reps=2,
                         workload="toy"),
        scaling.workload(scaling.SP, frames=1024, n_slots=128, overlap=10, gn_iterations=10,
                         reps=1, workload="production_length"),
        scaling.workload(scaling.SP, frames=2048, n_slots=128, overlap=10, gn_iterations=10,
                         reps=1, workload="long_sequence", ns=(1, n_max)),
        scaling.workload(scaling.LM, workload="sparse_ba"),
    ]


def check_scaling_rows(rows: Sequence[dict], n_max: int) -> None:
    """The JAX dry run's assertions: dp partition efficiency >= 0.9 at n > 1;
    production-length sp >= 0.85; long-sequence sp at ``n_max`` no worse than
    production length there; sparse BA over lm >= 0.9."""
    dp_rows = [r for r in rows if r["metric"] == scaling.DP and r["n_devices"] > 1]
    _require(dp_rows, "scaling measurement produced no multi-device dp rows")
    for r in dp_rows:
        _require(r["partition_efficiency"] >= 0.9, r)
    sp_prod = [r for r in rows if r["metric"] == scaling.SP
               and r.get("workload") == "production_length" and r["n_devices"] > 1]
    _require(sp_prod, "no production-length multi-device sp rows")
    for r in sp_prod:
        _require(r["partition_efficiency"] >= 0.85, r)
    sp_long = [r for r in rows if r["metric"] == scaling.SP
               and r.get("workload") == "long_sequence" and r["n_devices"] == n_max]
    _require(sp_long, "no long-sequence sp row")
    prod_at_max = [r for r in sp_prod if r["n_devices"] == n_max]
    for r in sp_long:
        # Overlap amortization: longer chunks must not scale WORSE.
        _require(r["partition_efficiency"] >= prod_at_max[0]["partition_efficiency"], (
            r, prod_at_max[0]))
    lm_multi = [r for r in rows if r["metric"] == scaling.LM and r["n_devices"] > 1]
    _require(lm_multi, "no multi-device sparse-BA lm rows")
    for r in lm_multi:
        _require(r["partition_efficiency"] >= 0.9, r)


def dryrun_multichip(n_devices: int, device=None,
                     workloads: Optional[Sequence[dict]] = None) -> Tuple[List[dict], List[dict]]:
    """The multi-device dry run: the scaling rows (``parallel/scaling``, one
    world per n in 1, 2, 4, 8 up to ``n_devices``, gloo where the ranks
    outnumber the cards) of ``workloads`` (default :func:`scaling_workloads`),
    the world of ``n_devices`` ranks running the JAX dry run's five sharded
    checks first (dense BA over a (dp, lm) mesh, sparse BA over an lm line,
    the sharded matcher, sp chunking and dp serving) (a world of its own when ``n_devices`` is not among those
    n); each row printed as one JSON line without its per-rank tallies, then
    :func:`check_scaling_rows`. Returns (each rank's check outputs, the rows).
    Ranks may outnumber the cards: they share them."""
    dev = _device(device)
    ns = [n for n in (1, 2, 4, 8) if n <= n_devices]
    ws = [dict(w, ns=w.get("ns") or tuple(ns))
          for w in (workloads or scaling_workloads(max(ns)))]
    worlds = scaling.run_worlds(sorted(set(ns) | {n_devices}),
                                {"device": dev.type, "workloads": ws, "checks_at": n_devices},
                                _dryrun_rank)
    checks = [r["checks"] for r in worlds[n_devices]]
    rows = scaling._rows(ws, worlds)
    for row in rows:
        print(json.dumps({k: v for k, v in row.items() if k != "tally_by_rank"}))
    check_scaling_rows(rows, max(ns))
    return checks, rows
