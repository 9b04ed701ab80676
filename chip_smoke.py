#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (visual_odometry_tpu_torch) end to end on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:
  1. environment: torch, CUDA, the card, nvcc, nvidia-smi name and power limit;
  2. build: compile csrc/*.cu with nvcc into build/vo_torch_kernels/;
  3. each kernel against its plain PyTorch version on the card, with
     CUDA-event times and its bound on this card: K1 pair matcher (path B's
     510 pairs and its bootstrap pair, timed both, and ties across its tiles,
     all-masked frames and NaN garbage at N = 1024 and ragged N), K2 join
     candidates (path B's, and targets outside [0, S) at depths 1, 2 and 4,
     S = 1024 and 128), K3 record gather (path B's two pixel gathers and its
     appearance gather, also with indices past S), K4 fused frame loop and
     K5 its planar form on the main path's own inputs (S = 1024 slots x 512 frames; the plain K4/K5
     are Python loops: K4 is compared over the first 256 tracked frames, K5
     over the first 128; path B holds K4 to the plain run at full depth), K6 standalone solves (SE(3) and planar) at N = 1024 and 8192,
     K7 map-scale matcher (exact and fast) at Q = 1024, K = 2^20 with masked
     rows holding NaN, and on synthetic.generate_match_ties' and
     generate_exact_match_ties' data (each mode's rescored pairs a query
     counted on all three); K5's inputs are path D's; K8 batched frame loop at
     N = 64 sequences x 128 slots x 126 tracked frames, SE(3) and planar, per
     sequence against K4/K5 launched alone and its first sequence against
     the plain version over all 126 frames; K9 segment sum and K10 table gather at the sparse-BA
     corridor's shapes (N ~ 6e5, T = 512, R = 36 / 6 and 12 / 6) beside
     index_add_ and index_select (K9 over one plan of the frame ids, two
     launches bit for bit alike and equal to the plain version; K10 in the
     layouts a step uses, the table read in place through its strides); one
     sparse-BA step at 1,536 poses on the card against the CPU's; K8 also at
     path H's shapes (4 chunks of path B's sequence, 142 tracked frames x 1,024
     slots, a cluster of 4 CTAs a chunk), each chunk bit for bit against K4
     launched alone; K3 and K10 rows and their library calls
     carry device_ms (profiler) and host_ms (host clock, no sync) beside
     ms; K6 and K11 rows carry them too, with their launch geometry, GN
     rounds and device us a round (K6), and the launch floor (a one-float
     fill's times) beside the bound;
     K11 linearization at N = 1024 and 8192, twice bit for bit alike; P1
     (eight_point, port-only: the JAX package's XLA eight-point step and
     the rest of its bootstrap) at path E's 64 pairs x 128 correspondences,
     path B's pair x 1,024 and path H's 4 chunk pairs, both instances (the
     pose alone, and the whole bootstrap the main path launches: pose,
     triangulation, seeded maps, lookups, histories) bit for bit against
     their plain versions on every output and twice alike, batch-invariant
     at B = 1, 16, 32 and 64 with pipeline.initialize_batched and the
     batched merge_stream, beside the stacked torch.linalg form of the pose
     (its library time); P2 (map_fold, port-only: the JAX package's XLA
     fold) at the benchmark cells' streams (1 x 15,360 and 64 x 15,360 rows
     at capacity 1,024, 1 x 523,264 at 2,048) bit for bit against the plain
     fold on every output and twice alike, timed beside it; every
     row's bound_ms and bound_by come from a utils/roofline work model at
     the row's shapes (and GN rounds) against this card's spec;
  3b. utils/selfcheck.run_all's eight checks on the card, each with its
     kernels' launches ({"selfcheck": ...}), then utils/roofline.measure()
     (K7 exact, K6 at 100 rounds, K4 at 10 rounds a frame) and
     measure_sparse_ba() (one packed LM step at 512 poses x 100,000
     landmarks, 64 CG iterations) with the card's spec and launch floor
     ({"roofline": ...}); every roofline fraction and mfu in (0, 1];
  4. path A: the reference-format applications — generate_dataset (40 frames,
     400 landmarks), apps.run_vo_complete (also with num_chunks=2), run_vo_se2,
     run_vo_da_known and
     run_relocalize (both matcher precisions) on cuda, apps.run_evaluation —
     held to the accuracy bounds of tests/test_dataset_gen.py, the planar
     subgroup bound and the relocalization bounds of tests/test_relocalize.py,
     and every K7 call run_relocalize makes (3 in each precision, 128
     queries against the 1,024-row map) held bit for bit, indices and
     distances, to best_match_plain on the same card tensors;
     then the reference's remaining programs, each with the counters zeroed
     before it and read after it: run_real_init, run_picp_known_real (K6
     once a frame; scale and RMSE within 1e-3, tests/test_apps.py:25-37),
     run_compute_corr (K1; the appearance pairs equal the id pairs) and
     run_read_data_test on the dataset; run_init_synthetic,
     run_picp_synthetic (K6, 1,000 rounds), run_whole_synthetic (K6) and
     run_kdtree_test (K9 for the tree's node sums) at the JAX package's
     default sizes and guards. Every K6 solve these apps make is run again
     through its plain version on the same card tensors (poses within
     GN_POSE_TOL, equal inlier counts), and kdtree_test's tree is built again
     on the CPU with K9's plain version (the same leaves, the same
     best_match_fast answers). The native loader is held bit for bit to the
     numpy one on the dataset and on a 121-frame x 1,000-landmark one, both
     parse times printed. The figures (utils/plots) run no kernel and need
     matplotlib, which the card's machine lacks: tests/test_torch_plots.py
     holds them on the CPU;
  5. path B: pipeline.run_sequence at 1024 slots x 512 frames, held against
     the same run through the plain versions, and its frames/s; its map fold
     (one P2 launch) bit for bit against the plain fold, as on paths D, E
     and H (each map's SHA-256 printed);
  6. path C: map-scale relocalization, pipeline.relocalize_frame of 1024
     queries against a map of 2^20 landmarks in both matcher precisions, and
     the standalone planar solve at N = 8192;
  7. path D: the planar estimation group at 1024 slots x 512 frames, on path
     B's landmark field and orbit seen by a planar robot;
  8. resume: path B's inputs split at frame 256 through continue_sequence with
     a checkpoint round trip, held against one shot;
  9. step form: the first 18 frames of path B through scan_backend="step"
     (one K6 launch a tracked frame), held against the fused launch;
  9b. path H: chunked tracking, parallel.posegraph.run_sequence_chunked on
     path B's inputs as 4 chunks (overlap 10, the default slack; K1 three
     times, one K2, three K3, one K8 over the chunks, no K4, one P1 and one
     merge_stream call), held bit for bit
     against its loop form (the same plan and stitch, K4 once a chunk) and
     against path B's
     trajectory (mean |e_theta| < 1e-4, translation ratios within 5% of their
     median), and its frames/s beside path B's.
  10. path E: serving, parallel.multiseq.run_sequences_batched over 64
     sequences x 128 frames x 128 slots (landmark fields 100-163, none left
     out; K1-K3 once a stage over the flattened batch, K8 once, P1 and
     merge_stream once), each sequence
     held against its own run_sequence and to a full set of inliers in every
     frame, and a planar batch of 8;
  11. path F: refinement — (1) path A's dataset through run_vo_complete with
     refine_iterations=5, sparse and dense, and run_evaluation; (2) sparse
     bundle adjustment at 512 poses x 100,000 landmarks, 3 LM steps of 64 CG
     iterations, packed and unpacked, with the K9/K10 launch counts reckoned
     from the code path;
  12. path G: K11 through its public entry point at N = 8192 beside
     ops.picp.linearize;
  13. path I: the multi-device forms (parallel/mesh) through their entry
     points, in a world of one NCCL rank (every mesh 1 x 1) and then in a
     world of 4 ranks sharing the card over gloo (their collectives staged
     through the host), started by parallel.mesh.run_local: the sharded
     matcher (path C's 1,024 queries x 2^20 rows, 4 x 2^18 in the shared
     world, and tests/test_parallel_matcher.py's cross-block cases), dp
     serving (path E's 64 sequences, 16 a rank; 8 in the world of one), sp
     chunking (path H's 4 chunks, one a rank) and the world of one's
     sparse-BA step, each bit for bit against its unsharded call on the
     card; sparse BA over 4 lm ranks (path F(2)'s problem, packed, 3 LM
     steps x 64 CG; chi falls; the first step at compare_wide_sparse_ba's
     tolerances against the unsharded step) and dense BA over a (2, 2) mesh
     (path A's dataset, a batch of 2 copies; 2e-3, chi 1e-3 relative,
     tests/test_bundle_adjustment.py). Every rank launches the kernels of
     the work it owns (K7; K1-K3 and K8; K9 and K10 in the reckoned
     counts); {"path_i": ...} gives each check's wall time a rank, the
     transport and the bytes staged. Four processes on one card: no scaling
     figure.
  14. path J: parallel/scaling and the graft entry (graft_entry.py).
     graft_entry.dryrun_multichip(4) with path J's workloads: one world of
     gloo ranks sharing the card per n in (1, 2, 4) (the world of 4 runs the
     JAX dry run's five sharded checks first), each running dp at path E's
     shapes, sp at production length (F = 1,024, S = 128, overlap 10;
     F = 2,048 at n = 1 and 4) and sparse BA over lm at path F(2)'s shapes
     (one packed step, 64 CG), with the dry run's thresholds on each row's
     partition efficiency (the per-rank work tally of parallel/scaling) at
     n = 4; dp at n > 1 bit for bit with n = 1, sp with the unsharded chunked
     call of its plan; the tally of small calls on the card equal to the
     CPU's; graft_entry.entry()'s step on the card against the CPU's on the
     same state (GN_POSE_TOL, equal inliers) and graft_entry.selfcheck().
     {"path_j": ...} holds the rows (wall times of ranks sharing one card:
     no scaling figure), each world's seconds and staged bytes.
``python3 chip_smoke.py --stages`` instead runs the entry points of paths B, C,
D, E and H and one sparse-BA step of path F(2) in each layout and prints,
for one call of each, the host waits the pipeline counts by site
(``profiling.host_waits``), then under torch.profiler the kernel times, the
device-busy share and each ``vo/`` stage's host time by PyTorch operator and
CUDA runtime call; no result line.

The launch counters are zeroed right before each path and read right after;
every kernel of a path must have launched in it. The last lines are the
card's name and power limit, the kernel table ({"kernels": [...]}) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
_CSRC = "visual_odometry_tpu_torch/csrc/"
_PALLAS = "visual_odometry_tpu/ops/pallas/"
KERNELS = {
    # launch-counter name: (source, TPU kernel it replaces, the path that holds its `launches`)
    "match_pairs": (_CSRC + "match_pairs.cu", _PALLAS + "matcher_kernel.py:302", "B"),
    "join_candidates": (_CSRC + "join_candidates.cu", _PALLAS + "frame_kernel.py:134", "B"),
    "gather_rows": (_CSRC + "gather_rows.cu", _PALLAS + "gather_kernel.py:45", "B"),
    "track_frames": (_CSRC + "track_frames.cu", _PALLAS + "frame_kernel.py:952", "B"),
    "track_frames_planar": (_CSRC + "track_frames.cu", _PALLAS + "picp_kernel.py:617", "D"),
    "picp_solve": (_CSRC + "picp_solve.cu", _PALLAS + "picp_kernel.py:965", "C"),
    "picp_solve_se2": (_CSRC + "picp_solve.cu", _PALLAS + "picp_kernel.py:1065", "C"),
    "best_match": (_CSRC + "best_match.cu", _PALLAS + "matcher_kernel.py:136", "C"),
    "best_match_fast": (_CSRC + "best_match.cu", _PALLAS + "matcher_kernel.py:136", "C"),
    "track_frames_batched": (_CSRC + "track_frames.cu", _PALLAS + "frame_kernel.py:780", "E"),
    "track_frames_batched_planar": (_CSRC + "track_frames.cu", _PALLAS + "picp_kernel.py:776",
                                    "E"),
    "segment_sum": (_CSRC + "segment_sum.cu", _PALLAS + "segsum_kernel.py:54", "F"),
    "take_table": (_CSRC + "take_table.cu", _PALLAS + "gather_kernel.py:129", "F"),
    "picp_linearize": (_CSRC + "picp_linearize.cu", _PALLAS + "picp_kernel.py:141", "G"),
    # P1, port-only: the JAX package computes the eight-point pose with XLA (no pallas_call).
    "eight_point": (_CSRC + "eight_point.cu", "visual_odometry_tpu/ops/epipolar.py:287", "E"),
    # P2, port-only: the JAX package folds the map with two XLA sorts (no pallas_call).
    "map_fold": (_CSRC + "map_fold.cu", "visual_odometry_tpu/models/landmark_map.py:103", "B"),
}
PORT_ONLY = ("eight_point", "map_fold")
MAIN_PATH = ("match_pairs", "join_candidates", "gather_rows", "track_frames")
K3_PATH_LAUNCHES = 3   # a tracked sequence gathers previous pixels, current pixels, appearances
# Path A's applications run K1-K7 except the standalone planar solve.
PATH_A = MAIN_PATH + ("track_frames_planar", "picp_solve", "best_match", "best_match_fast")
K4_POSE_TOL = 2e-3   # the repo's fused-vs-scan trajectory tolerance (tests/test_pipeline.py:331)
K1_DIST_RTOL = 1e-5
GN_POSE_TOL = 1e-5   # K5/K6 against their plain versions (bitwise expected)
PLANAR_DEV_TOL = 1e-4
K4_PLAIN_FRAMES, K5_PLAIN_FRAMES = 256, 128
K9_RTOL, K9_ATOL = 2e-5, 1e-4    # K9 against index_add_, another order (tests/test_pallas_kernels.py:266)
K11_RTOL = 1e-5                  # of the system's largest entry (bitwise expected)
SERVE_B, SERVE_FRAMES, SERVE_SLOTS = 64, 128, 128
CHUNKS, CHUNK_OVERLAP = 4, 10    # path H: path B's sequence as 4 chunks
# Path H's launches: K1 for the bootstrap scores, the chunks' bootstrap pairs and
# their flattened pairs; one K2; three K3; one K8 over the chunks; no K4; one P1
# for the chunks' bootstraps; one P2 for the stitched map.
PATH_H = {"match_pairs": 3, "join_candidates": 1, "gather_rows": K3_PATH_LAUNCHES,
          "track_frames_batched": 1, "track_frames": 0, "eight_point": 1, "map_fold": 1}
CHUNK_RATIO_TOL = 0.05   # each frame's translation ratio to serial path B, about their median
BA_POSES, BA_LANDMARKS, BA_STEPS, BA_CG = 512, 100_000, 3, 64
MESH_SHARDS = 4            # path I: ranks sharing the card over gloo
PATH_I_ONE_SEQUENCES = 8   # path I: path E's sequences the world of one serves
PATH_J_RANKS = (1, 2, 4)   # path J: one world of gloo ranks sharing the card per n
PATH_J_HEAD = 8            # path J: frames of each recorded K4/K8 launch held to the plain version
PATH_J_DP_HEAD = 2         # the same for a dp rank's block (100 GN rounds a frame, ~38 run)
ENTRY_TRI_TOL = 5e-4       # the entry's triangulations, card against CPU (the parity bound)
# Path J's kernels: dp and sp (K1-K3, K8; K4 in the serial n = 1 sp run), sparse
# BA over lm (K9, K10), the dry run's sharded matcher (K7), the entry's step (K1, K6).
PATH_J = ("match_pairs", "join_candidates", "gather_rows", "track_frames", "best_match",
          "track_frames_batched", "segment_sum", "take_table", "picp_solve")
MOUNT_V = (0.05, -0.1, 0.02, 0.01, -0.02, 0.015)   # a non-identity camera mount, Euler chart
# P2 at the benchmark cells' streams: sequences, rows (the bootstrap's slots,
# the head, + tracked frames x slots), head rows, distinct landmark keys in the
# field, map capacity; its launches a call.
FOLD_SHAPES = {"ref128.single": (1, 15_360, 128, 1_000, 1024),
               "ref128.fleet64": (64, 15_360, 128, 1_000, 1024),
               "dense1024.seq512": (1, 523_264, 1024, 7_500, 2048)}
FOLD_KERNELS = 4   # fill, insert, count, write



class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_call(fn, device):
    """(fn(), its time in ms): CUDA events on a card, the host clock on the CPU."""
    from visual_odometry_tpu_torch.utils.timing import cuda_timed

    return cuda_timed(fn, device)


def time_ms(fn, device, reps: int, warmup: int = 1) -> float:
    """Median time of fn() in ms over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed_call(fn, device)[1] for _ in range(reps))


def prefixed(prefix: str, row: dict) -> dict:
    return {prefix + k: v for k, v in row.items()}


def same_bits(*pairs) -> bool:
    """Whether each (a, b) pair of tensors holds the same bits."""
    import torch

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    return all(a.shape == b.shape and torch.equal(raw(a), raw(b)) for a, b in pairs)


def roofline_bound(model, device) -> dict:
    """``bound_ms`` and ``bound_by`` of a ``utils/roofline`` work model on this card."""
    import torch

    from visual_odometry_tpu_torch.utils import roofline

    t, by = model.bound(roofline.spec_for(torch.cuda.get_device_properties(device)))
    return dict(bound_ms=1e3 * t, bound_by=by)


def path_b_inputs(frames: int, slots: int, device):
    """The full-width tracking sequence of benchmarks/bench_scale.py:76-79."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    pts, apps, masks = synthetic.generate_tracking_sequence(np.random.default_rng(0), frames, slots)
    return tuple(torch.from_numpy(x).to(device) for x in (pts, apps, masks))


def mount_matrix(device):
    import torch

    from visual_odometry_tpu_torch.ops import se3

    return se3.v2t_euler(torch.tensor(MOUNT_V)).to(device)


def path_d_inputs(frames: int, slots: int, device, seed: int = 0):
    """Path B's landmark field and orbit seen by a planar robot: the camera
    pose of frame i is ``c^-1 T(x, y, theta) c`` with the mount c, so the
    motion lies in the subgroup the planar solver moves in. (Path B's own
    6-DoF motion is no planar workload: a planar model fitted to it shrinks
    the monocular scale frame by frame until the poses overflow, in the JAX
    package as here.)"""
    import torch

    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, slots),
                                       rng.uniform(-1.2, 1.2, slots),
                                       rng.uniform(2.0, 4.0, slots)], axis=1).astype(np.float32))
    apps = torch.from_numpy(synthetic.generate_appearances(rng, slots))
    mount = mount_matrix("cpu")
    ph = 2.0 * np.pi * torch.arange(frames, dtype=torch.float32) / 64.0
    robot = se3.v2t_se2(torch.stack([0.3 * torch.cos(ph), 0.3 * torch.sin(ph),
                                     0.02 * torch.sin(ph)], dim=-1))
    poses = se3.inverse(mount) @ robot @ mount
    pts, masks = zip(*(project_points(synthetic.default_camera(p), world) for p in poses))
    return (torch.stack(pts).to(device), apps[None].expand(frames, -1, -1).contiguous().to(device),
            torch.stack(masks).to(device))


def kernel_inputs(camera, config, pts, apps, masks):
    """Each kernel's inputs as the main path builds them (plain versions)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel, gather_kernel

    plain = config.replace(matcher_backend="torch", scan_backend="torch")
    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    corr01 = pipeline._match(plain, False, f0, f1)
    rest = pipeline.FrameData(pts[2:], apps[2:], masks[2:], ids[2:])
    prev = pipeline.FrameData(pts[1:-1], apps[1:-1], masks[1:-1], ids[1:-1])
    corr = pipeline._batched_match(plain, False, rest, prev)
    src_idx2 = torch.cat([corr01.idx2[None], corr.idx2[:-1]]).contiguous()
    src_valid = torch.cat([corr01.valid[None], corr.valid[:-1]]).contiguous()
    join_args = (src_idx2, src_valid, corr.idx1.contiguous(), corr.valid.contiguous(),
                 config.fused_join_depth)
    cand = frame_kernel.join_candidates(*join_args, backend="torch")
    safe1 = torch.where(corr.valid, corr.idx1, 0)
    safe2 = torch.where(corr.valid, corr.idx2, 0)
    prev_al = gather_kernel.gather_rows_plain(prev.points, safe1)
    cur_al = gather_kernel.gather_rows_plain(rest.points, safe2)

    # K4's arguments, or K5's for a planar config (planarized bootstrap).
    state, _ = pipeline.initialize(camera, plain, f0, f1, corr=corr01)
    frame_args = (
        frame_kernel.pack_params(
            camera.camera_matrix, camera.params(), state.x_curr, config.kernel_threshold,
            config.damping, config.gn_tolerance if config.gn_tolerance > 0.0 else -1.0,
            config.keep_outliers, config.warm_start, config.min_num_inliers, config.planar,
            config.planar_mount(),
        ),
        state.tri_points.contiguous(), state.tri_valid.contiguous(), cand,
        prev_al, cur_al, corr.valid.contiguous(), config.gn_iterations,
        config.gn_min_iterations, config.planar,
    )
    k1_batch = (prev.appearances.contiguous(), prev.mask.contiguous(),
                rest.appearances.contiguous(), rest.mask.contiguous())
    k1_pair = tuple(x[:1] for x in (apps, masks)) + tuple(x[1:2] for x in (apps, masks))
    return {
        "match_pairs": k1_batch,
        "match_pairs_b1": k1_pair,
        "join_candidates": join_args,
        "gather_rows_pixels": ((prev.points, safe1), (rest.points, safe2)),
        "gather_rows_apps": (rest.appearances, safe2),
        "track_frames": frame_args,
    }


def head_frames(args, frames: int):
    """A frame kernel's arguments cut to the first ``frames`` tracked frames."""
    from visual_odometry_tpu_torch.ops.kernels.frame_kernel import JoinCandidates

    params, tri, tri_ok, cand, prev_al, cur_al, valid = args[:7]
    cand = JoinCandidates(*(x[:frames].contiguous() for x in cand))
    return (params, tri, tri_ok, cand, prev_al[:frames].contiguous(),
            cur_al[:frames].contiguous(), valid[:frames].contiguous()) + tuple(args[7:])


def compare_frame_kernel(name, args, plain_frames, device, table, track):
    """K4 / K5: the kernel against its plain version over the first
    ``plain_frames`` frames (the plain version is a Python loop with a host
    sync per GN round), its time at the main path's full depth, and its bound
    from the GN rounds the plain version counted."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel
    from visual_odometry_tpu_torch.utils import roofline

    planar = bool(args[-1])
    plain_frames = min(plain_frames, args[3].idx.shape[0])
    short = head_frames(args, plain_frames)
    kp, *_, k_rounds = track(*short)
    rounds = []
    pp, plain_ms = timed_call(
        lambda: frame_kernel.track_frames_plain(*short, rounds_out=rounds)[0], device)
    label = "K5" if planar else "K4"
    require(bool(torch.isfinite(kp).all()), f"{label}: non-finite poses")
    err = float((kp - pp).abs().max())
    tol = GN_POSE_TOL if planar else K4_POSE_TOL
    require(err <= tol, f"{label}: poses differ by {err} > {tol}")
    require(k_rounds.tolist() == rounds, f"{label}: GN rounds differ from the plain version's")
    ms = time_ms(lambda: track(*args), device, 3)
    ms_short = time_ms(lambda: track(*short), device, 3)

    f, depth, s = args[3].idx.shape
    # The rounds a frame over the compared frames (the kernel's, equal to the
    # plain version's) stand for the whole depth.
    rounds_per_frame = sum(rounds) / len(rounds)
    table[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       **roofline_bound(roofline.frame_model(f, s, depth, rounds_per_frame, planar),
                                        device),
                       library_ms=None, plain_frames=plain_frames,
                       ms_at_plain_frames=ms_short, gn_rounds_per_frame=rounds_per_frame,
                       us_per_gn_round=1e3 * ms_short / sum(rounds))


def k1_edge_cases(kernel_fns, device) -> float:
    """K1 where its tiles meet: duplicate descriptors at j and j + 128 (ties
    across row tiles and column splits), an all-masked frame, NaN garbage in
    masked slots, one pair at N = 1024 and a ragged N. Exact: 0.0."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import matcher_kernel

    rng = np.random.default_rng(7)
    for b, n in ((1, 1024), (3, 1000), (2, 200)):
        a1 = rng.uniform(-1, 1, (b, n, 10)).astype(np.float32)
        a2 = a1[:, rng.permutation(n)] + rng.normal(0, 0.02, (b, n, 10)).astype(np.float32)
        for j in range(0, n - 128, 97):
            a1[:, j + 128] = a1[:, j]
            a2[:, j + 128] = a2[:, j]
        m1 = rng.uniform(size=(b, n)) > 0.1
        m2 = rng.uniform(size=(b, n)) > 0.1
        m2[-1] = False
        a1[~m1] = np.nan
        a2[~m2] = np.nan
        args = [torch.from_numpy(x).to(device) for x in (a1, m1, a2, m2)]
        got = kernel_fns["match_pairs"](*args)
        ref = matcher_kernel.match_pairs_plain(*args)
        require(all(torch.equal(g, r) for g, r in zip(got, ref)),
                f"K1 edge cases B={b} N={n}: the kernel differs from the plain version")
    return 0.0


def k2_edge_cases(kernel_fn, path_b_args, device) -> None:
    """K2 against its plain version bit for bit beyond the pipeline's data:
    path B's rows at depth 1 and 4 with a twentieth of the targets moved
    outside [0, S) on both sides (valid and invalid lanes), and 128 lanes
    (path E's width) with multiplicities up to 8 at depth 1, 2 and 4."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    src, sv, dst, dv, _ = path_b_args
    gen = torch.Generator(device="cpu").manual_seed(2)

    def wild(x):   # a twentieth of the lanes aimed at -3..-1 or S..S+2
        far = torch.randint(-3, 3, x.shape, generator=gen, dtype=torch.int32)
        far = torch.where(far < 0, far, far + x.shape[1])
        hit = torch.rand(x.shape, generator=gen) < 0.05
        return torch.where(hit.to(x.device), far.to(x.device), x)

    cases = [((wild(src), sv, wild(dst), dv), depth) for depth in (1, 4)]
    f = 64
    small = [torch.randint(0, 24, (f, 128), generator=gen, dtype=torch.int32),
             torch.rand((f, 128), generator=gen) > 0.3,
             torch.randint(-2, 30, (f, 128), generator=gen, dtype=torch.int32),
             torch.rand((f, 128), generator=gen) > 0.3]
    cases += [(tuple(x.to(device) for x in small), depth) for depth in (1, 2, 4)]
    for args, depth in cases:
        got = kernel_fn(*args, depth)
        want = frame_kernel.join_candidates_plain(*args, depth)
        require(all(torch.equal(x, y) for x, y in zip(got, want)),
                f"K2: join candidates differ at S = {args[0].shape[1]}, depth {depth}")


def compare_kernels(inputs, device, kernel_fns, reps: int = 10, launch_reps: int = 50):
    """K1-K4: run each kernel and its plain version on the same inputs; returns
    {name: row fields} and raises on disagreement."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel, gather_kernel, matcher_kernel
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_times

    out = {}

    def k1_check(args, label):
        kd1, ki1, kd2, ki2 = kernel_fns["match_pairs"](*args)
        pd1, pi1, pd2, pi2 = matcher_kernel.match_pairs_plain(*args)
        sync(device)
        require(torch.equal(ki1, pi1) and torch.equal(ki2, pi2), f"K1 {label}: indices differ")
        err = 0.0
        for kd, pd in ((kd1, pd1), (kd2, pd2)):
            live = pd < 1e38
            diff = (kd - pd).abs()
            require(bool((diff <= K1_DIST_RTOL * pd.abs().clamp_min(1.0)).all()),
                    f"K1 {label}: distances differ beyond {K1_DIST_RTOL} relative")
            err = max(err, float(diff[live].max()) if bool(live.any()) else 0.0)
        return err

    a, a1 = inputs["match_pairs"], inputs["match_pairs_b1"]
    err = max(k1_check(a, "B=510"), k1_check(a1, "B=1"), k1_edge_cases(kernel_fns, device))
    b, n, d = a[0].shape
    out["match_pairs"] = dict(
        max_abs_err=err, ms=time_ms(lambda: kernel_fns["match_pairs"](*a), device, reps),
        plain_ms=time_ms(lambda: matcher_kernel.match_pairs_plain(*a), device, 3),
        **roofline_bound(roofline.match_pairs_model(b, n, d), device), library_ms=None, pairs=b,
        ms_b1=time_ms(lambda: kernel_fns["match_pairs"](*a1), device, reps),
        bound_ms_b1=roofline_bound(roofline.match_pairs_model(1, n, d), device)["bound_ms"])

    a = inputs["join_candidates"]
    kc = kernel_fns["join_candidates"](*a)
    pc = frame_kernel.join_candidates_plain(*a)
    require(all(torch.equal(x, y) for x, y in zip(kc, pc)), "K2: join candidates differ")
    k2_edge_cases(kernel_fns["join_candidates"], a, device)
    f, s = a[0].shape
    out["join_candidates"] = dict(
        max_abs_err=0.0, ms=time_ms(lambda: kernel_fns["join_candidates"](*a), device, reps),
        plain_ms=time_ms(lambda: frame_kernel.join_candidates_plain(*a), device, 3),
        **roofline_bound(roofline.join_model(f, s, a[4]), device), library_ms=None)

    # K3 at path B's three gathers: previous and current pixels (D=2), the
    # appearances (D=10); each also with indices past both ends of S.
    k3 = {}
    for key, (src, idx) in (("pixels_prev", inputs["gather_rows_pixels"][0]),
                            ("pixels_cur", inputs["gather_rows_pixels"][1]),
                            ("apps", inputs["gather_rows_apps"])):
        f, s, d = src.shape
        wild = idx.clone()
        wild[:, ::7] = -3
        wild[:, 3::7] = s + 5
        for ix in (idx, wild):
            require(torch.equal(kernel_fns["gather_rows"](src, ix),
                                gather_kernel.gather_rows_plain(src, ix)),
                    f"K3 {key}: the gather differs from the plain version")
        idx64 = idx.long()[..., None].expand(f, s, d)      # the library's index, made once
        k3[key] = dict(
            launch_times(lambda: kernel_fns["gather_rows"](src, idx), device, launch_reps),
            plain_ms=time_ms(lambda: gather_kernel.gather_rows_plain(src, idx), device, reps),
            **roofline_bound(roofline.gather_model(f, s, d), device),
            **prefixed("library_", launch_times(lambda: torch.gather(src, 1, idx64), device,
                                                launch_reps)))
    out["gather_rows"] = dict(max_abs_err=0.0, **k3["apps"], pixels_prev=k3["pixels_prev"],
                              pixels_cur=k3["pixels_cur"])

    compare_frame_kernel("track_frames", inputs["track_frames"], K4_PLAIN_FRAMES, device, out,
                         kernel_fns["track_frames"])
    return out


def solve_problem(n: int, planar: bool, device, seed: int = 0):
    """A standalone PICP problem: N model points seen under a ground-truth pose
    (planar: a conjugated SE(2) motion), with pixel noise and dead slots."""
    import torch

    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = torch.from_numpy(np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                                       rng.uniform(2.0, 4.0, n)], 1).astype(np.float32))
    mount = mount_matrix("cpu")
    if planar:
        gt = se3.inverse(mount) @ se3.v2t_se2(torch.tensor([0.1, -0.05, 0.04])) @ mount
    else:
        gt = se3.v2t_euler(torch.tensor([0.1, -0.05, 0.02, 0.01, 0.02, -0.03]))
    uv, ok = project_points(synthetic.default_camera(gt), world)
    uv = uv + torch.from_numpy(rng.normal(0, 0.3, (n, 2)).astype(np.float32))
    w = ok.float()
    w[::9] = 0.0
    world = torch.where(w[:, None] > 0, world, 1.0)   # dead slots sanitized, as picp.solve does
    cam = synthetic.default_camera(device=device)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    if planar:
        head += (mount.to(device),)
    return head + (world.to(device), uv.to(device), w.to(device), 30, 1e4, 1.0, 1e-12), gt


def compare_solves(device, table, backend: str = "cuda", reps: int = 10, launch_reps: int = 50):
    """K6: both standalone solves against their plain versions at N = 1024 and
    N = 8192 (clusters of 4 and of 8 CTAs of 256 threads), bit for bit
    expected. Each row: the wrapper's ms, the launch alone with its inputs
    prepared (launch_times: ms, device_ms, host_ms), the GN rounds and the
    device us a round, the geometry, and the launch floor beside the bound."""
    from visual_odometry_tpu_torch.ops.kernels import picp_kernel
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_floor, launch_times

    floor = launch_floor(device, launch_reps) if backend == "cuda" else None
    for planar, name in ((False, "picp_solve"), (True, "picp_solve_se2")):
        fn = picp_kernel.solve_se2_fused if planar else picp_kernel.solve_fused
        plain = picp_kernel.solve_se2_fused_plain if planar else picp_kernel.solve_fused_plain
        row = dict(max_abs_err=0.0, library_ms=None, bitwise=True)
        for n in (1024, 8192):
            args, gt = solve_problem(n, planar, device)
            pose, stats = fn(*args, backend=backend)
            rounds = []
            (pose_p, stats_p), plain_ms = timed_call(lambda: plain(*args, rounds_out=rounds),
                                                     device)
            err = float((pose - pose_p).abs().max())
            require(err <= GN_POSE_TOL, f"K6 {name} N={n}: poses differ by {err}")
            require(int(stats.num_inliers) == int(stats_p.num_inliers),
                    f"K6 {name} N={n}: inlier counts differ")
            require(float((pose.cpu() - gt).abs().max()) < 5e-3,
                    f"K6 {name} N={n}: the solve missed the ground-truth pose")
            bitwise = same_bits((pose, pose_p), *zip(stats, stats_p))
            ctas, threads = picp_kernel.solve_geometry(n)
            entry = dict(ms=time_ms(lambda: fn(*args, backend=backend), device, reps),
                         plain_ms=plain_ms,
                         **roofline_bound(roofline.picp_model(n, rounds[0], planar), device),
                         gn_rounds=rounds[0], bitwise=bitwise, ctas=ctas, threads=threads,
                         cluster=ctas)
            if backend == "cuda":   # the launch alone, its inputs prepared beforehand
                head, tail = args[:-7], args[-7:]
                world, meas, w, iters, kt, damping, tol = tail
                prepared = (head[0], head[1], head[2],
                            picp_kernel.mount_rows(head[3]).to(device) if planar else None,
                            world, meas, w, iters, 1, (kt, 0.0, damping, tol, 0.0))
                alone = launch_times(lambda: picp_kernel._solve_cuda(*prepared), device,
                                     launch_reps)
                entry.update(launch_ms=alone["ms"], device_ms=alone["device_ms"],
                             host_ms=alone["host_ms"])
                entry["us_per_round"] = 1e3 * alone["device_ms"] / rounds[0]
                entry["launch_floor"] = floor
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["bitwise"] = row["bitwise"] and bitwise
            row[f"n{n}"] = entry
        # The row's times are those of the shape its path runs: path C solves
        # 1024 matches in SE(3); the standalone planar solve takes N = 8192.
        row.update(row["n8192" if planar else "n1024"])
        table[name] = row


def match_problem(nq: int, nk: int, device, seed: int = 0, dim: int = 10):
    """Queries near database rows; a tenth of the rows and a twentieth of the
    queries masked, NaN written into the masked rows."""
    import torch

    rng = np.random.default_rng(seed)
    db = rng.uniform(-1.0, 1.0, (nk, dim)).astype(np.float32)
    pick = rng.permutation(nk)[:nq]
    q = (db[pick] + rng.normal(0, 1e-3, (nq, dim))).astype(np.float32)
    db_mask = rng.uniform(size=nk) > 0.1
    q_mask = rng.uniform(size=nq) > 0.05
    db[~db_mask] = np.nan
    return tuple(torch.from_numpy(x).to(device) for x in (q, q_mask, db, db_mask)), pick


def compare_matchers(device, table, backend: str = "cuda", nq: int = 1024, nk: int = 1 << 20,
                     reps: int = 10):
    """K7: exact and fast against the plain version at map scale, on
    match_problem's data, on synthetic.generate_match_ties' (negative gram
    distances that clamp and tie, duplicates one tile apart, rows one bfloat16
    ulp apart, NaN and inf in masked and live rows) and on
    synthetic.generate_exact_match_ties' (rows one float32 ulp apart,
    negative exact keys that differ, duplicates a tile and a split apart,
    bf16's subnormal edge, norms that overflow): indices and distances
    bitwise. Each mode's rescored (query, row) pairs are counted on all
    three in separate calls."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import matcher_kernel
    from visual_odometry_tpu_torch.utils import roofline, synthetic

    args, pick = match_problem(nq, nk, device)
    ties = tuple(torch.from_numpy(x).to(device) for x in synthetic.generate_match_ties(
        np.random.default_rng(1), nq, nk))
    exact_ties = tuple(torch.from_numpy(x).to(device) for x in synthetic.generate_exact_match_ties(
        np.random.default_rng(2), nq, nk))
    q, q_mask, db, db_mask = args
    d = q.shape[1]
    for fast, name in ((False, "best_match"), (True, "best_match_fast")):
        dist, idx = matcher_kernel.best_match(*args, backend=backend, fast=fast)
        (dist_p, idx_p), plain_ms = timed_call(
            lambda: matcher_kernel.best_match_plain(*args, fast=fast), device)
        require(torch.equal(idx, idx_p), f"K7 {name}: indices differ from the plain version")
        live = q_mask & (dist_p < 1e38)
        err = float((dist - dist_p)[live].abs().max())
        require(torch.equal(dist, dist_p), f"K7 {name}: distances differ by {err}")
        require(bool(db_mask[idx[q_mask].long()].all()), f"K7 {name}: a masked row won")
        require(bool((dist[~q_mask] > 1e38).all()), f"K7 {name}: a masked query got a distance")
        own = torch.from_numpy(pick).to(device)
        want = q_mask & db_mask[own]
        require(bool((idx[want] == own[want]).all()), f"K7 {name}: a query missed its own row")
        for label, data in (("generate_match_ties", ties),
                            ("generate_exact_match_ties", exact_ties)):
            tie_dist, tie_idx = matcher_kernel.best_match(*data, backend=backend, fast=fast)
            tie_dist_p, tie_idx_p = matcher_kernel.best_match_plain(*data, fast=fast)
            require(torch.equal(tie_idx, tie_idx_p) and torch.equal(tie_dist, tie_dist_p),
                    f"K7 {name}: differs from the plain version on {label}")
        row = dict(max_abs_err=err, plain_ms=plain_ms)
        if backend == "cuda":
            counts = []
            for a in (args, ties, exact_ties):
                counter = torch.zeros(1, dtype=torch.int64, device=device)
                matcher_kernel.best_match_cuda(*a, fast=fast, survivors=counter)
                counts.append(int(counter.item()) / nq)
            row.update(survivors_per_query=counts[0], survivors_per_query_ties=counts[1],
                       survivors_per_query_exact_ties=counts[2])
        table[name] = dict(
            row, **roofline_bound(roofline.matcher_model(nq, nk, d, "fast" if fast else "highest"),
                                  device),
            ms=time_ms(lambda: matcher_kernel.best_match(*args, backend=backend, fast=fast),
                       device, reps),
            # No single PyTorch call computes a top-1 over K = 2^20 rows without the
            # (Q, K) distance matrix in device memory.
            library_ms=None)


def eight_point_args(camera, config, pts, apps, masks):
    """P1's arguments as ``pipeline.initialize_batched`` builds them for the
    frame pairs 0/1 of (B, F, S, ...) sequences (one K1 launch matches them)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0, f1 = (pipeline.FrameData(*(x[:, i].contiguous() for x in (pts, apps, masks, ids)))
              for i in (0, 1))
    corr = pipeline._batched_match(config, False, f1, f0)
    return (camera.camera_matrix.contiguous(), corr.idx1.contiguous(), corr.idx2.contiguous(),
            corr.valid.contiguous(), f0.points, f1.points, f0.mask, f1.mask), (f0, f1, corr)


def linalg_eight_point(k, idx1, idx2, valid, p1, p2, mask1, mask2):
    """The same step as stacked library calls: the normal matrices by a
    batched matmul, the null vectors by ``torch.linalg.eigh`` and
    ``solve_ex`` (ops/epipolar._null_vector), the 3x3 SVDs by
    ``torch.linalg.svd``, the votes batched. The yardstick of P1's row
    (``library_ms``); the port never calls it."""
    import torch

    from visual_odometry_tpu_torch.ops import epipolar, se3, triangulation

    def take(p, i):
        return torch.gather(p, 1, i.long()[..., None].expand(i.shape + (2,)))

    p1n, t1 = epipolar.normalize_points(p1, mask1)
    p2n, t2 = epipolar.normalize_points(p2, mask2)
    one = torch.ones_like(idx1, dtype=p1.dtype)[..., None]
    rows = epipolar._design_rows(torch.cat([take(p1n, idx1), one], -1),
                                 torch.cat([take(p2n, idx2), one], -1), valid).double()
    f = epipolar._null_vector(rows.transpose(1, 2) @ rows).float().reshape(-1, 3, 3)
    u, sv, vt = torch.linalg.svd(f)
    sv = torch.cat([sv[:, :2], torch.zeros_like(sv[:, 2:])], 1)
    e = k.T @ (t1.transpose(1, 2) @ ((u * sv[:, None, :]) @ vt) @ t2) @ k
    u, _, vt = torch.linalg.svd(e)
    w = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=e.device)
    r1 = vt.transpose(1, 2) @ w @ u.transpose(1, 2)
    sign = torch.where(torch.linalg.det(r1) < 0.0, -1.0, 1.0)[:, None, None]
    r1, r2 = sign * r1, sign * (vt.transpose(1, 2) @ w.T @ u.transpose(1, 2))
    m1, m2 = r1 @ e, r2 @ e
    ta = torch.stack([m1[:, 2, 1], m1[:, 0, 2], m1[:, 1, 0]], -1)
    tb = torch.stack([m2[:, 2, 1], m2[:, 0, 2], m2[:, 1, 0]], -1)
    cands = se3.pose_from_rt(torch.stack([r1, r1, r2, r2], 1), torch.stack([ta, -ta, tb, -tb], 1))
    _, ok = triangulation.triangulate_pairs_elementwise(
        k, cands, take(p1, idx1)[:, None], take(p2, idx2)[:, None], valid[:, None])
    votes = ok.sum(-1)
    best = torch.argmax(votes, 1)
    x = cands[torch.arange(cands.shape[0], device=e.device), best]
    won = votes.gather(1, best[:, None])[:, 0] > 0
    return torch.where(won[:, None, None], x, torch.eye(4, device=e.device))


def blocks_equal(fn, args, full, sizes=(1, 16, 32)) -> dict:
    """For each block size, whether ``fn`` on row blocks of ``args`` (every
    tensor with the batch first cut alike, inside tuples too) gives
    ``full``'s bits: a tensor or a tuple tree of tensors, the batch first."""
    import torch

    want = blocks_flat(full)
    b = want[0].shape[0]

    def cut(a, i, size):
        if isinstance(a, torch.Tensor):
            return a[i:i + size] if a.dim() and a.shape[0] == b else a
        if isinstance(a, tuple):
            items = [cut(x, i, size) for x in a]
            return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
        return a

    out = {}
    for size in sizes:
        parts = [blocks_flat(fn(*cut(tuple(args), i, size))) for i in range(0, b, size)]
        out[str(size)] = same_bits(*((torch.cat([p[j] for p in parts]), w)
                                     for j, w in enumerate(want)))
    return out


def compare_eight_point(camera, config, serving_seqs, serving_config, seq_b, plan, device, table,
                        reps: int = 10, launch_reps: int = 50):
    """P1 (eight_point) against its plain versions, bit for bit, at the main
    path's shapes: path E's 64 pairs (S = 128), path B's pair (S = 1,024) and
    path H's 4 chunk pairs; two launches with the same bits. Each shape takes
    both instances: ``pose`` (estimate_transform_batched, the pose alone) and
    ``seed`` (bootstrap_batched, what the main path launches: the pose, the
    triangulation, the seeded maps, the lookups and the histories, every
    output held). Batch invariance on the card at B = 1, 16, 32 and 64 for
    both instances, for ``pipeline.initialize_batched`` (every state
    tensor) and for the batched fold (``landmark_map.merge_stream`` over
    path E's kind of streams). The stacked torch.linalg form of the pose
    (linalg_eight_point) timed beside it as the row's library time, with
    whether it is batch-invariant (reported, not required). Each instance's
    row: ms, the launch alone, device and host ms, plain ms, the bound and
    the launch floor; the kernel row's own numbers are path E's bootstrap
    instance's."""
    import torch

    from visual_odometry_tpu_torch.models import landmark_map, pipeline
    from visual_odometry_tpu_torch.ops.kernels import epipolar_kernel
    from visual_odometry_tpu_torch.parallel import posegraph
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_floor, launch_times

    instances = {"pose": (epipolar_kernel.estimate_transform_batched_cuda,
                          epipolar_kernel.estimate_transform_batched_plain,
                          epipolar_kernel.estimate_transform_batched),
                 "seed": (epipolar_kernel.bootstrap_batched_cuda,
                          epipolar_kernel.bootstrap_batched_plain,
                          epipolar_kernel.bootstrap_batched)}
    floor = launch_floor(device, launch_reps)
    chunks = [posegraph._chunk(x, *plan) for x in seq_b]
    cases = {"path_e": (serving_config, serving_seqs),
             "path_b": (config, tuple(x[None, :2] for x in seq_b)),
             "path_h": (config, tuple(chunks))}
    row = dict(max_abs_err=0.0, bitwise=True)
    for label, (cfg, seqs) in cases.items():
        pose_args, (f0, f1, corr) = eight_point_args(camera, cfg, *seqs)
        b, s = pose_args[1].shape
        n, d = int(pose_args[4].shape[1]), int(f1.appearances.shape[-1])
        live = int(pose_args[3].sum())
        sub = dict(pairs=b, correspondences=s, slots=n, live_correspondences=live,
                   map_capacity=cfg.map_capacity)
        for inst, (cuda, plain, wrapper) in instances.items():
            args = pose_args if inst == "pose" else (
                pose_args + (f1.appearances, cfg.map_capacity, None))
            out = cuda(*args)
            again = cuda(*args)
            ref = plain(*args)
            flat = blocks_flat(out)
            poses = (out,) if inst == "pose" else (out.x_init, out.history)
            require(all(bool(torch.isfinite(x).all()) for x in poses),
                    f"P1 {inst} {label}: non-finite pose")
            require(same_bits(*zip(flat, blocks_flat(again))),
                    f"P1 {inst} {label}: two launches gave different bits")
            require(same_bits(*zip(flat, blocks_flat(ref))),
                    f"P1 {inst} {label}: differs from the plain version")
            alone = launch_times(lambda: cuda(*args), device, launch_reps)
            model = (roofline.eight_point_model(b, s, n, live) if inst == "pose" else
                     roofline.eight_point_model(b, s, n, live, cfg.map_capacity, d))
            sub[inst] = dict(
                ms=time_ms(lambda: wrapper(*args), device, reps),
                launch_ms=alone["ms"], device_ms=alone["device_ms"], host_ms=alone["host_ms"],
                plain_ms=time_ms(lambda: plain(*args), device, 3),
                **roofline_bound(model, device), launch_floor=floor)
            if label == "path_e":
                inv = blocks_equal(cuda, args, out)
                require(all(inv.values()), f"P1 {inst}: not batch-invariant on the card: {inv}")
                sub[inst]["batch_invariant"] = inv
            if inst == "pose":
                lib_out = linalg_eight_point(*args)
                sub["library_ms"] = time_ms(lambda: linalg_eight_point(*args), device, reps)
                sub["library_max_abs_diff"] = float((lib_out - out).abs().max())
                if label == "path_e":
                    sub["library_batch_invariant"] = blocks_equal(linalg_eight_point, args,
                                                                  lib_out)
        if label == "path_e":
            # The whole batched initialize, every state tensor, by blocks.
            state = pipeline.initialize_batched(camera, cfg, f0, f1, corr=corr)
            init = blocks_equal(lambda u, v, c: pipeline.initialize_batched(
                camera, cfg, u, v, corr=c), (f0, f1, corr), state)
            require(all(init.values()), f"initialize_batched: not batch-invariant: {init}")
            sub["initialize_batch_invariant"] = init
            streams = fold_streams(b, cfg.n_slots * (SERVE_FRAMES - 1), device)
            folded = landmark_map.merge_stream(*streams, cfg.map_capacity)
            fold = blocks_equal(lambda *a: landmark_map.merge_stream(*a, cfg.map_capacity),
                                streams, tuple(folded))
            require(all(fold.values()), f"merge_stream: not batch-invariant: {fold}")
            sub["fold_batch_invariant"] = fold
        row[label] = sub
    e = row["path_e"]
    row.update({k: e["seed"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
               library_ms=e["library_ms"])
    table["eight_point"] = row


def compare_map_fold(device, table, reps: int = 10, launch_reps: int = 50):
    """P2 (map_fold: ``landmark_map.merge_stream`` on the card) against the
    plain fold on the same card tensors at the benchmark cells' stream
    shapes (FOLD_SHAPES), the stream handed over as the pipeline does (the
    bootstrap's rows as its head): every output bit for bit, two calls
    alike. Each shape's ms (CUDA events around merge_stream), the call's
    four kernels alone (their device ms summed, and the host ms), the plain fold's ms and
    the bound from ``roofline.map_fold_model`` (bytes: each row read once,
    each slot written once). The row's own numbers are the fleet's."""
    from visual_odometry_tpu_torch.models import landmark_map
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_floor, launch_times

    floor = launch_floor(device, launch_reps)
    row = dict(max_abs_err=0.0, bitwise=True, launch_floor=floor)
    for label, (b, t, h, keys, cap) in FOLD_SHAPES.items():
        streams = [x[0] if b == 1 else x for x in fold_streams(b, t, device, keys)]
        axis = streams[2].dim() - 1     # one stream has no batch axis, as run_sequence folds
        head = tuple(x.narrow(axis, 0, h).contiguous() for x in streams)
        body = [x.narrow(axis, h, t - h).contiguous() for x in streams]

        def fold(backend="auto"):
            return landmark_map.merge_stream(*body, cap, backend=backend, head=head)

        _lib.reset_launches()
        out = fold()
        require(_lib.launches["map_fold"] == 1, f"P2 {label}: {_lib.launches}")
        require(same_bits(*zip(out, fold())), f"P2 {label}: two calls gave different bits")
        whole = landmark_map.merge_stream(*streams, cap, backend="torch")
        require(same_bits(*zip(out, whole)), f"P2 {label}: differs from the plain fold")
        alone = launch_times(fold, device, launch_reps)
        row[label] = dict(
            sequences=b, rows=t, head_rows=h, keys=keys, capacity=cap,
            landmarks=out.count.reshape(-1)[:4].tolist(),
            ms=time_ms(fold, device, reps), launch_ms=alone["ms"],
            device_ms=FOLD_KERNELS * alone["device_ms"], host_ms=alone["host_ms"],
            plain_ms=time_ms(lambda: fold("torch"), device, reps),
            **roofline_bound(roofline.map_fold_model(b, t, 10, cap), device))
    fleet = row["ref128.fleet64"]
    row.update({k: fleet[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")})
    table["map_fold"] = row


def blocks_flat(t):
    """The tensors of a tensor or a tuple tree of tensors, in order."""
    import torch

    return [t] if isinstance(t, torch.Tensor) else [y for x in t for y in blocks_flat(x)]


def fold_streams(b: int, t: int, device, keys: int = 160, seed: int = 0):
    """``b`` streams of ``t`` rows (a fold's: the bootstrap's slots, then the
    slots of every tracked frame), each re-observing a field of ``keys``
    landmark keys of its own, one in five rows masked: (points, appearances,
    mask) on the card."""
    import torch

    rng = np.random.default_rng(seed)
    table = rng.uniform(-1, 1, (b, keys, 10)).astype(np.float32)
    apps = np.take_along_axis(table, rng.integers(0, keys, (b, t))[..., None], axis=1)
    pts = rng.normal(size=(b, t, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, t)) > 0.2
    return tuple(torch.from_numpy(x).to(device) for x in (pts, apps, mask))


def serving_inputs(count: int, frames: int, slots: int, config, device):
    """``count`` stacked sequences (points, appearances, masks) of path E's
    kind, landmark fields 100 .. 100 + count - 1, none left out:
    ``generate_tracking_sequence(default_rng(seed), frames, slots)`` or, for a
    planar config, path D's kind of motion over landmark field ``seed``."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    seqs = []
    for seed in range(100, 100 + count):
        if config.planar:
            seqs.append(path_d_inputs(frames, slots, device, seed=seed))
        else:
            seqs.append(tuple(
                torch.from_numpy(x).to(device) for x in
                synthetic.generate_tracking_sequence(np.random.default_rng(seed), frames, slots)))
    return tuple(torch.stack([q[k] for q in seqs]).contiguous() for k in range(3))


def require_tracked(outs, traj, slots: int, label: str):
    """Every sequence of a serving batch tracked: finite poses and, the data
    being exact, every slot an inlier in every frame."""
    import torch

    require(bool(torch.isfinite(traj).all()), f"{label}: non-finite poses")
    least = outs.num_inliers.reshape(outs.num_inliers.shape[0], -1).min(dim=1).values
    lost = [[100 + i, int(v)] for i, v in enumerate(least.tolist()) if v < slots]
    require(not lost, f"{label}: fields that lost inliers [field, least of {slots}]: {lost}")


def k8_args(rows):
    """K8's arguments for the sequences whose K4/K5 arguments (``kernel_inputs``'
    ``track_frames``) are ``rows``: one shared parameter row, the start poses stacked."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    stack = lambda k: torch.stack([a[k] for a in rows]).contiguous()   # noqa: E731
    cand = frame_kernel.JoinCandidates(
        *(torch.stack([a[3][q] for a in rows]).contiguous() for q in range(3)))
    pose0 = torch.stack([a[0][28:40] for a in rows]).contiguous()
    return ((rows[0][0], pose0, stack(1), stack(2), cand, stack(4), stack(5), stack(6))
            + rows[0][7:])


def k8_bound(args, rounds_per_frame: float, planar: bool, device) -> dict:
    """K8's bound (``roofline.serving_model``) at ``rounds_per_frame`` GN rounds."""
    from visual_odometry_tpu_torch.utils import roofline

    n, f, depth, s = args[4].idx.shape
    return roofline_bound(roofline.serving_model(n, f, s, depth, rounds_per_frame, planar), device)


def compare_serving(camera, config, seqs, device, table, rounds_frames: int = 14, reps: int = 3):
    """K8 (SE(3), or planar for a planar config): one launch over all the
    sequences against K4/K5 launched alone on each (every output of every
    sequence), its time beside one single launch's, and the first sequence of
    that launch against the plain version over all its frames."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel

    planar = config.planar
    name = "track_frames_batched_planar" if planar else "track_frames_batched"
    count = seqs[0].shape[0]
    singles = [kernel_inputs(camera, config, *(x[i] for x in seqs))["track_frames"]
               for i in range(count)]
    args = k8_args(singles)
    out = frame_kernel.track_frames_batched_cuda(*args)
    require(all(bool(torch.isfinite(x.float()).all()) for x in out), f"{name}: non-finite output")
    least = out[3][..., 2].min(dim=1).values
    lost = [[100 + i, int(v)] for i, v in enumerate(least.tolist()) if v < seqs[0].shape[2]]
    require(not lost, f"{name}: fields that lost inliers [field, least]: {lost}")
    err_single = 0.0
    for i, a in enumerate(singles):
        alone = frame_kernel.track_frames_cuda(*a)
        err_single = max(err_single, max(float((o[i].float() - x.float()).abs().max())
                                         for o, x in zip(out, alone)))
    require(err_single == 0.0,
            f"{name}: a sequence differs from its single launch by {err_single}")

    first = k8_args(singles[:1])
    ref, plain_ms = timed_call(lambda: frame_kernel.track_frames_batched_plain(*first), device)
    err = float((out[0][:1] - ref[0]).abs().max())
    tol = GN_POSE_TOL if planar else K4_POSE_TOL
    require(err <= tol, f"{name}: poses differ from the plain version by {err} > {tol}")
    require(torch.equal(out[2][:1], ref[2]), f"{name}: triangulation validity differs from plain")

    ms = time_ms(lambda: frame_kernel.track_frames_batched_cuda(*args), device, reps)
    single_ms = time_ms(lambda: frame_kernel.track_frames_cuda(*singles[0]), device, reps)
    rounds = []
    frame_kernel.track_frames_plain(*head_frames(singles[0], rounds_frames), rounds_out=rounds)
    rounds_per_frame = sum(rounds) / len(rounds)
    n, f, depth, s = args[4].idx.shape
    table[name] = dict(
        max_abs_err=err_single, max_abs_err_vs_plain=err, ms=ms, plain_ms=plain_ms,
        plain_shape=[1, f, s], **k8_bound(args, rounds_per_frame, planar, device),
        library_ms=None, sequences=n, frames=f, slots=s, single_launch_ms=single_ms,
        ms_over_single_launch=ms / single_ms,
        gn_rounds_per_frame_first_sequence_head=rounds_per_frame)


def chunk_plan(camera, config, pts, apps, masks):
    """Path H's plan as run_sequence_chunked makes it: (starts, chunk length)."""
    import torch

    from visual_odometry_tpu_torch.parallel import posegraph

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    starts, length, _ = posegraph._plan(config, pts, apps, masks, ids, False, CHUNKS,
                                        CHUNK_OVERLAP, None)
    return starts, length


def chunked_loop_form(camera, config, pts, apps, masks, plan):
    """run_sequence_chunked's work on ``plan`` with the chunks tracked as a
    loop of pipeline._track (K4 once a chunk): (trajectory, map, diagnostics)."""
    import torch

    from visual_odometry_tpu_torch.parallel import posegraph

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    chunked = [posegraph._chunk(x, *plan) for x in (pts, apps, masks, ids)]
    return posegraph._track_and_stitch(camera, config, *chunked, *plan, pts.shape[0], False,
                                       batched=False)


def compare_chunked_k8(camera, config, seq, plan, device, table, rounds_frames: int = 14,
                       reps: int = 10):
    """K8 at path H's shapes: the chunks of path B's sequence (4 x 142 tracked
    frames x 1,024 slots, a cluster of 4 CTAs a chunk) in one launch, each
    chunk's outputs bit for bit against K4 launched alone on it, and every
    chunk's first ``rounds_frames`` frames against the plain version of K8
    (the frame loop is causal: those frames' outputs need no later frame);
    its time beside each chunk's K4 alone, for the chain reckoning (frames x
    GN rounds a frame x a round's time, the slowest chunk's)."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel
    from visual_odometry_tpu_torch.parallel import posegraph
    from visual_odometry_tpu_torch.utils.roofline import launch_times

    chunks = [posegraph._chunk(x, *plan) for x in seq]
    singles = [kernel_inputs(camera, config, *(x[i] for x in chunks))["track_frames"]
               for i in range(len(plan[0]))]
    args = k8_args(singles)
    out = frame_kernel.track_frames_batched_cuda(*args)
    require(all(bool(torch.isfinite(x.float()).all()) for x in out),
            "K8 at path H's shapes: non-finite output")
    for i, a in enumerate(singles):
        alone = frame_kernel.track_frames_cuda(*a)
        require(same_bits(*((o[i].float(), x.float()) for o, x in zip(out, alone))),
                f"K8 at path H's shapes: chunk {i} differs from K4 launched alone")
    # The plain version over every chunk's head, with its GN rounds a frame.
    rounds = []
    ref, plain_ms = timed_call(lambda: frame_kernel.track_frames_batched_plain(
        *k8_args([head_frames(a, rounds_frames) for a in singles]), rounds_out=rounds), device)
    err = float((out[0][:, :rounds_frames] - ref[0]).abs().max())
    require(err <= K4_POSE_TOL,
            f"K8 at path H's shapes: poses differ from the plain version by {err} > {K4_POSE_TOL}")
    require(torch.equal(out[2][:, :rounds_frames], ref[2]),
            "K8 at path H's shapes: triangulation validity differs from the plain version")
    row = launch_times(lambda: frame_kernel.track_frames_batched_cuda(*args), device, reps)
    n, f, _, s = args[4].idx.shape
    # Each chunk alone: K4's time over all its frames.
    chunks = []
    for a, r in zip(singles, rounds):
        k4_ms = time_ms(lambda: frame_kernel.track_frames_cuda(*a), device, 3)
        pose0 = a[0][28:40]   # the bootstrap pose's (3, 4) rows: its gauge is |t|
        chunks.append(dict(k4_alone_ms=k4_ms, gn_rounds_per_frame_head=sum(r) / len(r),
                           us_per_gn_round=1e3 * k4_ms * len(r) / (f * sum(r)),
                           bootstrap_t_norm=float(pose0[3::4].norm())))
    rounds_per_frame = statistics.mean(c["gn_rounds_per_frame_head"] for c in chunks)
    table["track_frames_batched"]["path_h"] = dict(
        row, max_abs_err_vs_k4_alone=0.0, max_abs_err_vs_plain=err, plain_ms=plain_ms,
        plain_shape=[n, rounds_frames, s], sequences=n, frames=f, slots=s,
        **k8_bound(args, rounds_per_frame, False, device),
        gn_rounds_per_frame_head_mean=rounds_per_frame, chunks=chunks,
        over_slowest_k4_alone=row["ms"] / max(c["k4_alone_ms"] for c in chunks))


def run_path_h(camera, config, pts, apps, masks, device, serial_traj, serial_fps,
               require_launches: bool = True, reps: int = 3):
    """Chunked tracking at full width: path B's sequence through
    posegraph.run_sequence_chunked (4 chunks, overlap 10, the default slack),
    held bit for bit against its loop form (the same plan and stitch, K4 once
    a chunk), with every boundary observed by 8+ scale samples, and against
    serial path B's trajectory: mean |e_theta| below 1e-4 and every frame's
    translation ratio within 5% of their median."""
    import torch

    from visual_odometry_tpu_torch.models import landmark_map
    from visual_odometry_tpu_torch.models.refinement import absolute_from_relative
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import posegraph
    from visual_odometry_tpu_torch.utils.evaluation import relative_errors

    def chunked():
        return posegraph.run_sequence_chunked(camera, config, pts, apps, masks,
                                              num_chunks=CHUNKS, overlap=CHUNK_OVERLAP)

    plan = starts, length = chunk_plan(camera, config, pts, apps, masks)
    _lib.reset_launches()
    with recording(landmark_map, "merge_stream") as folds:
        traj, map_state, diags = chunked()
    sync(device)
    require(len(folds) == 1, f"path H: {len(folds)} merge_stream calls, expected one")
    fold_sha = hold_folds_to_plain(folds, "path H")
    launches = read_launches(tuple(k for k, v in PATH_H.items() if v), "path H", require_launches)
    if require_launches:
        require(all(launches[k] == v for k, v in PATH_H.items()),
                f"path H: launches must be {PATH_H}: {launches}")
    loop = chunked_loop_form(camera, config, pts, apps, masks, plan)
    pairs = zip((traj, *map_state, *diags), (loop[0], *loop[1], *loop[2]))
    require(all(same_bits((a, b)) if a.is_floating_point() else torch.equal(a, b)
                for a, b in pairs), "path H: the batched chunks differ from the loop form")
    require(diags.scales.shape == (CHUNKS,), f"path H: {diags.scales.shape[0]} chunks")
    obs = diags.num_ratio_obs.tolist()
    require(min(obs) >= 8, f"path H: a boundary has fewer than 8 scale samples: {obs}")
    require(bool(torch.isfinite(traj).all()), "path H: non-finite poses")

    # Against serial path B, in camera poses in frame-0 coordinates.
    def poses(t):
        return np.linalg.inv(absolute_from_relative(t.cpu().numpy()).astype(np.float64))

    orient, ratio = relative_errors(poses(traj), poses(serial_traj))
    e_theta = float(np.abs(orient).mean())
    spread = float(np.abs(ratio / np.median(ratio) - 1.0).max())
    require(e_theta < 1e-4, f"path H: mean |e_theta| against path B {e_theta} >= 1e-4")
    require(spread <= CHUNK_RATIO_TOL,
            f"path H: a translation ratio to path B is {spread} off their median")

    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        chunked()
        sync(device)
        seconds.append(time.perf_counter() - t0)
    fps = pts.shape[0] / statistics.median(seconds)
    print(json.dumps({"path_h": {
        "frames": pts.shape[0], "slots": pts.shape[1], "chunks": CHUNKS, "starts": list(starts),
        "chunk_len": length, "scales": diags.scales.tolist(),
        "rot_consistency": diags.rot_consistency.tolist(), "num_ratio_obs": obs,
        "e_theta_mean_vs_path_b": e_theta, "ratio_median_vs_path_b": float(np.median(ratio)),
        "ratio_spread_vs_path_b": spread, "map_landmarks": int(map_state.count),
        "map_sha256": fold_sha,
        "seconds": seconds, "frames_per_s": fps, "path_b_frames_per_s": serial_fps,
        "launches": launches}}))
    print(f"path H frames/s: {fps:.1f} chunked ({CHUNKS} chunks of {length} from {list(starts)}), "
          f"path B {serial_fps:.1f} serial (median of {reps})")
    return launches


def corridor(device):
    """Path F(2)'s problem: ``generate_ba_corridor(f=512, l=100_000)``, the
    production point of benchmarks/bench_sparse_ba.py:38-47."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    k, problem, n_live = synthetic.generate_ba_corridor(f=BA_POSES, l=BA_LANDMARKS, device=device)
    return torch.from_numpy(k).to(device), problem, n_live


def compare_sparse_ba_kernels(problem, device, table, reps: int = 10, launch_reps: int = 50):
    """K9 and K10 at the shapes a sparse-BA step gives them: the corridor's
    own frame ids (masked observations dropped through id T) and pose rows;
    K9 at R = 36 and 6 with random rows beside ``index_add_``, K10 at R = 12
    (the pose rows) and 6 beside ``index_select``."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import gather_kernel, segsum_kernel
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_times

    f = problem.poses.shape[0]
    n = problem.uv.shape[0]
    rng = np.random.default_rng(0)
    seg = torch.where(problem.obs_mask, problem.frame_idx, f).to(torch.int32).contiguous()
    seg64 = seg.long()
    plan = segsum_kernel.plan_segments(seg, f)     # made once, as a BA run makes it
    row = dict(max_abs_err=0.0)
    for r in (36, 6):
        vals = torch.from_numpy(rng.normal(size=(n, r)).astype(np.float32)).to(device)
        got = segsum_kernel.segment_sum_small_cuda(vals, seg, f, plan)
        again = segsum_kernel.segment_sum_small_cuda(vals, seg, f, plan)
        ref = segsum_kernel.segment_sum_small_plain(vals, seg, f, plan)
        lib = torch.zeros((f + 1, r), device=device).index_add_(0, seg64, vals)[:f]
        err = float((got - ref).abs().max())
        require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                f"K9 R={r}: two launches gave different bits")
        require(torch.equal(got, ref), f"K9 R={r}: sums differ from the plain version by {err}")
        require(bool(torch.isclose(got, lib, rtol=K9_RTOL, atol=K9_ATOL).all()),
                f"K9 R={r}: sums differ from index_add_ beyond rtol {K9_RTOL}, atol {K9_ATOL}")

        def library():
            return torch.zeros((f + 1, r), device=device).index_add_(0, seg64, vals)

        row[f"r{r}"] = dict(
            ms=time_ms(lambda: segsum_kernel.segment_sum_small_cuda(vals, seg, f, plan), device,
                       reps),
            ms_plan_included=time_ms(lambda: segsum_kernel.segment_sum_small_cuda(vals, seg, f),
                                     device, reps),
            plain_ms=time_ms(lambda: segsum_kernel.segment_sum_small_plain(vals, seg, f, plan),
                             device, reps),
            library_ms=time_ms(library, device, reps),
            **roofline_bound(roofline.segment_sum_model(n, f, r), device),
            max_abs_err=err, run_to_run_identical_bits=True,
            max_abs_diff_vs_index_add=float((got - lib).abs().max()))
        row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update({k: v for k, v in row["r36"].items() if k != "max_abs_err"})
    row.update(rows=n, segments=f)
    table["segment_sum"] = row

    # K10 as a step calls it: R=12, the (F, 12) pose rows read as their
    # strided transpose into (12, N); R=6, an (F, 6) CG vector the same way
    # into (N, 6). Each beside index_select on the same table layout.
    idx = torch.where(problem.obs_mask, problem.frame_idx, 0).contiguous()
    idx64 = idx.long()
    tab12 = problem.poses[:, :3, :4].reshape(f, 12)
    vec6 = torch.from_numpy(rng.normal(size=(f, 6)).astype(np.float32)).to(device)
    edge = torch.tensor([-7, 0, f - 1, f, 2**30], dtype=torch.int32, device=device)
    row = dict(max_abs_err=0.0)
    for r, rows, transpose_out in ((12, tab12, False), (6, vec6, True)):
        for tab in (rows.T, rows.T.contiguous()):
            for ix in (idx, edge):
                require(torch.equal(gather_kernel.take_table_cuda(tab, ix, transpose_out),
                                    gather_kernel.take_table_plain(tab, ix, transpose_out)),
                        f"K10 R={r} (contiguous={tab.is_contiguous()}): "
                        "the gather differs from the plain version")
        tab = rows.T

        def library():
            return (torch.index_select(rows, 0, idx64) if transpose_out
                    else torch.index_select(tab, 1, idx64))

        row[f"r{r}"] = dict(
            launch_times(lambda: gather_kernel.take_table_cuda(tab, idx, transpose_out),
                         device, launch_reps),
            plain_ms=time_ms(lambda: gather_kernel.take_table_plain(tab, idx, transpose_out),
                             device, reps),
            **roofline_bound(roofline.take_table_model(n, f, r), device),
            **prefixed("library_", launch_times(library, device, launch_reps)))
    row.update(row["r12"])
    row.update(columns=n, table_columns=f)
    table["take_table"] = row


def compare_wide_sparse_ba(device, table, poses: int = 1536, landmarks: int = 20_000,
                           cg: int = 10):
    """Sparse BA past the 1,024 poses K9 and K10 once refused:
    ``generate_ba_corridor(f=1536, l=20,000)``, packed, one step of ``cg``
    CG iterations on the card (K9/K10 launch counts reckoned) against the
    same step on the CPU through the plain frame helpers, at the tolerances
    of tests/test_torch_cuda.py::test_sparse_ba_step_past_1024_poses_on_the_card:
    landmarks 5e-4, rotations 1e-4, chi 1e-4 relative, translations 1e-4 or
    the CPU step's own distance from its float64 twin if that is larger."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import sparse_ba
    from visual_odometry_tpu_torch.utils import synthetic

    k, problem, n_live = synthetic.generate_ba_corridor(f=poses, l=landmarks)
    k = torch.from_numpy(k)
    work, degree = sparse_ba.pack_problem(problem)
    kw = dict(cg_iterations=cg, cg_tolerance=0.0, lm_degree=degree)
    ref, ref_stats = sparse_ba.sparse_ba_step(k, work, **kw)
    w64 = work._replace(poses=work.poses.double(), landmarks=work.landmarks.double(),
                        uv=work.uv.double())
    exact, _ = sparse_ba.sparse_ba_step(k.double(), w64, **kw)
    on_card = sparse_ba.SparseBAProblem(*(x.to(device) for x in work))
    _lib.reset_launches()
    got, stats = sparse_ba.sparse_ba_step(k.to(device), on_card, **kw)
    sync(device)
    ran = (_lib.launches["take_table"], _lib.launches["segment_sum"])
    require(ran == (2 + cg, 4 + cg), f"wide sparse BA: K10/K9 launched {ran}, "
                                     f"reckoned {(2 + cg, 4 + cg)}")
    diff = (got.poses.cpu() - ref.poses).abs()
    rot_err, t_err = float(diff[:, :3, :3].max()), float(diff[:, :3, 3].max())
    t_tol = max(1e-4, float((ref.poses[:, :3, 3] - exact.poses[:, :3, 3]).abs().max()))
    lm_err = float((got.landmarks.cpu() - ref.landmarks).abs().max())
    chi_rel = abs(float(stats.chi) - float(ref_stats.chi)) / float(ref_stats.chi)
    require(rot_err <= 1e-4 and t_err <= t_tol and lm_err <= 5e-4 and chi_rel <= 1e-4,
            f"wide sparse BA: the card's step differs from the CPU's (rotations {rot_err}, "
            f"translations {t_err} against {t_tol}, landmarks {lm_err}, chi {chi_rel} relative)")
    table["segment_sum"]["wide_sparse_ba"] = dict(
        poses=poses, landmarks=landmarks, observations=n_live, cg_iterations=cg,
        rotation_max_abs_diff_vs_cpu=rot_err, translation_max_abs_diff_vs_cpu=t_err,
        translation_tolerance=t_tol, landmark_max_abs_diff_vs_cpu=lm_err,
        chi_rel_diff_vs_cpu=chi_rel)
    print(f"sparse BA at {poses} poses on the card: translations within {t_err:.2e} "
          f"(tolerance {t_tol:.2e}), landmarks within {lm_err:.2e} of the CPU step")


def linearize_problem(n: int, device, seed: int = 0):
    """The workload of benchmarks/bench_picp.py: uniform points, the default
    camera at the identity, uniform measurements, every weight 1."""
    import torch

    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(1, 4, n)],
                     axis=1).astype(np.float32)
    meas = rng.uniform(0, 480, (n, 2)).astype(np.float32)
    cam = synthetic.default_camera(device=device)
    return cam, tuple(torch.from_numpy(x).to(device)
                      for x in (world, meas, np.ones(n, np.float32)))


def compare_linearize(device, table, reps: int = 10, launch_reps: int = 50):
    """K11 against its plain version at N = 1024 and N = 8192 (4 and 32 CTAs
    of 256 threads), robust kernel thresholds that keep and that split the
    points, ``keep_outliers`` both ways, bit for bit expected; two launches
    with the same bits. Each row: the wrapper's ms, the launch alone with its
    inputs prepared (launch_times), the geometry, the byte bound and the
    launch floor beside it."""
    from visual_odometry_tpu_torch.ops.kernels import picp_kernel
    from visual_odometry_tpu_torch.utils import roofline
    from visual_odometry_tpu_torch.utils.roofline import launch_floor, launch_times

    floor = launch_floor(device, launch_reps)
    row = dict(max_abs_err=0.0, library_ms=None, bitwise=True)
    for n in (1024, 8192):
        cam, pts = linearize_problem(n, device)
        head = (cam.camera_matrix, cam.world_in_camera, cam.params())
        err, bitwise = 0.0, True
        for kt, keep in ((1e4, False), (2e3, True)):
            h, b, st = picp_kernel.linearize(*head, *pts, kt, keep, backend="cuda")
            hp, bp, stp = picp_kernel.linearize_plain(*head, *pts, kt, keep)
            scale = float(hp.abs().max())
            err = max(err, float((h - hp).abs().max()) / scale,
                      float((b - bp).abs().max()) / max(float(bp.abs().max()), 1.0))
            require(err <= K11_RTOL, f"K11 N={n}: H or b differs from the plain version by {err}")
            require(int(st.num_inliers) == int(stp.num_inliers) and 0 < int(st.num_inliers) < n,
                    f"K11 N={n}: inlier counts differ or the threshold split nothing")
            bitwise = bitwise and same_bits((h, hp), (b, bp), *zip(st, stp))
            again = picp_kernel.linearize(*head, *pts, kt, keep, backend="cuda")
            require(same_bits((h, again[0]), (b, again[1]), *zip(st, again[2])),
                    f"K11 N={n}: two launches gave different bits")
        ctas, threads = picp_kernel.linearize_geometry(n)
        prepared = tuple(x.contiguous() for x in head) + pts + (1e4, False)
        alone = launch_times(lambda: picp_kernel._linearize_cuda(*prepared), device, launch_reps)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["bitwise"] = row["bitwise"] and bitwise
        row[f"n{n}"] = dict(
            ms=time_ms(lambda: picp_kernel.linearize(*head, *pts, 1e4, backend="cuda"), device,
                       reps),
            launch_ms=alone["ms"], device_ms=alone["device_ms"], host_ms=alone["host_ms"],
            plain_ms=time_ms(lambda: picp_kernel.linearize_plain(*head, *pts, 1e4), device, 3),
            **roofline_bound(roofline.linearize_model(n), device), launch_floor=floor,
            bitwise=bitwise, ctas=ctas, threads=threads, cluster=1)
    row.update(row["n8192"])
    table["picp_linearize"] = row


def run_utils_phase(device) -> dict:
    """utils/selfcheck's eight checks on the card, each check's kernels
    launched (counted from the reset before its kernel side to its end), then
    utils/roofline's measure() and measure_sparse_ba() with the card's spec;
    every roofline fraction and mfu must lie in (0, 1]."""
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import roofline, selfcheck

    checks, launches = {}, {}
    for check in selfcheck.CHECKS:
        name = check.__name__
        checks.update(check(device))
        launches[name] = {k: _lib.launches[k] for k in selfcheck.LAUNCHES[name]}
        require(all(launches[name].values()), f"{name}: a kernel never launched: {launches[name]}")
    print(json.dumps({"selfcheck": dict(checks, launches_from_kernel_side=launches)}))
    out = roofline.measure(device)
    out.update((k, v) for k, v in roofline.measure_sparse_ba(device).items()
               if k.startswith("sparse_ba_"))
    shares = {k: v for k, v in out.items() if k.endswith(("_roofline_fraction", "_mfu"))}
    require(len(shares) == 5 and all(0.0 < v <= 1.0 for v in shares.values()),
            f"roofline: a fraction outside (0, 1]: {shares}")
    print(json.dumps({"roofline": out}))
    return out


def read_launches(names, label: str, must: bool = True):
    from visual_odometry_tpu_torch.ops.kernels import _lib

    launches = dict(_lib.launches)
    if must:
        require(all(launches[n] > 0 for n in names), f"{label}: a kernel never ran: {launches}")
    return launches


def check_accuracy(res, label: str):
    finite = np.isfinite(res.orientation_errors)
    e_theta = float(np.abs(res.orientation_errors[finite]).mean())
    require(e_theta < 1e-4, f"{label}: mean |e_theta| {e_theta} >= 1e-4")
    require(res.rmse_position < 0.2, f"{label}: rmse_position {res.rmse_position} >= 0.2")
    require(res.n_map_matched > 100, f"{label}: only {res.n_map_matched} map landmarks matched")
    return {"e_theta_mean": e_theta, "rmse_position": res.rmse_position,
            "rmse_map": res.rmse_map, "n_map_matched": res.n_map_matched}


def run_path_a(work_dir: str, device, require_launches: bool = True):
    """The reference-format applications on a generated dataset."""
    import torch

    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib, matcher_kernel
    from visual_odometry_tpu_torch.utils import dataset_gen, io
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    data = os.path.join(work_dir, "data")
    outs = {n: os.path.join(work_dir, n)
            for n in ("complete", "chunked", "se2", "daknown", "reloc")}
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    report = {}
    _lib.reset_launches()
    apps.run_vo_complete(data, outs["complete"], device=device, verbose=True)
    sync(device)
    read_launches(MAIN_PATH, "path A vo_complete", require_launches)
    report["vo_complete"] = check_accuracy(apps.run_evaluation(data, outs["complete"]), "path A")
    diags = apps.run_vo_complete(data, outs["chunked"], DEFAULT_CONFIG.replace(num_chunks=2),
                                 device=device, verbose=True)[2]
    report["vo_complete_chunked"] = check_accuracy(apps.run_evaluation(data, outs["chunked"]),
                                                   "path A chunked")
    report["vo_complete_chunked"]["scales"] = diags.scales.tolist()

    traj_se2 = apps.run_vo_se2(data, outs["se2"], device=device, verbose=True)[0]
    report["vo_se2"] = check_accuracy(apps.run_evaluation(data, outs["se2"]), "path A vo_se2")
    mount = torch.from_numpy(io.load_camera_params(os.path.join(data, "camera.dat")).cam_in_robot)
    dev_se2 = se3.planar_deviation(torch.from_numpy(traj_se2), mount)
    report["vo_se2"]["planar_subgroup_dev"] = dev_se2
    require(dev_se2 < PLANAR_DEV_TOL, f"path A vo_se2: planar deviation {dev_se2}")

    traj_known = apps.run_vo_da_known(data, outs["daknown"], device=device, verbose=True)[0]
    require(bool(np.isfinite(traj_known).all()), "path A vo_daknown: non-finite poses")
    require(os.path.getsize(os.path.join(outs["daknown"], "time_known.txt")) > 0,
            "path A vo_daknown: time_known.txt is empty")

    for precision in ("highest", "fast"):
        with recording(matcher_kernel, "best_match") as matches:
            rows = apps.run_relocalize(data, outs["reloc"], every=10, device=device,
                                       config=DEFAULT_CONFIG.replace(matcher_precision=precision))
        require(len(rows) == 3, f"path A relocalize: {len(rows)} rows")
        for f, err_t, err_r, n_matches, n_inliers in rows:   # tests/test_relocalize.py:91-92
            require(err_t < 0.05 and err_r < 1e-3,
                    f"path A relocalize ({precision}) frame {f}: {err_t}, {err_r}")
        report["relocalize_" + precision] = [list(r) for r in rows]
        report["relocalize_" + precision + "_vs_plain"] = hold_matches_to_plain(
            matches, precision == "fast", len(rows), f"path A relocalize ({precision})")
    sync(device)
    launches = read_launches(PATH_A, "path A", require_launches)
    app_launches = run_path_a_apps(data, work_dir, device, require_launches)
    launches = {k: launches[k] + app_launches[k] for k in launches}
    report["launches"] = launches
    print(json.dumps({"path_a": report}))
    return launches


@contextlib.contextmanager
def recording(module, name: str):
    """Records every call of ``module.name`` made inside the block as
    (args, kwargs, result) in the list it yields."""
    fn, calls = getattr(module, name), []

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def hold_folds_to_plain(calls, label: str) -> str:
    """Each recorded ``landmark_map.merge_stream`` call run again through the
    plain fold (``backend="torch"``) on the same card tensors: the maps' bits
    must be equal, so the map keeps the SHA-256 the plain fold gave before
    P2. Returns the SHA-256 of the last call's map."""
    from visual_odometry_tpu_torch.models import landmark_map

    sha = ""
    for args, kwargs, out in calls:
        plain = landmark_map.merge_stream(*args, **dict(kwargs, backend="torch"))
        sha = digest(out)
        require(sha == digest(plain), f"{label}: P2's map differs from the plain fold's")
    return sha


def hold_solves_to_plain(calls, label: str) -> float:
    """Each recorded K6 solve (picp_kernel.solve_fused) run again through its
    plain version on the same card tensors: the poses within GN_POSE_TOL and
    the inlier counts equal. Returns the largest pose difference."""
    from visual_odometry_tpu_torch.ops.kernels import picp_kernel

    require(len(calls) > 0, f"{label}: no K6 solve was recorded")
    err = 0.0
    for f, (args, kwargs, (pose, stats)) in enumerate(calls):
        kw = {k: v for k, v in kwargs.items() if k != "backend"}
        pose_p, stats_p = picp_kernel.solve_fused_plain(*args, **kw)
        e = float((pose - pose_p).abs().max())
        require(e <= GN_POSE_TOL, f"{label}: solve {f} is {e} off its plain version")
        require(int(stats.num_inliers) == int(stats_p.num_inliers),
                f"{label}: solve {f} has {int(stats.num_inliers)} inliers, its plain version "
                f"{int(stats_p.num_inliers)}")
        err = max(err, e)
    return err


def hold_matches_to_plain(calls, fast: bool, expected: int, label: str) -> dict:
    """Each recorded K7 call (matcher_kernel.best_match) run again through
    best_match_plain on the same card tensors: indices and distances bit for
    bit. ``expected`` calls, each on the card and in the given mode, are
    required. Returns the calls' shapes and the largest distance difference."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import matcher_kernel

    require(len(calls) == expected, f"{label}: {len(calls)} K7 calls recorded, not {expected}")
    shapes, err = [], 0.0
    for c, (args, kwargs, (dist, idx)) in enumerate(calls):
        require(args[0].is_cuda and kwargs.get("fast", False) == fast,
                f"{label}: call {c} ran on {args[0].device} with fast={kwargs.get('fast')}")
        dist_p, idx_p = matcher_kernel.best_match_plain(*args, fast=fast)
        live = dist_p < 1e38
        if bool(live.any()):
            err = max(err, float((dist - dist_p)[live].abs().max()))
        require(torch.equal(idx, idx_p) and same_bits((dist, dist_p)),
                f"{label}: call {c} differs from best_match_plain (max |d dist| {err})")
        shapes.append([args[0].shape[0], args[2].shape[0]])
    return {"calls": len(calls), "shapes": shapes, "max_abs_err_vs_plain": err}


def hold_tree_to_plain(builds, matches, label: str) -> None:
    """kdtree_test's tree built again on the CPU, its node sums by K9's plain
    version: the same leaves as the card's tree (an eigenvector's sign may
    differ between eigensolvers, so codes are not compared), and the same
    best_match_fast indices and found flags on the same queries."""
    import torch

    from visual_odometry_tpu_torch.ops import pca_tree

    require(len(builds) == 1 and len(matches) == 1,
            f"{label}: {len(builds)} builds and {len(matches)} matches recorded")
    def cpu_(a):
        return a.cpu() if torch.is_tensor(a) else a

    args, kw, card = builds[0]
    cpu = pca_tree.build_tree(*map(cpu_, args), **kw)

    def leaves(codes):
        codes = codes.cpu().numpy()
        return {frozenset(np.flatnonzero(codes == c).tolist())
                for c in np.unique(codes[codes >= 0])}

    require(leaves(card.codes) == leaves(cpu.codes), f"{label}: the leaves differ from the CPU's")
    args, kw, got = matches[0]
    want = pca_tree.best_match_fast(cpu, *map(cpu_, args[1:]), **kw)
    for name, g, w in zip(("indices", "found flags"), got, want):
        require(torch.equal(g.cpu(), w), f"{label}: best_match_fast's {name} differ from the CPU's")


def run_path_a_apps(data: str, work_dir: str, device, require_launches: bool = True):
    """The reference's remaining programs on the card: the dataset apps on
    path A's dataset and the synthetic apps at the JAX package's defaults,
    each kernel call held to its plain version on the same inputs, and the
    native loader against numpy on path A's dataset and on one of the
    reference example's size. The counters are zeroed before each app and
    read after it; each app must launch its own kernels. Returns the
    launches summed over the apps."""
    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops import pca_tree
    from visual_odometry_tpu_torch.ops.kernels import _lib, picp_kernel
    from visual_odometry_tpu_torch.utils import dataset_gen, evaluation, io

    report, total = {}, {k: 0 for k in _lib.launches}

    def run(name, fn, needs=()):
        _lib.reset_launches()
        t0 = time.perf_counter()
        with recording(picp_kernel, "solve_fused") as solves:
            out = fn()
            sync(device)
        report[name] = {"seconds": time.perf_counter() - t0}
        got = read_launches(needs, f"path A {name}", require_launches)
        report[name]["launches"] = {k: v for k, v in got.items() if v}
        for k in total:
            total[k] += got[k]
        if "picp_solve" in needs:
            t0 = time.perf_counter()
            report[name]["max_abs_err_vs_plain"] = hold_solves_to_plain(solves, f"path A {name}")
            report[name]["plain_seconds"] = time.perf_counter() - t0
            report[name]["solves_vs_plain"] = len(solves)
        return out

    out = os.path.join(work_dir, "apps")
    x, tri = run("real_init", lambda: apps.run_real_init(data, out, verbose=False, device=device))
    require(len(tri) >= 50, f"path A real_init: {len(tri)} triangulated points")
    for name in ("world.txt", "triangulated.txt"):
        require(os.path.getsize(os.path.join(out, name)) > 0, f"path A real_init: no {name}")
    report["real_init"]["triangulated"] = len(tri)

    poses = run("picp_known_real", lambda: apps.run_picp_known_real(
        data, out, verbose=False, device=device), ("picp_solve",))
    params = io.load_camera_params(os.path.join(data, "camera.dat"))
    gt = io.gt_poses_se3(io.load_trajectory(os.path.join(data, "trajectory.dat"))[1])
    res = evaluation.evaluate(io.robot_trajectory(poses, params.cam_in_robot), gt)
    require(abs(res.scale - 1.0) < 1e-3 and res.rmse_position < 1e-3,   # tests/test_apps.py:25-37
            f"path A picp_known_real: scale {res.scale}, RMSE {res.rmse_position}")
    k6 = report["picp_known_real"]["launches"].get("picp_solve", 0)
    require(k6 == len(poses) or not require_launches,
            f"path A picp_known_real: {k6} K6 launches for {len(poses)} frames")
    require(report["picp_known_real"]["solves_vs_plain"] == len(poses),
            "path A picp_known_real: not every frame's solve was held to its plain version")
    report["picp_known_real"].update(scale=res.scale, rmse_position=res.rmse_position)

    a_set, g_set = run("compute_corr", lambda: apps.run_compute_corr(
        data, verbose=False, device=device), ("match_pairs",))
    require(a_set == g_set and len(a_set) > 50,
            f"path A compute_corr: {len(a_set)} appearance pairs, {len(g_set)} id pairs, "
            f"{len(a_set & g_set)} agree")
    report["compute_corr"]["pairs"] = len(a_set)
    run("read_data_test", lambda: apps.run_read_data_test(data))

    x, x_gt = run("init", lambda: apps.run_init_synthetic(num_points=1000, verbose=False,
                                                          device=device))
    ratio = x[:3, 3] / x_gt[:3, 3]
    r_err = float(np.abs(x[:3, :3] - x_gt[:3, :3]).max())
    require(r_err < 5e-3 and np.abs(ratio - ratio.mean()).max() < 1e-2 * abs(ratio.mean()),
            f"path A init: R off by {r_err}, t ratios {ratio}")   # tests/test_apps.py:60-65
    report["init"].update(r_err=r_err, t_ratio=ratio.tolist())

    x, x_gt = run("picp_test", lambda: apps.run_picp_synthetic(
        num_points=1000, iterations=1000, verbose=False, device=device), ("picp_solve",))
    r_err, t_err = (float(np.abs(x[:3, c] - x_gt[:3, c]).max()) for c in (slice(0, 3), 3))
    require(r_err < 1e-3 and t_err < 1e-2, f"path A picp_test: R {r_err}, t {t_err}")
    report["picp_test"].update(r_err=r_err, t_err=t_err)

    x, x_gt = run("whole_test", lambda: apps.run_whole_synthetic(
        num_points=1000, verbose=False, device=device), ("picp_solve",))
    r_err = float(np.abs(x[:3, :3] - x_gt[:3, :3]).max())
    require(r_err < 1e-2, f"path A whole_test: R off by {r_err}")
    report["whole_test"]["r_err"] = r_err

    with recording(pca_tree, "build_tree") as builds, \
            recording(pca_tree, "best_match_fast") as matches:
        correct = run("kdtree_test", lambda: apps.run_kdtree_test(
            num_points=500, verbose=False, device=device), ("segment_sum",))
    require(correct.mean() > 0.9, f"path A kdtree_test: {correct.mean()} correct")
    hold_tree_to_plain(builds, matches, "path A kdtree_test")
    report["kdtree_test"].update(correct=float(correct.mean()), max_abs_err_vs_plain=0.0)

    big = os.path.join(work_dir, "data_121")
    dataset_gen.generate_dataset(big, num_frames=121, num_landmarks=1000, seed=2)
    loader = {}
    for label, d in (("path_a", data), ("121x1000", big)):
        seqs, times = {}, {}
        for parser in ("native", "numpy"):    # the parser was built by path A's first load
            samples = []
            for _ in range(3):
                t0 = time.perf_counter()
                seqs[parser] = io.load_sequence(d, None, parser=parser)
                samples.append(time.perf_counter() - t0)
            times[parser + "_s"] = statistics.median(samples)
        for f in ("points", "appearances", "ids", "mask", "counts"):
            a, b = getattr(seqs["native"], f), getattr(seqs["numpy"], f)
            require(a.dtype == b.dtype and np.array_equal(a, b),
                    f"native loader: {f} differs from numpy's on {label}")
        loader[label] = {"frames": len(seqs["numpy"].counts), **times}
        print(f"loader {label}: native {times['native_s'] * 1e3:.2f} ms, numpy "
              f"{times['numpy_s'] * 1e3:.2f} ms (medians of 3), identical arrays")
    report["native_loader"] = loader
    print(json.dumps({"path_a_apps": report}))
    return total


def run_path_b(camera, config, pts, apps, masks, device, require_launches: bool = True,
               reps: int = 3):
    """Full-width tracking through the kernels, held against the plain versions;
    its map fold (P2) bit for bit against the plain fold on the same call."""
    import torch

    from visual_odometry_tpu_torch.models import landmark_map, pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib

    _lib.reset_launches()
    with recording(landmark_map, "merge_stream") as folds:
        traj, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, masks)
    sync(device)
    launches = read_launches(MAIN_PATH, "path B", require_launches)
    if require_launches:
        require(launches["gather_rows"] == K3_PATH_LAUNCHES and launches["map_fold"] == 1,
                f"path B: K3 must launch {K3_PATH_LAUNCHES} times and P2 once: {launches}")
    fold_sha = hold_folds_to_plain(folds, "path B")
    require(bool(torch.isfinite(traj).all()), "path B: non-finite poses")
    plain = config.replace(matcher_backend="torch", scan_backend="torch")
    traj_p, map_p, _ = pipeline.run_sequence(camera, plain, pts, apps, masks)
    err = float((traj - traj_p).abs().max())
    require(err <= K4_POSE_TOL, f"path B: kernel and plain trajectories differ by {err}")
    require(int(map_state.count) == int(map_p.count), "path B: map sizes differ")

    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        traj, map_state, outs = pipeline.run_sequence(camera, config, pts, apps, masks)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    frames = pts.shape[0]
    fps = frames / statistics.median(seconds)
    print(json.dumps({"path_b": {"frames": frames, "slots": pts.shape[1],
                                 "traj_max_abs_err_vs_plain": err,
                                 "map_landmarks": int(map_state.count),
                                 "map_sha256": fold_sha,
                                 "inliers_mean": float(outs.num_inliers.float().mean()),
                                 "seconds": seconds, "launches": launches}}))
    print(f"path B frames/s: {fps:.1f} ({frames} frames x {pts.shape[1]} slots, median of {reps})")
    return launches, traj, fps


def path_c_inputs(device, map_rows: int, queries: int):
    """The relocalization workload of benchmarks/bench_reloc.py:43-69: a map of
    ``map_rows`` landmarks, one frame of ``queries`` drawn from it and projected
    through the default camera, identity prior. Returns (camera, map, frame,
    prior, each query's own map row)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.models.landmark_map import LandmarkMap
    from visual_odometry_tpu_torch.ops.camera import project_points
    from visual_odometry_tpu_torch.utils import synthetic

    rng = np.random.default_rng(0)
    world = np.stack([rng.uniform(-2.5, 2.5, map_rows), rng.uniform(-2.0, 2.0, map_rows),
                      rng.uniform(2.0, 6.0, map_rows)], axis=1).astype(np.float32)
    keys = rng.uniform(-1.0, 1.0, (map_rows, 10)).astype(np.float32)
    own = torch.from_numpy(rng.integers(0, map_rows, queries)).to(device)
    map_state = LandmarkMap(
        points=torch.from_numpy(world).to(device), appearances=torch.from_numpy(keys).to(device),
        valid=torch.ones(map_rows, dtype=torch.bool, device=device),
        count=torch.tensor(map_rows, dtype=torch.int32, device=device))
    camera = synthetic.default_camera(device=device)
    uv, valid = project_points(camera, map_state.points[own])
    frame = pipeline.FrameData(uv, map_state.appearances[own].contiguous(), valid,
                               torch.full((queries,), -1, dtype=torch.int32, device=device))
    return camera, map_state, frame, torch.eye(4, device=device), own


def run_path_c(device, map_rows: int = 1 << 20, queries: int = 1024,
               require_launches: bool = True, reps: int = 3):
    """Map-scale relocalization (the workload of benchmarks/bench_reloc.py):
    one frame of queries drawn from the map and projected through the default
    camera, identity prior, both matcher precisions; then the standalone planar
    solve at N = 8 x queries through its public entry point."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops import matching
    from visual_odometry_tpu_torch.ops.kernels import _lib, picp_kernel
    from visual_odometry_tpu_torch.utils.config import VOConfig

    camera, map_state, frame, x0, own = path_c_inputs(device, map_rows, queries)
    valid = frame.mask

    def config(precision):
        return VOConfig(n_slots=queries, map_capacity=map_rows, gn_iterations=30,
                        matcher_precision=precision)

    report, launches = {}, {}
    for precision in ("highest", "fast"):
        _lib.reset_launches()
        pose, stats, n_matches = pipeline.relocalize_frame(camera, config(precision), map_state,
                                                           frame, x0)
        sync(device)
        key = "best_match_fast" if precision == "fast" else "best_match"
        ran = dict(_lib.launches)
        if require_launches:
            require(ran[key] == 1 and ran["picp_solve"] == 1,
                    f"path C ({precision}): K7 and K6 must launch once each: {ran}")
        launches[key] = ran[key]
        launches["picp_solve"] = launches.get("picp_solve", 0) + ran["picp_solve"]
        _, idx = matching.best_match(frame.appearances, frame.mask, map_state.appearances,
                                     map_state.valid, precision=precision)
        require(bool((idx[valid] == own[valid]).all()),
                f"path C ({precision}): a query missed its own map row")
        require(int(n_matches) == int(valid.sum()), f"path C ({precision}): match count")
        err = float((pose - x0).abs().max())
        require(bool(torch.isfinite(pose).all()) and err < 1e-3,
                f"path C ({precision}): pose is {err} from identity")
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pipeline.relocalize_frame(camera, config(precision), map_state, frame, x0)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        report[precision] = {"pose_err": err, "matches": int(n_matches),
                             "inliers": int(stats.num_inliers), "seconds": seconds,
                             "queries_per_s": queries / statistics.median(seconds)}

    # The planar standalone solve has no caller in the pipeline (as in the JAX
    # package): it is driven here through its public entry point.
    args, gt = solve_problem(8 * queries, True, device, seed=1)
    _lib.reset_launches()
    pose, stats = picp_kernel.solve_se2_fused(*args)
    sync(device)
    launches["picp_solve_se2"] = _lib.launches["picp_solve_se2"]
    if require_launches:
        require(launches["picp_solve_se2"] == 1, "path C: the planar solve did not launch")
    err = float((pose.cpu() - gt).abs().max())
    require(err < 5e-3, f"path C planar solve: {err} from the ground-truth pose")
    report["solve_se2"] = {"n": 8 * queries, "pose_err": err, "inliers": int(stats.num_inliers)}
    launches = {k: launches.get(k, 0) for k in KERNELS}
    report["launches"] = launches
    print(json.dumps({"path_c": report}))
    for precision in ("highest", "fast"):
        print(f"path C queries/s ({precision}): {report[precision]['queries_per_s']:.0f} "
              f"({queries} queries x {map_rows} map rows, median of {reps})")
    return launches


def run_path_d(camera, planar, pts, apps, masks, device, require_launches: bool = True,
               reps: int = 3):
    """The planar estimation group at full width (path_d_inputs), kernels only."""
    import torch

    from visual_odometry_tpu_torch.models import landmark_map, pipeline
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib

    mount = torch.from_numpy(planar.planar_mount())
    _lib.reset_launches()
    with recording(landmark_map, "merge_stream") as folds:
        traj, map_state, outs = pipeline.run_sequence(camera, planar, pts, apps, masks)
    sync(device)
    launches = read_launches(("match_pairs", "join_candidates", "gather_rows",
                              "track_frames_planar", "map_fold"), "path D", require_launches)
    if require_launches:
        require(launches["track_frames_planar"] == 1 and launches["track_frames"] == 0
                and launches["gather_rows"] == K3_PATH_LAUNCHES and launches["map_fold"] == 1,
                f"path D: K5 and P2 must launch once, K4 not at all, K3 {K3_PATH_LAUNCHES} "
                f"times: {launches}")
    fold_sha = hold_folds_to_plain(folds, "path D")
    require(bool(torch.isfinite(traj).all()), "path D: non-finite poses")
    dev = se3.planar_deviation(traj.cpu(), mount)
    require(dev < PLANAR_DEV_TOL, f"path D: planar-subgroup deviation {dev}")
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pipeline.run_sequence(camera, planar, pts, apps, masks)
        sync(device)
        seconds.append(time.perf_counter() - t0)
    frames = pts.shape[0]
    print(json.dumps({"path_d": {"frames": frames, "slots": pts.shape[1],
                                 "planar_subgroup_dev": dev,
                                 "map_landmarks": int(map_state.count),
                                 "map_sha256": fold_sha,
                                 "inliers_mean": float(outs.num_inliers.float().mean()),
                                 "seconds": seconds, "launches": launches}}))
    print(f"path D frames/s: {frames / statistics.median(seconds):.1f} "
          f"({frames} frames x {pts.shape[1]} slots, planar, median of {reps})")
    return launches


def run_resume(camera, config, pts, apps, masks, device, work_dir: str, split: int = 256,
               require_launches: bool = True):
    """initialize on frames 0/1, then continue_sequence once over the rest
    against twice over two halves with a checkpoint round trip between them
    (tests/test_checkpoint.py:80-131)."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.utils import checkpoint

    ids = torch.full(masks.shape, -1, dtype=torch.int32, device=masks.device)
    f0 = pipeline.FrameData(pts[0], apps[0], masks[0], ids[0])
    f1 = pipeline.FrameData(pts[1], apps[1], masks[1], ids[1])
    state0, x_init = pipeline.initialize(camera, config, f0, f1)

    def cont(state, lo, hi):
        return pipeline.continue_sequence(camera, config, state, pts[lo:hi], apps[lo:hi],
                                          masks[lo:hi], ids[lo:hi])

    _lib.reset_launches()
    full_state, full = cont(state0, 2, None)
    state_a, out_a = cont(state0, 2, split)
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.join(work_dir, "state.npz")
    traj_a = torch.cat([torch.eye(4, device=device)[None], x_init[None], out_a.pose])
    checkpoint.save_state(path, state_a, traj_a.cpu().numpy())
    state_l, traj_l = checkpoint.load_state(path, device=device)
    require(np.array_equal(traj_l, traj_a.cpu().numpy()), "resume: the trajectory changed on disk")
    state_b, out_b = cont(state_l, split, None)
    sync(device)
    launches = read_launches(MAIN_PATH, "resume", require_launches)

    pose_err = float((full.pose - torch.cat([out_a.pose, out_b.pose])).abs().max())
    require(pose_err <= K4_POSE_TOL, f"resume: split and one-shot poses differ by {pose_err}")
    require(torch.equal(full_state.map.valid, state_b.map.valid)
            and torch.equal(full_state.map.appearances, state_b.map.appearances),
            "resume: map layouts differ")
    require(torch.equal(full_state.point_lookup, state_b.point_lookup),
            "resume: carried lookups differ")
    map_err = float((full_state.map.points - state_b.map.points).abs().max())
    require(map_err <= 1e-4, f"resume: map positions differ by {map_err}")   # test_checkpoint.py:118
    print(json.dumps({"resume": {"split": split, "pose_max_abs_err": pose_err,
                                 "map_pos_max_abs_err": map_err,
                                 "map_landmarks": int(state_b.map.count), "launches": launches}}))
    return launches


def run_step_form(camera, config, pts, apps, masks, device, frames: int = 18,
                  require_launches: bool = True):
    """``scan_backend="step"`` at full width over the head of path B's inputs:
    the frame_step loop solves each tracked frame through one K6 launch and is
    held against the fused K4 launch on the same frames."""
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.ops.kernels import _lib

    head = (pts[:frames], apps[:frames], masks[:frames])
    traj_f, map_f, _ = pipeline.run_sequence(camera, config, *head)
    _lib.reset_launches()
    t0 = time.perf_counter()
    traj_s, map_s, _ = pipeline.run_sequence(camera, config.replace(scan_backend="step"), *head)
    sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(_lib.launches)
    if require_launches:
        require(launches["picp_solve"] == frames - 2 and launches["track_frames"] == 0,
                f"step form: K6 must launch once a tracked frame and K4 not at all: {launches}")
    err = float((traj_s - traj_f).abs().max())
    require(err <= K4_POSE_TOL, f"step form: step and fused trajectories differ by {err}")
    require(int(map_s.count) == int(map_f.count), "step form: map sizes differ")
    print(json.dumps({"step_form": {"frames": frames, "slots": pts.shape[1],
                                    "traj_max_abs_err_vs_fused": err, "seconds": seconds,
                                    "launches": launches}}))
    return launches


def run_path_e(camera, serving, device, require_launches: bool = True, reps: int = 3,
               planar_count: int = 8):
    """Serving at full width: 64 sequences x 128 frames x 128 slots (the shape
    benchmarks/bench_pipeline.py serves, from synthetic data) through
    run_sequences_batched, each sequence held against its own run_sequence;
    then a planar batch of 8 on path D's kind of motion. ``serving`` maps
    planar False/True to (config, the batch of ``serving_inputs``)."""
    import torch

    from visual_odometry_tpu_torch.models import landmark_map, pipeline
    from visual_odometry_tpu_torch.ops import se3
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import multiseq

    report, launches = {}, {k: 0 for k in KERNELS}
    mount = mount_matrix("cpu")
    for planar in (False, True):
        config, seqs = serving[planar]
        if planar:
            seqs = tuple(x[:planar_count].contiguous() for x in seqs)
        count, n_frames, n_slots = seqs[0].shape[:3]
        k8 = "track_frames_batched_planar" if planar else "track_frames_batched"
        label = "path E planar" if planar else "path E"
        _lib.reset_launches()
        with recording(landmark_map, "merge_stream") as folds:
            traj, maps, outs = multiseq.run_sequences_batched(camera, config, *seqs)
        sync(device)
        ran = read_launches(("match_pairs", "join_candidates", "gather_rows", k8, "eight_point"),
                            label, require_launches)
        require(len(folds) == 1, f"{label}: {len(folds)} merge_stream calls, expected one")
        fold_sha = hold_folds_to_plain(folds, label)
        if require_launches:
            want = {"match_pairs": 2, "join_candidates": 1, "gather_rows": K3_PATH_LAUNCHES,
                    k8: 1, "track_frames": 0, "track_frames_planar": 0, "eight_point": 1,
                    "map_fold": 1}
            require(all(ran[k] == v for k, v in want.items()),
                    f"{label}: K1-K3, P1 and P2 must launch once a stage over the batch and K8 "
                    f"once: {ran}")
        for k, v in ran.items():
            launches[k] += v
        require_tracked(outs, traj, n_slots, label)
        err, single_s = 0.0, []
        for i in range(count):
            t0 = time.perf_counter()
            t_i, m_i, _ = pipeline.run_sequence(camera, config, *(x[i] for x in seqs))
            sync(device)
            single_s.append(time.perf_counter() - t0)
            err = max(err, float((traj[i] - t_i).abs().max()))
            require(int(maps.count[i]) == int(m_i.count), f"{label}: sequence {i}'s map size")
        require(err <= K4_POSE_TOL, f"{label}: a sequence is {err} from its own run_sequence")
        if planar:
            dev = max(se3.planar_deviation(traj[i].cpu(), mount) for i in range(count))
            require(dev < PLANAR_DEV_TOL, f"{label}: planar-subgroup deviation {dev}")
        seconds = []
        for _ in range(reps):
            t0 = time.perf_counter()
            multiseq.run_sequences_batched(camera, config, *seqs)
            sync(device)
            seconds.append(time.perf_counter() - t0)
        frames = count * n_frames
        serial = count * statistics.median(single_s)
        report["planar" if planar else "se3"] = {
            "sequences": count, "frames": n_frames, "slots": n_slots,
            "traj_max_abs_err_vs_run_sequence": err,
            "map_landmarks_mean": float(maps.count.float().mean()), "map_sha256": fold_sha,
            "inliers_mean": float(outs.num_inliers.float().mean()), "seconds": seconds,
            "frames_per_s": frames / statistics.median(seconds),
            "single_sequence_seconds_median": statistics.median(single_s),
            "sequences_x_single_seconds": serial, "frames_per_s_serial": frames / serial,
            "launches": ran}
        print(f"{label} frames/s: {frames / statistics.median(seconds):.1f} batched, "
              f"{frames / serial:.1f} as {count} x run_sequence ({count} sequences x "
              f"{n_frames} frames x {n_slots} slots, median of {reps})")
    report["launches"] = launches
    print(json.dumps({"path_e": report}))
    return launches


def run_path_f(work_dir: str, device, ba_problem, require_launches: bool = True):
    """Refinement: (1) path A's dataset through vo_complete with 5 refinement
    iterations, sparse and dense, and the evaluation; (2) ``BA_STEPS`` steps of
    sparse bundle adjustment at 512 poses x 100,000 landmarks, packed and
    unpacked, under a fixed budget of ``BA_CG`` CG iterations (tolerance 0)."""
    import torch

    from visual_odometry_tpu_torch import apps
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import sparse_ba
    from visual_odometry_tpu_torch.utils import dataset_gen
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    data = os.path.join(work_dir, "data_f")
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    report, launches = {}, {k: 0 for k in KERNELS}
    results = {}
    for backend in (None, "sparse", "dense"):
        out = os.path.join(work_dir, "refine_" + str(backend))
        config = DEFAULT_CONFIG if backend is None else DEFAULT_CONFIG.replace(
            refine_iterations=5, refine_backend=backend)
        _lib.reset_launches()
        t0 = time.perf_counter()
        apps.run_vo_complete(data, out, config, device=device, verbose=False)
        sync(device)
        seconds = time.perf_counter() - t0
        ran = dict(_lib.launches)
        for k, v in ran.items():
            launches[k] += v
        res = apps.run_evaluation(data, out, verbose=False)
        results[backend] = res
        report["vo_complete_" + (backend or "unrefined")] = dict(
            check_accuracy(res, f"path F(1) {backend}"), seconds=seconds,
            segment_sum_launches=ran["segment_sum"], take_table_launches=ran["take_table"])
        if require_launches:
            used = ran["segment_sum"] > 0 and ran["take_table"] > 0
            require(used == (backend == "sparse"),
                    f"path F(1) {backend}: K9/K10 launches {ran}")
    # Bundle adjustment lowers the reprojection error. On this dataset the aligned
    # position and map errors then move by a few percent either way (the map 5%
    # down on one device and up on another): both must stay within 10%.
    base = results[None]
    for backend in ("sparse", "dense"):
        for metric in ("rmse_position", "rmse_map"):
            got, ref = getattr(results[backend], metric), getattr(base, metric)
            require(got <= ref * 1.1, f"path F(1) {backend}: refinement took {metric} from "
                                      f"{ref} to {got}, more than 10% up")
    gap = abs(results["sparse"].rmse_position - results["dense"].rmse_position)
    require(gap < 1e-3, f"path F(1): sparse and dense RMSE_position differ by {gap}")

    k, problem, n_live = ba_problem
    packed, degree = sparse_ba.pack_problem(problem)
    require(degree is not None, "path F(2): the corridor did not pack")
    for label, work, deg in (("packed", packed, degree), ("unpacked", problem, None)):
        frames = sparse_ba.plan_frames(work)          # K9's plan, once a run
        sparse_ba.sparse_ba_step(k, work, cg_iterations=2, cg_tolerance=0.0, lm_degree=deg,
                                 frames=frames)
        sync(device)                                                    # warm-up
        _lib.reset_launches()
        chis, residuals = [], []
        t0 = time.perf_counter()
        for _ in range(BA_STEPS):
            work, stats = sparse_ba.sparse_ba_step(k, work, cg_iterations=BA_CG, cg_tolerance=0.0,
                                                   lm_degree=deg, frames=frames)
            chis.append(stats.chi)
            residuals.append(stats.cg_residual)
        sync(device)
        seconds = time.perf_counter() - t0
        ran = dict(_lib.launches)
        for name, v in ran.items():
            launches[name] += v
        chis = [float(c) for c in chis]
        residuals = [float(r) for r in residuals]
        # A step with i CG iterations: K10 = pose rows + i matvecs + the
        # back-substitution, K9 = H_pp, b_p, the preconditioner's diagonal, the
        # reduced right-hand side + i matvecs (parallel/sparse_ba.sparse_ba_step).
        want = {"take_table": BA_STEPS * (2 + BA_CG), "segment_sum": BA_STEPS * (4 + BA_CG)}
        if require_launches:
            require(all(ran[name] == v for name, v in want.items()),
                    f"path F(2) {label}: K9/K10 launched {ran}, reckoned {want}")
        require(all(np.isfinite(chis)) and chis[-1] < chis[0],
                f"path F(2) {label}: chi did not fall: {chis}")
        require(all(np.isfinite(residuals)), f"path F(2) {label}: CG residual {residuals}")
        require(bool(torch.isfinite(work.poses).all() and torch.isfinite(work.landmarks).all()),
                f"path F(2) {label}: non-finite unknowns")
        report["sparse_ba_" + label] = {
            "poses": BA_POSES, "landmarks": BA_LANDMARKS, "observations": n_live,
            "observation_slots": int(work.uv.shape[0]), "lm_steps": BA_STEPS,
            "cg_iterations": BA_CG, "chi": chis, "cg_residual": residuals,
            "ms_per_lm_step": 1e3 * seconds / BA_STEPS,
            "segment_sum_launches": ran["segment_sum"], "take_table_launches": ran["take_table"]}
        print(f"path F(2) sparse BA {label}: {1e3 * seconds / BA_STEPS:.1f} ms an LM step "
              f"({BA_POSES} poses x {BA_LANDMARKS} landmarks, {n_live} observations, "
              f"{BA_CG} CG iterations)")
    report["launches"] = launches
    print(json.dumps({"path_f": report}))
    return launches


def run_path_g(device, n: int = 8192, require_launches: bool = True, reps: int = 10):
    """K11 through its public entry point on the workload of
    benchmarks/bench_picp.py, beside ``ops.picp.linearize`` (plain tensor
    operations on the card): other arithmetic for the same system, so H and b
    are held to 1e-4 of their largest entry and the inlier count exactly."""
    from visual_odometry_tpu_torch.ops import picp
    from visual_odometry_tpu_torch.ops.kernels import _lib, picp_kernel

    cam, pts = linearize_problem(n, device, seed=1)
    head = (cam.camera_matrix, cam.world_in_camera, cam.params())
    _lib.reset_launches()
    h, b, st = picp_kernel.linearize(*head, *pts, 1e4)
    sync(device)
    launches = {k: _lib.launches[k] for k in KERNELS}
    if require_launches:
        require(launches["picp_linearize"] == 1, f"path G: K11 did not launch once: {launches}")
    h2, b2, st2 = picp.linearize(cam, *pts, 1e4)
    err_h = float((h - h2).abs().max()) / float(h2.abs().max())
    err_b = float((b - b2).abs().max()) / float(b2.abs().max())
    require(err_h < 1e-4 and err_b < 1e-4, f"path G: H {err_h}, b {err_b} from picp.linearize")
    require(int(st.num_inliers) == int(st2.num_inliers), "path G: inlier counts differ")
    kernel_ms = time_ms(lambda: picp_kernel.linearize(*head, *pts, 1e4), device, reps)
    ops_ms = time_ms(lambda: picp.linearize(cam, *pts, 1e4), device, reps)
    print(json.dumps({"path_g": {"n": n, "h_rel_err": err_h, "b_rel_err": err_b,
                                 "inliers": int(st.num_inliers), "kernel_ms": kernel_ms,
                                 "picp_linearize_ops_ms": ops_ms, "launches": launches}}))
    print(f"path G linearization at N={n}: K11 {kernel_ms:.3f} ms, picp.linearize as tensor "
          f"operations {ops_ms:.3f} ms (median of {reps})")
    return launches


def stage_host_breakdown(prof, top: int = 8) -> dict:
    """Where the host time of each ``vo/<stage>`` range of a profiled call
    goes: the range's total (ms, summed over its calls), its ``top`` direct
    children by name (PyTorch operators, CUDA runtime calls), the CUDA
    runtime calls at any depth by name, and ``python_ms``, what no child
    covers."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.name.startswith("vo/"):
            continue
        row = out.setdefault(e.name[3:], {"ms": 0.0, "python_ms": 0.0, "children": {},
                                          "cuda_runtime": {}})
        total = e.time_range.elapsed_us() / 1e3
        row["ms"] += total
        row["python_ms"] += total - sum(c.time_range.elapsed_us() for c in e.cpu_children) / 1e3
        for c in e.cpu_children:
            kids = row["children"]
            kids[c.name] = kids.get(c.name, 0.0) + c.time_range.elapsed_us() / 1e3
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            stack.extend(c.cpu_children)
            if c.name.startswith("cuda"):
                rt = row["cuda_runtime"]
                rt[c.name] = rt.get(c.name, 0.0) + c.time_range.elapsed_us() / 1e3
    for row in out.values():
        row["children"] = dict(sorted(row["children"].items(), key=lambda kv: -kv[1])[:top])
    return out


def stage_report(device, frames: int = 512, slots: int = 1024, map_rows: int = 1 << 20,
                 reps: int = 5) -> dict:
    """Where the time of run_sequence on path B's and path D's inputs, and of
    relocalize_frame on path C's, goes: after ``reps`` warm-up calls, the host
    waits of one call by site (``profiling.host_waits``), then two more calls
    under torch.profiler, the first its warm-up step (without it the profiler
    saw no K7 launch in path C's call, which comes after a dozen profiled calls
    in one process): the time of each of the port's kernels, the device-busy
    share of the wall time, and where each ``vo/`` stage's host time goes."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.parallel import multiseq, posegraph, sparse_ba
    from visual_odometry_tpu_torch.utils import profiling, synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig
    from visual_odometry_tpu_torch.utils.roofline import device_events

    own = ("match_pairs", "join_candidates", "gather_rows", "track_frames", "picp_solve",
           "best_match_scan", "best_match_tc", "best_match_fold", "segment_sum", "take_table",
           "picp_linearize", "eight_point")   # csrc/*.cu name their kernels <this>_kernel

    def measured(fn):
        for _ in range(reps):
            fn()
        sync(device)
        profiling.reset_host_waits()
        fn()
        sync(device)
        out = {"host_waits": dict(profiling.host_waits)}
        # A warm-up step of the profiler first: the profiled call is the second.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            sync(device)
            prof.step()
            t0 = time.perf_counter()
            fn()
            sync(device)
            wall = time.perf_counter() - t0
            prof.step()
        on_card = device_events(prof)
        busy_us = sum(e.time_range.elapsed_us() for e in on_card)
        require(busy_us > 0, "stages: the profiler saw no device time")
        kernels = {}
        for e in on_card:
            for k in own:
                if k + "_kernel" in e.name:
                    row = kernels.setdefault(k, {"device_ms": 0.0, "launches": 0})
                    row["device_ms"] += e.time_range.elapsed_us() / 1e3
                    row["launches"] += 1
        out.update(kernels=kernels, device_busy_ms=busy_us / 1e3, wall_ms=1e3 * wall,
                   busy_share=busy_us / 1e6 / wall, host_breakdown=stage_host_breakdown(prof))
        require(out["host_breakdown"], "stages: the entry point ran no profiling.stage block")
        return out

    camera = synthetic.deep_camera(device=device)
    config = VOConfig(n_slots=slots, map_capacity=2 * slots)
    planar = config.with_planar_mount(mount_matrix("cpu").numpy())
    seq_b, seq_d = path_b_inputs(frames, slots, device), path_d_inputs(frames, slots, device)
    report = {"path_b": measured(lambda: pipeline.run_sequence(camera, config, *seq_b)),
              "path_d": measured(lambda: pipeline.run_sequence(camera, planar, *seq_d))}
    # The frame_step loop over the head of path B: one K6 launch a tracked frame.
    step = config.replace(scan_backend="step")
    head = tuple(x[:34] for x in seq_b)
    report["path_b_step_34_frames"] = measured(lambda: pipeline.run_sequence(camera, step, *head))
    # Path H: path B's sequence as 4 chunks, one K8 launch over them.
    report["path_h"] = measured(lambda: posegraph.run_sequence_chunked(
        camera, config, *seq_b, num_chunks=CHUNKS, overlap=CHUNK_OVERLAP))
    del seq_b, seq_d, head
    # Path E: the serving batch; path F(2): one sparse-BA step in each layout.
    seq_e = serving_inputs(SERVE_B, SERVE_FRAMES, SERVE_SLOTS, DEFAULT_CONFIG, device)
    report["path_e"] = measured(
        lambda: multiseq.run_sequences_batched(camera, DEFAULT_CONFIG, *seq_e))
    del seq_e
    k, problem, _ = corridor(device)
    packed, degree = sparse_ba.pack_problem(problem)
    for label, work, deg in (("packed", packed, degree), ("unpacked", problem, None)):
        report["path_f_sparse_step_" + label] = measured(lambda: sparse_ba.sparse_ba_step(
            k, work, cg_iterations=BA_CG, cg_tolerance=0.0, lm_degree=deg))
    del problem, packed
    camera, map_state, frame, x0, _ = path_c_inputs(device, map_rows, slots)
    for precision in ("highest", "fast"):
        cfg = VOConfig(n_slots=slots, map_capacity=map_rows, gn_iterations=30,
                       matcher_precision=precision)
        report["path_c_" + precision] = measured(
            lambda: pipeline.relocalize_frame(camera, cfg, map_state, frame, x0))
    return report


# --------------------------------------------------------------------------
# Path I: the multi-device forms (parallel/mesh) in two worlds on the card
# --------------------------------------------------------------------------


def path_i_match_cases(nq: int, nk: int):
    """{name: (queries, q_mask, db, db_mask)} as numpy: path C's kind of
    problem (match_problem) and tests/test_parallel_matcher.py's two
    cross-block cases (the winner in the last block, every block holding a
    decoy; a duplicate in blocks 0 and 2, the first winning) at 64 rows."""
    q, q_mask, db, db_mask = (x.numpy() for x in match_problem(nq, nk, "cpu")[0])
    last = np.full((64, 10), 5.0, np.float32)
    last[7::8] = 1.0
    last[-1] = 0.02
    tie = np.full((64, 10), 3.0, np.float32)
    tie[[5, 37]] = 0.0
    one = (np.zeros((1, 10), np.float32), np.ones(1, bool))
    return {"map": (q, q_mask, db, db_mask), "last_block": (*one, last, np.ones(64, bool)),
            "tie": (*one, tie, np.ones(64, bool))}


def digest(nest) -> str:
    """SHA-256 over the dtype, shape and bytes of every tensor of a nest of
    tensors (tuples and NamedTuples of them), in order."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            for y in x:
                walk(y)

    walk(nest)
    return h.hexdigest()


def path_i_rank(inputs: dict) -> dict:
    """One rank of a path I world: every check of ``inputs`` through the
    entry points, on ``inputs["device"]``, over an ``lm`` line and a (world,
    1) ``dp`` mesh spanning the whole world (and a (2, 2) mesh for dense BA).
    Returns each check's output (on the CPU; for a check held bit for bit,
    its digest), this rank's kernel launches in it and its wall seconds, the
    transport and the bytes the meshes staged through the host."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import bundle_adjustment, matcher, multiseq
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_tpu_torch.parallel import posegraph, sparse_ba
    from visual_odometry_tpu_torch.utils import synthetic

    n = torch.distributed.get_world_size()
    line = mesh_mod.single_axis_mesh(name="lm", device=inputs["device"])
    tall = mesh_mod.make_mesh(dp_size=n, device=inputs["device"])
    meshes = [line, tall]
    dev = line.device
    camera = synthetic.deep_camera(device=dev)
    report = {"backend": line.backend, "checks": {}}

    def card(x):
        return torch.from_numpy(x).to(dev)

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        items = [cpu(y) for y in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)

    def check(name, fn, whole: bool = False):
        """Run one check; keep its output's digest, or with ``whole`` the output."""
        sync(dev)
        _lib.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        report["checks"][name] = {"seconds": time.perf_counter() - t0,
                                  "output": cpu(out) if whole else digest(out),
                                  "launches": {k: v for k, v in _lib.launches.items() if v}}

    for name, (q, q_mask, db, db_mask) in inputs["match"].items():
        check("matcher_" + name, lambda: matcher.sharded_best_match(
            line, matcher.shard_rows(line, torch.from_numpy(db)),
            matcher.shard_rows(line, torch.from_numpy(db_mask)), card(q), card(q_mask)))
    check("dp", lambda: multiseq.run_sequences_batched(
        camera, inputs["serve_config"], *(card(x) for x in inputs["serving"]), mesh=tall))
    check("sp", lambda: posegraph.run_sequence_chunked(
        camera, inputs["config"], *(card(x) for x in inputs["path_b"]), num_chunks=CHUNKS,
        overlap=CHUNK_OVERLAP, mesh=tall))

    k, poses, landmarks, *obs = inputs["ba"]
    *shards, l_per, degree = sparse_ba.partition_observations_packed(n, len(landmarks), *obs)
    padded = np.zeros((n * l_per, 3), np.float32)
    padded[:len(landmarks)] = landmarks
    work = sparse_ba.SparseBAProblem(card(poses), *(
        matcher.shard_rows(line, torch.from_numpy(x)) for x in (padded, *shards)))
    step = sparse_ba.make_sharded_sparse_ba_step(line, cg_iterations=BA_CG, cg_tolerance=0.0,
                                                 lm_degree=degree)

    def sparse_steps():
        frames = sparse_ba.plan_frames(work)     # K9's plan of this rank's block, once a run
        w, chis, first = work, [], None
        for i in range(inputs["ba_steps"]):
            w, stats = step(card(k), w, frames)
            chis.append(stats.chi)
            if i == 0:
                first = (w.poses, mesh_mod.all_gather(line, w.landmarks, "lm")[:len(landmarks)],
                         stats.chi, stats.num_obs)
        return first, torch.stack(chis)

    check("sparse_ba", sparse_steps, whole=True)
    if "dense_ba" in inputs:
        square = mesh_mod.make_mesh(dp_size=2, device=inputs["device"])
        meshes.append(square)
        i, j = square.axis_index("dp"), square.axis_index("lm")
        k_d, batch = inputs["dense_ba"]
        rows = batch[1].shape[1] // square.shape["lm"]
        cols = slice(j * rows, (j + 1) * rows)
        block = bundle_adjustment.BAProblem(
            card(batch[0][i:i + 1]), card(batch[1][i:i + 1, cols]),
            card(np.ascontiguousarray(batch[2][i:i + 1, :, cols])),
            card(np.ascontiguousarray(batch[3][i:i + 1, :, cols])))
        check("dense_ba", lambda: bundle_adjustment.make_sharded_ba_step(square, damping=0.1)(
            card(k_d), block), whole=True)
        report["dense_ba_block"] = (i, j, rows)
    report["staged_bytes"] = sum(m.staged_bytes for m in meshes)
    return report


def path_i_dense_problem(work_dir: str, device):
    """Path A's dataset tracked on the card and turned into a dense BA
    problem as refine_trajectory builds it, landmarks padded to an even
    count, as a batch of 2 identical copies (tests/test_bundle_adjustment.py:
    99-105): (camera matrix, (poses, landmarks, observations, obs_mask))."""
    import torch

    from visual_odometry_tpu_torch.models import pipeline, refinement
    from visual_odometry_tpu_torch.models.landmark_map import compact
    from visual_odometry_tpu_torch.ops.camera import Camera
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_tpu_torch.utils import dataset_gen, io
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG

    data = os.path.join(work_dir, "data_i")
    dataset_gen.generate_dataset(data, num_frames=40, num_landmarks=400, seed=1)
    params = io.load_camera_params(os.path.join(data, "camera.dat"))
    camera = Camera.create(params.camera_matrix, rows=params.height, cols=params.width,
                           z_near=params.z_near, z_far=params.z_far, device=device)
    seq = io.load_sequence(data, DEFAULT_CONFIG.n_slots)
    traj, map_state, _ = pipeline.run_sequence(
        camera, DEFAULT_CONFIG, *(torch.from_numpy(x).to(device)
                                  for x in (seq.points, seq.appearances, seq.mask)))
    map_pts, map_apps = compact(map_state)
    obs, obs_mask = refinement.build_observations(seq.points, seq.appearances, seq.mask, map_apps)
    arrays = (refinement.absolute_from_relative(traj.cpu().numpy()),
              mesh_mod.pad_to_multiple(map_pts, 0, 2)[0], mesh_mod.pad_to_multiple(obs, 1, 2)[0],
              mesh_mod.pad_to_multiple(obs_mask, 1, 2)[0])
    return (np.asarray(params.camera_matrix, np.float32),
            tuple(np.repeat(x[None], 2, axis=0) for x in arrays))


def same_outputs(a, b) -> bool:
    """Whether two nests of tensors (tuples of tensors and NamedTuples) hold the same bits."""
    import torch

    if isinstance(a, torch.Tensor):
        b = b.cpu()
        return same_bits((a, b)) if a.is_floating_point() else torch.equal(a, b)
    return len(a) == len(b) and all(same_outputs(x, y) for x, y in zip(a, b))


def run_path_i(camera, config, serving, path_b, ba_problem, work_dir: str, device, smi: str):
    """The multi-device forms on the card in two worlds of ranks started by
    ``parallel.mesh.run_local``: one NCCL rank (every mesh 1 x 1), then
    4 ranks sharing the card over gloo (NCCL refuses two ranks a card), their
    collectives staged through the host. Each check runs an entry point over
    its mesh on every rank and is held to its unsharded call on this card:
    the sharded matcher (path C's 1,024 queries x 2^20 rows, and the
    cross-block cases of tests/test_parallel_matcher.py), dp serving (path
    E's batch; 8 of its sequences in the world of one), sp chunking (path H)
    and the world of one's sparse-BA step bit for bit; the 4 ranks' sparse BA
    (F(2), 3 LM steps x 64 CG, packed) at compare_wide_sparse_ba's
    tolerances, chi falling; dense BA over a (2, 2) mesh at
    tests/test_bundle_adjustment.py's. Every rank must launch each kernel of
    the work it owns: K7, K1-K3 and K8, K9 and K10."""
    import torch

    from visual_odometry_tpu_torch.ops import matching
    from visual_odometry_tpu_torch.ops.kernels import _lib
    from visual_odometry_tpu_torch.parallel import bundle_adjustment, multiseq, posegraph
    from visual_odometry_tpu_torch.parallel import mesh as mesh_mod
    from visual_odometry_tpu_torch.parallel import sparse_ba

    serve_config, seqs = serving
    match = path_i_match_cases(1024, 1 << 20)
    k, problem, n_live = ba_problem
    ba_arrays = tuple(x.cpu().numpy() for x in (k, problem.poses, problem.landmarks,
                                                problem.frame_idx, problem.lm_idx, problem.uv,
                                                problem.obs_mask))
    common = {"config": config, "serve_config": serve_config, "path_b": path_b,
              "ba": ba_arrays, "device": torch.device(device).type}
    inputs = {
        "one": {**common, "match": {"map": match["map"]},
                "serving": tuple(x[:PATH_I_ONE_SEQUENCES].cpu().numpy() for x in seqs),
                "ba_steps": 1},
        "shared": {**common, "match": match, "serving": tuple(x.cpu().numpy() for x in seqs),
                   "ba_steps": BA_STEPS, "dense_ba": path_i_dense_problem(work_dir, device)}}

    # The unsharded calls on this card.
    def card(x):
        return torch.from_numpy(x).to(device)

    ref = {}
    for name, (q, q_mask, db, db_mask) in match.items():
        dist, idx = matching.best_match(card(q), card(q_mask), card(db), card(db_mask))
        accept = card(q_mask) & (dist < torch.tensor(0.1, device=device) ** 2)
        ref["matcher_" + name] = (torch.where(accept, idx, -1), dist)
    ref["dp"] = multiseq.run_sequences_batched(camera, serve_config, *seqs)
    ref["dp_one"] = multiseq.run_sequences_batched(
        camera, serve_config, *(x[:PATH_I_ONE_SEQUENCES] for x in seqs))
    ref["sp"] = posegraph.run_sequence_chunked(camera, config, *(card(x) for x in path_b),
                                               num_chunks=CHUNKS, overlap=CHUNK_OVERLAP)
    packed, degree = sparse_ba.pack_problem(problem)
    kw = dict(cg_iterations=BA_CG, cg_tolerance=0.0, lm_degree=degree)
    ref_ba, ref_stats = sparse_ba.sparse_ba_step(k, packed, frames=sparse_ba.plan_frames(packed),
                                                 **kw)
    cpu64 = sparse_ba.SparseBAProblem(*(x.cpu() for x in packed))
    cpu64 = cpu64._replace(poses=cpu64.poses.double(), landmarks=cpu64.landmarks.double(),
                           uv=cpu64.uv.double())
    exact, _ = sparse_ba.sparse_ba_step(k.cpu().double(), cpu64, **kw)
    t_tol = max(1e-4, float((ref_ba.poses[:, :3, 3].cpu().double()
                             - exact.poses[:, :3, 3]).abs().max()))
    k_d, dense = inputs["shared"]["dense_ba"]
    ref_dense = bundle_adjustment.ba_step(card(k_d), bundle_adjustment.BAProblem(
        *(card(np.ascontiguousarray(x[0])) for x in dense)), damping=0.1)
    sync(device)
    torch.cuda.empty_cache()

    report, launches = {"card": smi}, {name: 0 for name in KERNELS}
    for world, ranks, backend in (("one", 1, "nccl"), ("shared", MESH_SHARDS, "gloo")):
        t0 = time.perf_counter()
        results = mesh_mod.run_local(path_i_rank, ranks, inputs[world], backend=backend,
                                     device=device, timeout=600.0)
        label = f"path I ({world})"
        summary = {"ranks": ranks, "world_seconds": time.perf_counter() - t0,
                   "transport": backend if backend == "nccl" else "gloo, host-staged",
                   "staged_bytes": [r["staged_bytes"] for r in results], "checks": {}}
        for name in results[0]["checks"]:
            per_rank = [r["checks"][name] for r in results]
            row = {"seconds": [c["seconds"] for c in per_rank],
                   "launches": [c["launches"] for c in per_rank]}
            for c in per_rank:
                for kernel, v in c["launches"].items():
                    launches[kernel] += v
            outs = [c["output"] for c in per_rank]
            if name.startswith("matcher") or name in ("dp", "sp"):
                want = digest(ref["dp_one" if name == "dp" and world == "one" else name])
                require(all(o == want for o in outs),
                        f"{label} {name}: differs from the unsharded call")
                row["bitwise"] = True
                need = ({"best_match": 1} if name.startswith("matcher") else
                        {"match_pairs": 2 if name == "dp" else 3, "join_candidates": 1,
                         "gather_rows": K3_PATH_LAUNCHES, "track_frames_batched": 1})
            elif name == "sparse_ba":
                steps = inputs[world]["ba_steps"]
                need = {"take_table": steps * (2 + BA_CG), "segment_sum": steps * (4 + BA_CG)}
                chis = [float(x) for x in outs[0][1]]
                require(all(np.isfinite(chis)) and (steps == 1 or chis[-1] < chis[0]),
                        f"{label} sparse BA: chi did not fall: {chis}")
                (poses, lms, chi, nobs), _ = outs[0]
                require(all(same_outputs(o[0], outs[0][0]) for o in outs),
                        f"{label} sparse BA: the ranks' replicated results differ")
                require(int(nobs) == int(ref_stats.num_obs), f"{label} sparse BA: num_obs")
                if world == "one":
                    require(same_outputs((poses, lms, chi), (ref_ba.poses, ref_ba.landmarks,
                                                             ref_stats.chi)),
                            f"{label} sparse BA: differs from the unsharded step")
                    row["bitwise"] = True
                else:
                    diff = (poses - ref_ba.poses.cpu()).abs()
                    rot, tr = float(diff[:, :3, :3].max()), float(diff[:, :3, 3].max())
                    lm_err = float((lms - ref_ba.landmarks.cpu()).abs().max())
                    chi_rel = abs(float(chi) - float(ref_stats.chi)) / float(ref_stats.chi)
                    require(rot <= 1e-4 and tr <= t_tol and lm_err <= 5e-4 and chi_rel <= 1e-4,
                            f"{label} sparse BA: the first step differs from the unsharded one "
                            f"(rotations {rot}, translations {tr} against {t_tol}, landmarks "
                            f"{lm_err}, chi {chi_rel} relative)")
                    row.update(rotation_max_abs_diff=rot, translation_max_abs_diff=tr,
                               translation_tolerance=t_tol, landmark_max_abs_diff=lm_err,
                               chi_rel_diff=chi_rel)
                row.update(chi=chis, observations=n_live)
            else:   # dense_ba
                need = {}
                ref_p, ref_s = ref_dense
                err = chi_rel = 0.0
                for r, (out, stats) in zip(results, outs):
                    _, j, rows = r["dense_ba_block"]
                    cols = slice(j * rows, (j + 1) * rows)
                    for got, want in ((out.poses[0], ref_p.poses.cpu()),
                                      (out.landmarks[0], ref_p.landmarks.cpu()[cols])):
                        require(bool(torch.isclose(got, want, rtol=2e-3, atol=2e-3).all()),
                                f"{label} dense BA: a block differs from ba_step beyond 2e-3")
                        err = max(err, float((got - want).abs().max()))
                    chi_rel = max(chi_rel, abs(float(stats.chi[0]) - float(ref_s.chi))
                                  / float(ref_s.chi))
                    require(int(stats.num_obs[0]) == int(ref_s.num_obs),
                            f"{label} dense BA: num_obs")
                require(chi_rel <= 1e-3, f"{label} dense BA: chi {chi_rel} relative from ba_step")
                row.update(max_abs_diff=err, chi_rel_diff=chi_rel)
            for r, c in enumerate(row["launches"]):
                require(all(c.get(kernel, 0) == v for kernel, v in need.items()),
                        f"{label} {name}: rank {r} launched {c}, reckoned {need}")
            summary["checks"][name] = row
        report[world] = summary
    report["launches"] = launches
    print(json.dumps({"path_i": report}))
    for world in ("one", "shared"):
        s = report[world]
        print(f"path I ({world}): {s['ranks']} rank(s) over {s['transport']} in "
              f"{s['world_seconds']:.1f} s, " + ", ".join(
                  f"{n} {max(c['seconds']):.3f} s" for n, c in s["checks"].items()))
    return launches


def path_j_workloads():
    """Path J's scaling workloads: dp at path E's shapes (64 x 128 frames x
    128 slots, landmark fields 100-163, the config's 100 GN rounds); sp at
    production length (F = 1,024, S = 128, overlap 10, 10 GN rounds, slack 0)
    and F = 2,048 at n = 1 and 4; lm at path F(2)'s shapes (512 poses x
    100,000 landmarks, generate_ba_corridor's seed 3 as the JAX measure's),
    one packed LM step of 64 CG iterations."""
    from visual_odometry_tpu_torch.parallel import scaling

    return [
        scaling.workload(scaling.DP, seqs_total=SERVE_B, frames=SERVE_FRAMES,
                         n_slots=SERVE_SLOTS, gn_iterations=100, reps=1, first_seed=100,
                         workload="path_e"),
        scaling.workload(scaling.SP, frames=1024, n_slots=128, overlap=CHUNK_OVERLAP,
                         gn_iterations=10, reps=1, workload="production_length"),
        scaling.workload(scaling.SP, frames=2048, n_slots=128, overlap=CHUNK_OVERLAP,
                         gn_iterations=10, reps=1, workload="long_sequence",
                         ns=(1, max(PATH_J_RANKS))),
        scaling.workload(scaling.LM, frames=BA_POSES, num_landmarks=BA_LANDMARKS,
                         cg_iterations=BA_CG, reps=1, packed=True, workload="sparse_ba"),
    ]


@contextlib.contextmanager
def recording_all(targets):
    """:func:`recording` of every (module, name) of ``targets`` at once; yields
    {name: its recorded calls}."""
    with contextlib.ExitStack() as stack:
        yield {name: stack.enter_context(recording(module, name)) for module, name in targets}


def frame_loop_targets():
    """The wrappers that launch K1-K4 and K8, for :func:`recording_all`."""
    from visual_odometry_tpu_torch.ops.kernels import frame_kernel, gather_kernel, matcher_kernel

    return ((matcher_kernel, "match_pairs_cuda"), (frame_kernel, "join_candidates_cuda"),
            (gather_kernel, "gather_rows_cuda"), (frame_kernel, "track_frames_cuda"),
            (frame_kernel, "track_frames_batched_cuda"))


def head_frames_batched(args, frames: int):
    """K8's arguments cut to the first ``frames`` tracked frames of every sequence."""
    from visual_odometry_tpu_torch.ops.kernels.frame_kernel import JoinCandidates

    params, pose0, tri, tri_ok, cand, prev_al, cur_al, valid = args[:8]
    cut = lambda x: x[:, :frames].contiguous()   # noqa: E731
    return ((params, pose0, tri, tri_ok, JoinCandidates(*map(cut, cand)), cut(prev_al),
             cut(cur_al), cut(valid)) + tuple(args[8:]))


def hold_calls_to_plain(calls: dict, label: str, head: int = PATH_J_HEAD) -> dict:
    """Each recorded launch (``recording_all``) run again through its kernel's
    plain version on the same card tensors: K1's indices equal and distances
    within K1_DIST_RTOL, K2, K3, K9 and K10 bit for bit, K4 and K8 over the
    first ``head`` frames of every sequence (the frame loop is causal) with
    poses within K4_POSE_TOL and the same triangulation validity. Returns
    {wrapper: {"calls", "shapes" (each once), "max_abs_err_vs_plain"}}."""
    import torch

    from visual_odometry_tpu_torch.ops.kernels import (
        frame_kernel, gather_kernel, matcher_kernel, segsum_kernel,
    )

    exact = {"join_candidates_cuda": frame_kernel.join_candidates_plain,
             "gather_rows_cuda": gather_kernel.gather_rows_plain,
             "segment_sum_small_cuda": segsum_kernel.segment_sum_small_plain,
             "take_table_cuda": gather_kernel.take_table_plain}
    report = {}
    for name, recorded in calls.items():
        err, shapes = 0.0, []
        for c, (args, kwargs, out) in enumerate(recorded):
            where = f"{label}: {name} call {c}"
            shape = list(args[4].idx.shape if name == "track_frames_batched_cuda"
                         else args[3].idx.shape if name == "track_frames_cuda"
                         else args[0].shape)
            if shape not in shapes:
                shapes.append(shape)
            if name == "match_pairs_cuda":
                ref = matcher_kernel.match_pairs_plain(*args, **kwargs)
                require(torch.equal(out[1], ref[1]) and torch.equal(out[3], ref[3]),
                        f"{where}: K1's indices differ from the plain version")
                for kd, pd in ((out[0], ref[0]), (out[2], ref[2])):
                    diff = (kd - pd).abs()
                    require(bool((diff <= K1_DIST_RTOL * pd.abs().clamp_min(1.0)).all()),
                            f"{where}: K1's distances differ beyond {K1_DIST_RTOL} relative")
                    live = pd < 1e38
                    if bool(live.any()):
                        err = max(err, float(diff[live].max()))
            elif name in exact:
                ref = exact[name](*args, **kwargs)
                pairs = zip(out, ref) if isinstance(out, tuple) else ((out, ref),)
                require(all(torch.equal(a, b) for a, b in pairs),
                        f"{where}: differs from the plain version")
            else:
                batched = name == "track_frames_batched_cuda"
                plain = (frame_kernel.track_frames_batched_plain if batched
                         else frame_kernel.track_frames_plain)
                short = (head_frames_batched if batched else head_frames)(args, head)
                ref = plain(*short)
                got = [x[:, :head] if batched else x[:head] for x in out]
                e = float((got[0] - ref[0]).abs().max())
                require(e <= K4_POSE_TOL,
                        f"{where}: poses {e} from the plain version's (> {K4_POSE_TOL})")
                require(torch.equal(got[2], ref[2]),
                        f"{where}: triangulation validity differs from the plain version")
                err = max(err, e)
        report[name] = {"calls": len(recorded), "shapes": shapes, "max_abs_err_vs_plain": err}
    return report


def run_path_j(device, smi: str):
    """parallel/scaling and the graft entry on the card.
    ``graft_entry.dryrun_multichip(4)`` with path J's workloads: one world of
    gloo ranks sharing the card per n in PATH_J_RANKS, each running dp, sp
    and lm (path_j_workloads), the world of 4 the dry run's five sharded
    checks first; the rows held to the dry run's thresholds at n = 4. dp's
    trajectories at n > 1 equal n = 1's bit for bit and sp's equal the
    unsharded chunked call of the same plan on this card (as path I holds
    them); every rank returns the same result. The kernels the ranks ran, at
    their shapes, against their plain versions: sp's unsharded calls (K1-K3,
    K4 at n = 1, K8 over the chunks at n > 1), a dp rank's block at n = 4
    (K1-K3, K8 over 16 sequences) and an lm rank's shard at n = 2 and 4
    (every K9 and K10 call of one step on it), each replayed here with its
    launches recorded (hold_calls_to_plain). The work tally of small calls
    on the card equals the CPU's. ``graft_entry.entry()``'s step on the card
    against the plain versions' on the same state moved to the CPU (pose
    within GN_POSE_TOL, triangulations within ENTRY_TRI_TOL, the same inlier
    count), and the same step on ``graft_entry.tracking_state``, which tracks
    every slot (the entry's own state tracks none), each with its K1 and K6
    launches held to their plain versions; then ``graft_entry.selfcheck()``.
    Launches: the ranks' (dry run and scaling worlds) and the entry step's;
    the replays and comparisons count none."""
    import torch

    from visual_odometry_tpu_torch import graft_entry
    from visual_odometry_tpu_torch.ops.kernels import (
        _lib, gather_kernel, matcher_kernel, picp_kernel, segsum_kernel,
    )
    from visual_odometry_tpu_torch.parallel import multiseq, posegraph, scaling, sparse_ba
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig
    from visual_odometry_tpu_torch.utils.convert import to_device

    torch.cuda.empty_cache()
    workloads = path_j_workloads()
    t0 = time.perf_counter()
    checks, rows = graft_entry.dryrun_multichip(max(PATH_J_RANKS), device, workloads=workloads)
    dryrun_s = time.perf_counter() - t0
    launches = {name: 0 for name in KERNELS}
    for rank in checks:
        require(rank["launches"].get("best_match", 0) > 0,
                f"path J: a dry-run rank launched no K7: {rank['launches']}")
        for name, v in rank["launches"].items():
            launches[name] += v
    for row in rows:
        for per_rank in row["launches_by_rank"]:
            for name, v in per_rank.items():
                launches[name] += v

    # The graft entry's step on the card against the plain versions on the CPU.
    _lib.reset_launches()
    fn, (state, frame) = graft_entry.entry()
    with recording_all(((matcher_kernel, "match_pairs_cuda"),
                        (picp_kernel, "solve_fused"))) as entry_calls:
        pose, tri, inl = fn(state, frame)
        sync(device)
    entry_launches = {k: v for k, v in _lib.launches.items() if v}
    for name, v in entry_launches.items():
        launches[name] += v
    t1 = time.perf_counter()
    held_s = {}
    fn_cpu, _ = graft_entry.entry(device="cpu")
    pose_c, tri_c, inl_c = fn_cpu(to_device(state, "cpu"), to_device(frame, "cpu"))
    pose_err = float((pose.cpu() - pose_c).abs().max())
    tri_err = float((tri.cpu() - tri_c).abs().max())
    require(pose_err <= GN_POSE_TOL and tri_err <= ENTRY_TRI_TOL and int(inl) == int(inl_c),
            f"path J entry: pose {pose_err}, triangulations {tri_err} from the CPU's, inliers "
            f"{int(inl)} vs {int(inl_c)}")
    entry_k6 = hold_solves_to_plain(entry_calls.pop("solve_fused"), "path J entry")
    entry_k1 = hold_calls_to_plain(entry_calls, "path J entry")
    # The same step on a state that tracks: the pose is K6's work, not its start.
    camera, cfg, t_state, t_frame = graft_entry.tracking_state(device=device)
    cam_c, cfg_c, _, _ = graft_entry.tracking_state(device="cpu")
    with recording_all(((matcher_kernel, "match_pairs_cuda"),
                        (picp_kernel, "solve_fused"))) as track_calls:
        t_pose, _, t_inl = graft_entry.step_fn(camera, cfg)(t_state, t_frame)
        sync(device)
    t_pose_c, _, t_inl_c = graft_entry.step_fn(cam_c, cfg_c)(to_device(t_state, "cpu"),
                                                             to_device(t_frame, "cpu"))
    t_pose_err = float((t_pose.cpu() - t_pose_c).abs().max())
    require(t_pose_err <= GN_POSE_TOL and int(t_inl) == int(t_inl_c) == cfg.n_slots,
            f"path J tracking step: pose {t_pose_err} from the CPU's, inliers {int(t_inl)} vs "
            f"{int(t_inl_c)} of {cfg.n_slots}")
    track_k6 = hold_solves_to_plain(track_calls.pop("solve_fused"), "path J tracking step")
    track_k1 = hold_calls_to_plain(track_calls, "path J tracking step")

    # Bit for bit: every rank alike; dp against n = 1, sp against the
    # unsharded chunked call of the same plan on this card, whose launches
    # are held to the plain versions.
    require(all(r["ranks_agree"] for r in rows if "ranks_agree" in r),
            "path J: the ranks of a world returned different results")
    dp = {r["n_devices"]: r for r in rows if r["metric"] == scaling.DP}
    require(sorted(dp) == list(PATH_J_RANKS), f"path J: dp rows at n = {sorted(dp)}")
    require(all(r["output_sha256"] == dp[1]["output_sha256"] for r in dp.values()),
            "path J dp: a sharded run's trajectories differ from n = 1's")
    held_s["entry"] = time.perf_counter() - t1
    deep = synthetic.deep_camera(device=device)
    sp_bits, held = {}, {}
    for w in workloads:
        if w["metric"] != scaling.SP:
            continue
        config = VOConfig(n_slots=w["n_slots"], map_capacity=2 * w["n_slots"],
                          gn_iterations=w["gn_iterations"])
        seq = [torch.from_numpy(x).to(device) for x in synthetic.generate_tracking_sequence(
            np.random.default_rng(7), w["frames"], w["n_slots"])]
        got = [r for r in rows if r["metric"] == scaling.SP and r["workload"] == w["workload"]]
        require(len(got) == len(w.get("ns") or PATH_J_RANKS),
                f"path J {w['workload']}: rows at n = {[r['n_devices'] for r in got]}")
        for r in got:
            with recording_all(frame_loop_targets()) as calls:
                ref = posegraph.run_sequence_chunked(deep, config, *seq,
                                                     num_chunks=r["n_devices"],
                                                     overlap=w["overlap"], slack=0)[0]
            require(scaling._digest(ref) == r["output_sha256"],
                    f"path J {w['workload']} n = {r['n_devices']}: differs from the unsharded call")
            key = f"sp_{w['workload']}_{r['n_devices']}"
            sp_bits[key] = True
            held[key] = hold_calls_to_plain(calls, f"path J {key}")
    t2 = time.perf_counter()
    held_s["sp"] = t2 - t1 - held_s["entry"]
    # A dp rank's block at n = 4: the first 16 sequences, as rank 0 runs them
    # (the plain frame loop over every sequence's head: ~38 GN rounds a frame).
    w, n = workloads[0], max(PATH_J_RANKS)
    config = VOConfig(n_slots=w["n_slots"], map_capacity=2 * w["n_slots"],
                      gn_iterations=w["gn_iterations"])
    batch = scaling._dp_batch(w["seqs_total"] // n, w["frames"], w["n_slots"], w["first_seed"])
    with recording_all(frame_loop_targets()) as calls:
        multiseq.run_sequences_batched(deep, config, *(torch.from_numpy(x).to(device)
                                                       for x in batch))
        sync(device)
    held[f"dp_rank_block_{n}"] = hold_calls_to_plain(calls, f"path J dp rank block n = {n}",
                                                     PATH_J_DP_HEAD)
    held_s["dp"] = time.perf_counter() - t2
    # An lm rank's shard: one step on rank 0's block, every K9 and K10 call.
    w = workloads[-1]
    for n in PATH_J_RANKS[1:]:
        kj, block, degree = scaling.lm_block(n, 0, w["frames"], w["num_landmarks"],
                                             w["obs_per_lm"], w["packed"], device)
        with recording_all(((segsum_kernel, "segment_sum_small_cuda"),
                            (gather_kernel, "take_table_cuda"))) as calls:
            sparse_ba.sparse_ba_step(kj, block, damping=0.1, cg_iterations=w["cg_iterations"],
                                     cg_tolerance=0.0, lm_degree=degree,
                                     frames=sparse_ba.plan_frames(block))
            sync(device)
        require(all(calls.values()), f"path J lm shard n = {n}: {list(map(len, calls.values()))}")
        held[f"lm_rank_shard_{n}"] = hold_calls_to_plain(calls, f"path J lm shard n = {n}")
        del calls
    held_s["lm"] = time.perf_counter() - t2 - held_s["dp"]
    for key, report in held.items():
        for name in (("track_frames_cuda",) if key.endswith("_1")
                     else ("track_frames_batched_cuda",) if key.startswith(("sp", "dp")) else ()):
            require(report[name]["calls"] > 0, f"path J {key}: no {name} launch was held")

    # The tally depends on shapes alone: the card's equals the CPU's.
    card_tally = scaling.small_call_tally(device)
    cpu_tally = scaling.small_call_tally("cpu")
    require(card_tally == cpu_tally, f"path J: the card's tally {card_tally} differs from the "
                                     f"CPU's {cpu_tally}")
    diffs = graft_entry.selfcheck()

    missing = [k for k in PATH_J if launches[k] == 0]
    require(not missing, f"path J: kernels that never launched: {missing}")
    report = {
        "card": smi, "note": "n ranks sharing one card: not a scaling figure",
        "dryrun_seconds": dryrun_s, "held_to_plain_seconds": held_s,
        "rows": [{k: v for k, v in r.items() if k != "tally_by_rank"} for r in rows],
        "dryrun_checks": [{k: v for k, v in c.items() if k in ("mesh", "matcher_idx",
                                                                "dense_ba_num_obs",
                                                                "sparse_ba_num_obs", "launches")}
                          for c in checks],
        "sp_bitwise": sp_bits, "dp_bitwise": True, "held_to_plain": held,
        "tally_equal": True, "tally": card_tally,
        "entry": {"pose_max_abs_err_vs_cpu": pose_err, "num_inliers": int(inl),
                  "tri_max_abs_err_vs_cpu": tri_err, "launches": entry_launches,
                  "k6_max_abs_err_vs_plain": entry_k6, "k1_vs_plain": entry_k1},
        "tracking_step": {"pose_max_abs_err_vs_cpu": t_pose_err, "num_inliers": int(t_inl),
                          "k6_max_abs_err_vs_plain": track_k6, "k1_vs_plain": track_k1},
        "selfcheck": diffs, "launches": launches}
    print(json.dumps({"path_j": report}))
    for r in rows:
        print(f"path J {r['metric']} {r.get('workload')} n={r['n_devices']}: partition "
              f"{r['partition_efficiency']:.4f}, wall {r['wall_ms']:.1f} ms, world "
              f"{r['world_seconds']:.1f} s")
    return launches


def demangled(text: str) -> str:
    """``text`` with its C++ symbols demangled by c++filt, where there is one."""
    tool = shutil.which("c++filt")
    if tool is None:
        return text
    return subprocess.run([tool], input=text, stdout=subprocess.PIPE, text=True).stdout


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    require(res.returncode == 0, "nvidia-smi failed: " + res.stdout)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from visual_odometry_tpu_torch.ops.kernels import (
        _lib, frame_kernel, gather_kernel, matcher_kernel,
    )
    from visual_odometry_tpu_torch.utils import synthetic
    from visual_odometry_tpu_torch.utils.config import DEFAULT_CONFIG, VOConfig

    device = torch.device("cuda")
    if sys.argv[1:] == ["--stages"]:
        print(nvidia_smi_line())
        print(json.dumps({"stages": stage_report(device)}))
        return 0
    t_start = time.perf_counter()

    def phase(label: str, t0: float) -> None:
        print(f"[{label}: {time.perf_counter() - t0:.1f} s]")

    # ---- 1. environment ----
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_lib._nvcc(), "--version"], stdout=subprocess.PIPE, text=True)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(nvcc.stdout.strip().splitlines()[-1])
    print(smi)

    # ---- 2. build ----
    path, seconds, log = _lib.build()
    _lib.library()
    print(f"build: {os.path.relpath(path, ROOT)} in {seconds:.1f} s")
    for line in demangled(log).splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")) or line.startswith("=="):
            print("  " + line.strip())

    # ---- 3. kernels vs plain versions at the main path's shapes ----
    frames, slots = 512, 1024
    config = VOConfig(n_slots=slots, map_capacity=2 * slots)
    camera = synthetic.deep_camera(device=device)
    pts, apps, masks = path_b_inputs(frames, slots, device)
    t0 = time.perf_counter()
    inputs = kernel_inputs(camera, config, pts, apps, masks)
    kernel_fns = {
        "match_pairs": matcher_kernel.match_pairs_cuda,
        "join_candidates": frame_kernel.join_candidates_cuda,
        "gather_rows": gather_kernel.gather_rows_cuda,
        "track_frames": frame_kernel.track_frames_cuda,
    }
    table = compare_kernels(inputs, device, kernel_fns)
    planar_config = config.with_planar_mount(mount_matrix("cpu").numpy())
    planar_seq = path_d_inputs(frames, slots, device)
    inputs = kernel_inputs(camera, planar_config, *planar_seq)
    compare_frame_kernel("track_frames_planar", inputs["track_frames"], K5_PLAIN_FRAMES, device,
                         table, kernel_fns["track_frames"])
    del inputs
    compare_solves(device, table)
    compare_matchers(device, table)
    torch.cuda.empty_cache()
    serving = {}
    for cfg in (DEFAULT_CONFIG, DEFAULT_CONFIG.with_planar_mount(mount_matrix("cpu").numpy())):
        seqs = serving_inputs(SERVE_B, SERVE_FRAMES, SERVE_SLOTS, cfg, device)
        compare_serving(camera, cfg, seqs, device, table)
        serving[cfg.planar] = (cfg, seqs)
    plan = chunk_plan(camera, config, pts, apps, masks)
    compare_chunked_k8(camera, config, (pts, apps, masks), plan, device, table)
    compare_eight_point(camera, config, serving[False][1], serving[False][0], (pts, apps, masks),
                        plan, device, table)
    compare_map_fold(device, table)
    ba_problem = corridor(device)
    compare_sparse_ba_kernels(ba_problem[1], device, table)
    compare_wide_sparse_ba(device, table)
    compare_linearize(device, table)
    torch.cuda.empty_cache()
    print("kernels vs plain versions: all agree")
    phase("kernel phase", t0)

    # ---- 3b. utils/selfcheck and utils/roofline ----
    t0 = time.perf_counter()
    run_utils_phase(device)
    phase("selfcheck and roofline", t0)

    # ---- 4-12. the paths ----
    work = os.path.join(ROOT, "build", "chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        launches["A"] = run_path_a(work, device)
        phase("path A", t0)
        t0 = time.perf_counter()
        launches["B"], path_b_traj, path_b_fps = run_path_b(camera, config, pts, apps, masks,
                                                            device)
        phase("path B", t0)
        t0 = time.perf_counter()
        launches["C"] = run_path_c(device)
        phase("path C", t0)
        t0 = time.perf_counter()
        launches["D"] = run_path_d(camera, planar_config, *planar_seq, device)
        phase("path D", t0)
        t0 = time.perf_counter()
        launches["resume"] = run_resume(camera, config, pts, apps, masks, device, work)
        phase("resume", t0)
        t0 = time.perf_counter()
        launches["step"] = run_step_form(camera, config, pts, apps, masks, device)
        phase("step form", t0)
        t0 = time.perf_counter()
        launches["H"] = run_path_h(camera, config, pts, apps, masks, device, path_b_traj,
                                   path_b_fps)
        phase("path H", t0)
        path_b = tuple(x.cpu().numpy() for x in (pts, apps, masks))
        del pts, apps, masks, planar_seq
        t0 = time.perf_counter()
        launches["E"] = run_path_e(camera, serving, device)
        phase("path E", t0)
        t0 = time.perf_counter()
        launches["F"] = run_path_f(work, device, ba_problem)
        phase("path F", t0)
        t0 = time.perf_counter()
        launches["G"] = run_path_g(device)
        phase("path G", t0)
        t0 = time.perf_counter()
        launches["I"] = run_path_i(camera, config, serving[False], path_b, ba_problem, work,
                                   device, smi)
        phase("path I", t0)
        del serving, ba_problem
        t0 = time.perf_counter()
        launches["J"] = run_path_j(device, smi)
        phase("path J", t0)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = []
    for name, (source, replaces, home) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[home][name], "launches_path": home,
               "launches_by_path": {p: launches[p][name] for p in launches}}
        row.update(table[name])
        require(row["launches"] > 0, f"{name} never launched on path {home}")
        rows.append(row)
    print(f"[total: {time.perf_counter() - t_start:.1f} s]")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
