"""The port's ``parallel/scaling`` on the CPU, one world of gloo ranks per n
in (1, 2, 4) (port of tests/test_scaling.py), and the per-rank work tally it
reads (``ops/kernels/_lib.counting_work``).

The JAX tests hold XLA's compiled per-device FLOP count; the port holds the
kernel work every dispatcher tallies from its ``utils/roofline`` model, a
count that depends on shapes alone: dp partitions exactly, sp re-tracks its
overlaps (bounded redundancy, the plan equal to the JAX package's), lm
partitions to within its per-rank (F, R) sums. JAX's
``test_dp_outputs_stay_sharded`` has no counterpart: the port's entry points
return whole tensors on every rank (``parallel/mesh.py``, point 4). In its
place each rank's tally must hold only its block's frame-loop work, and the
gathered trajectories must equal the unsharded run's bit for bit.

Shapes are JAX's test shapes cut to the CPU's (dp 8 sequences of 10 frames x
32 slots, sp 24 frames x 32 slots in chunks of overlap 4, 5 GN rounds; lm 16
poses x 2,048 landmarks, 4 CG iterations).
"""

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.ops import picp
from visual_odometry_tpu_torch.ops.camera import project_points
from visual_odometry_tpu_torch.ops.kernels import (
    _lib, frame_kernel, gather_kernel, matcher_kernel, picp_kernel, segsum_kernel,
)
from visual_odometry_tpu_torch.parallel import multiseq, scaling
from visual_odometry_tpu_torch.utils import roofline, synthetic
from visual_odometry_tpu_torch.utils.config import VOConfig

NS = (1, 2, 4)
DP = dict(seqs_total=8, frames=10, n_slots=32, gn_iterations=5, reps=1)
SP = dict(frames=24, n_slots=32, overlap=4, gn_iterations=5, reps=1)
LM = dict(frames=16, num_landmarks=2048, obs_per_lm=6, cg_iterations=4, reps=1)


@pytest.fixture(scope="module")
def rows():
    return scaling.measure_workloads(NS, [scaling.workload(scaling.DP, **DP),
                                          scaling.workload(scaling.SP, **SP),
                                          scaling.workload(scaling.LM, **LM)], device="cpu")


def _by_n(rows, metric):
    return {r["n_devices"]: r for r in rows if r["metric"] == metric}


def test_dp_sharding_partitions_work_exactly(rows):
    """dp tracker: per-rank kernel work at n ranks == total / n."""
    dp = _by_n(rows, scaling.DP)
    assert sorted(dp) == list(NS)
    for n in NS[1:]:
        assert dp[n]["partition_efficiency"] >= 0.95, dp[n]
    np.testing.assert_allclose(dp[4]["work_per_device"], dp[1]["work_per_device"] / 4, rtol=0.05)
    for row in dp.values():
        assert row["transport"] == "gloo" and row["device"] == "cpu"
        assert row["work_per_device"] == max(row["work_by_rank"]) > 0.0


def test_sp_chunking_bounded_redundancy(rows):
    """Chunked tracker: per-rank work is the chunk's share plus the overlap
    redundancy and the plan every rank repeats: at 4 chunks under half the
    serial work, at every n within the chunk_len / frames bound, and the plan
    is the JAX package's."""
    from visual_odometry_tpu.parallel import posegraph as jpg

    sp = _by_n(rows, scaling.SP)
    f1 = sp[1]["work_per_device"]
    assert sp[1]["replicated_work"] == 0.0
    for n in NS[1:]:
        fn = sp[n]["work_per_device"]
        starts, chunk_len = jpg.plan_chunks(SP["frames"], n, SP["overlap"], None, 0)
        assert (tuple(sp[n]["starts"]), sp[n]["chunk_len"]) == (tuple(starts), chunk_len)
        if n == 4:   # JAX's test point: well under half the serial work
            assert fn < 0.5 * f1, (n, fn, f1)
        assert fn <= 1.4 * f1 * chunk_len / SP["frames"], (n, fn, f1, chunk_len)
        # chunk 0's bootstrap check, one K1 pair, on every rank
        check = roofline.match_pairs_model(1, SP["n_slots"], 10).speed_of_light_s(roofline.H100)
        np.testing.assert_allclose(sp[n]["replicated_work"], check, rtol=1e-12)


def test_lm_sharding_partitions_work(rows):
    lm = _by_n(rows, scaling.LM)
    assert sorted(lm) == list(NS)
    for n in NS[1:]:
        assert lm[n]["partition_efficiency"] >= 0.9, lm[n]


def test_dp_ranks_hold_only_their_block(rows):
    """Each rank's tally holds the frame loops of its B / n sequences and no
    more (the CPU's loop form: one K4 a sequence), and every rank returns the
    whole batch's trajectories, equal bit for bit to the unsharded run."""
    dp = _by_n(rows, scaling.DP)
    batch = [torch.from_numpy(x) for x in scaling._dp_batch(DP["seqs_total"], DP["frames"],
                                                            DP["n_slots"])]
    config = VOConfig(n_slots=DP["n_slots"], map_capacity=2 * DP["n_slots"],
                      gn_iterations=DP["gn_iterations"])
    whole = multiseq.run_sequences_batched(synthetic.deep_camera(), config, *batch)[0]
    loop = roofline.frame_model(DP["frames"] - 2, DP["n_slots"], 2, DP["gn_iterations"])
    for n, row in dp.items():
        assert row["ranks_agree"], n
        assert row["output_sha256"] == scaling._digest(whole), n
        for tally in row["tally_by_rank"]:
            calls, _, ops, moved, least = tally["track_frames"]
            assert calls == DP["seqs_total"] // n
            assert (ops, moved) == (calls * loop.fp32_ops, calls * loop.hbm_bytes)
            np.testing.assert_allclose(least, calls * loop.speed_of_light_s(roofline.H100),
                                       rtol=1e-12)


def test_rows_carry_the_jax_keys(rows):
    for row in rows:
        assert {"metric", "n_devices", "wall_ms", "fps", "speedup", "efficiency", "host_cores",
                "partition_efficiency", "work_per_device", "tc_flops_per_device",
                "fp32_ops_per_device", "hbm_bytes_per_device", "staged_bytes"} <= set(row)
        assert row["wall_ms"] > 0 and np.isfinite(row["fps"])


# --- the tally of each dispatcher ----------------------------------------------


def _tracking_inputs(frames: int, slots: int, batch=None):
    """roofline.measure's fixed-budget K4 inputs, every lane joining its own
    carried point; with ``batch``, that many copies on a leading axis (K8)."""
    rng = np.random.default_rng(0)
    field = torch.from_numpy(np.stack([
        rng.uniform(-2.5, 2.5, slots), rng.uniform(-2.0, 2.0, slots),
        rng.uniform(2.0, 6.0, slots)], axis=1).astype(np.float32))
    cam = synthetic.default_camera()
    uv, ok = project_points(cam, field)
    lanes = torch.arange(slots, dtype=torch.int32)
    cand = frame_kernel.JoinCandidates(idx=lanes.expand(frames, 2, slots),
                                       ok=ok.expand(frames, 2, slots),
                                       overflow=torch.zeros((frames, slots), dtype=torch.bool))
    per_seq = [torch.eye(4), field, ok, cand, uv.expand(frames, slots, 2),
               uv.expand(frames, slots, 2), ok.expand(frames, slots)]

    def lead(x):
        if isinstance(x, tuple):
            return type(x)(*(lead(y) for y in x))
        return (x if batch is None else x.expand(batch, *x.shape)).contiguous()

    return (cam.camera_matrix, cam.params(), *(lead(x) for x in per_seq), 3, 1e4, 1.0, -1.0)


def _solve_inputs(n: int):
    rng = np.random.default_rng(1)
    world = synthetic.generate_points3d(rng, n)
    cam = synthetic.default_camera()
    meas, valid = project_points(synthetic.default_camera(synthetic.generate_pose(rng)),
                                 torch.from_numpy(world))
    return cam, torch.from_numpy(world), meas, valid.float()


def _case(name):
    """(call, tally name, roofline model) of one dispatcher at small CPU shapes."""
    rng = np.random.default_rng(2)
    if name == "match_pairs":
        app = torch.from_numpy(rng.uniform(-1, 1, (3, 16, 10)).astype(np.float32))
        mask = torch.ones(3, 16, dtype=torch.bool)
        return (lambda: matcher_kernel.match_pairs(app, mask, app, mask), name,
                roofline.match_pairs_model(3, 16, 10))
    if name == "join_candidates":
        idx = torch.from_numpy(rng.integers(0, 16, (5, 16)).astype(np.int32))
        ok = torch.ones(5, 16, dtype=torch.bool)
        return (lambda: frame_kernel.join_candidates(idx, ok, idx, ok, 2), name,
                roofline.join_model(5, 16, 2))
    if name in ("gather_rows", "gather_rows_batched"):
        shape = (5, 16) if name == "gather_rows" else (2, 5, 16)
        d = 2 if name == "gather_rows" else 10
        src = torch.from_numpy(rng.uniform(size=shape + (d,)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, 16, shape).astype(np.int32))
        return (lambda: gather_kernel.gather_rows(src, idx), "gather_rows",
                roofline.gather_model(int(np.prod(shape[:-1])), 16, d))
    if name in ("track_frames", "track_frames_planar"):
        planar = name.endswith("planar")
        args = _tracking_inputs(3, 16)
        return (lambda: frame_kernel.track_frames(*args, planar=planar), name,
                roofline.frame_model(3, 16, 2, 3, planar))
    if name == "track_frames_batched":
        args = _tracking_inputs(3, 16, batch=2)
        return (lambda: frame_kernel.track_frames_batched(*args), name,
                roofline.serving_model(2, 3, 16, 2, 3))
    if name in ("best_match", "best_match_fast"):
        q = torch.from_numpy(rng.uniform(-1, 1, (4, 10)).astype(np.float32))
        db = torch.from_numpy(rng.uniform(-1, 1, (64, 10)).astype(np.float32))
        fast = name.endswith("fast")
        return (lambda: matcher_kernel.best_match(q, torch.ones(4, dtype=torch.bool), db,
                                                  torch.ones(64, dtype=torch.bool), fast=fast),
                name, roofline.matcher_model(4, 64, 10, "fast" if fast else "highest"))
    if name == "segment_sum":
        vals = torch.from_numpy(rng.uniform(size=(20, 3)).astype(np.float32))
        seg = torch.from_numpy(rng.integers(0, 6, 20).astype(np.int32))
        return (lambda: segsum_kernel.segment_sum_small(vals, seg, 5), name,
                roofline.segment_sum_model(20, 5, 3))
    if name == "take_table":
        table = torch.from_numpy(rng.uniform(size=(6, 5)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, 5, 20).astype(np.int32))
        return (lambda: gather_kernel.take_table(table, idx), name,
                roofline.take_table_model(20, 5, 6))
    cam, world, meas, w = _solve_inputs(32)
    if name in ("picp_solve", "picp_solve_se2"):
        planar = name.endswith("se2")
        fn = picp_kernel.solve_se2_fused if planar else picp_kernel.solve_fused
        mount = (None,) if planar else ()
        return (lambda: fn(cam.camera_matrix, cam.world_in_camera, cam.params(), *mount, world,
                           meas, w, 4, 1e4, 1.0, -1.0), name, roofline.picp_model(32, 4, planar))
    if name == "picp_solve_plain_loop":
        return (lambda: picp.solve(cam, world, meas, w, 4), "picp_solve",
                roofline.picp_model(32, 4))
    assert name == "picp_linearize"
    return (lambda: picp_kernel.linearize(cam.camera_matrix, cam.world_in_camera, cam.params(),
                                          world, meas, w, 1e4), name, roofline.linearize_model(32))


@pytest.mark.parametrize("name", [
    "match_pairs", "join_candidates", "gather_rows", "gather_rows_batched", "track_frames",
    "track_frames_planar", "track_frames_batched", "best_match", "best_match_fast",
    "segment_sum", "take_table", "picp_solve", "picp_solve_se2", "picp_solve_plain_loop",
    "picp_linearize"])
def test_dispatcher_tallies_its_roofline_model(name):
    """One call of each kernel-function dispatcher on the CPU (its plain
    version) adds exactly its ``utils/roofline`` model at the call's shapes,
    GN rounds at the budget, to the tally under its launch counter's name."""
    call, key, model = _case(name)
    with _lib.counting_work() as work:
        call()
    assert work == {key: [1, model.tc_flops, model.fp32_ops, model.hbm_bytes,
                          model.speed_of_light_s(roofline.H100)]}
    assert key in _lib.launches


def test_nothing_is_tallied_outside_a_count():
    """A dispatch outside ``counting_work`` counts nothing; blocks nest, the
    inner one counting into its own dict and the outer one going on after it."""
    call, key, _ = _case("match_pairs")
    assert _lib.work is None
    call()
    assert _lib.work is None
    with _lib.counting_work() as outer:
        call()
        with _lib.counting_work() as inner:
            call()
        call()
    assert _lib.work is None
    assert inner[key][0] == 1 and outer[key][0] == 2


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the calls would run there")


@pytest.mark.parametrize("measure", ["dp", "sp", "lm", "scaling", "workloads"])
def test_measurements_need_a_card_unless_asked_for_the_cpu(measure):
    _no_card()
    call = {"dp": lambda: scaling.measure_dp_scaling([1]),
            "sp": lambda: scaling.measure_sp_scaling([1]),
            "lm": lambda: scaling.measure_lm_scaling([1]),
            "scaling": lambda: scaling.measure_scaling([1]),
            "workloads": lambda: scaling.measure_workloads([1], [scaling.workload(scaling.DP)])}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[measure]()


def test_workload_fills_the_defaults_and_refuses_unknown_arguments():
    w = scaling.workload(scaling.SP, frames=48, workload="toy", ns=(1, 4))
    assert w == dict(metric=scaling.SP, frames=48, n_slots=64, overlap=6, gn_iterations=50,
                     reps=3, workload="toy", ns=(1, 4))
    with pytest.raises(TypeError, match="cg_iterations"):
        scaling.workload(scaling.DP, cg_iterations=4)
