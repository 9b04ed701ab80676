"""The port's utils/roofline on the CPU: the card's peaks from its name and SM
count, one work count a kernel function, and the measurement paths at tiny
shapes (plain versions, no fraction: the CPU is no card)."""

import inspect
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch.utils import roofline

SXM = SimpleNamespace(name="NVIDIA H100 80GB HBM3", multi_processor_count=132)
PCIE = SimpleNamespace(name="NVIDIA H100 PCIe", multi_processor_count=114)
NVL = SimpleNamespace(name="NVIDIA H100 NVL", multi_processor_count=132)


def test_spec_for_reads_name_and_sms():
    sxm = roofline.spec_for(SXM)
    assert sxm.sms == 132 and sxm.hbm_bw == 3.35e12 and sxm.tc_bf16_flops == 989e12
    assert abs(sxm.fp32_ops - 33.5e12) < 0.1e12          # 132 x 128 x 1.98 GHz, FMA = 1
    pcie = roofline.spec_for(PCIE)
    assert pcie.sms == 114 and pcie.hbm_bw == 2.0e12
    assert pcie.fp32_ops == 114 * 128 * 1.755e9
    # Each data-sheet FP32 rate (67 / 51 / 60 TFLOP/s) is 2 x SMs x 128 x the clock.
    for props, tflops in ((SXM, 67), (PCIE, 51), (NVL, 60)):
        assert abs(2 * roofline.spec_for(props).fp32_ops / 1e12 - tflops) < 0.5
    with pytest.raises(ValueError, match="data-sheet"):
        roofline.spec_for(SimpleNamespace(name="NVIDIA A100-SXM4-80GB", multi_processor_count=108))


# Each model with its work axis: (model, keyword arguments, the axis).
MODELS = [
    (roofline.match_pairs_model, dict(b=510, n=1024, d=10), "b"),
    (roofline.join_model, dict(f=510, s=1024, depth=2), "f"),
    (roofline.gather_model, dict(f=510, s=1024, d=10), "f"),
    (roofline.frame_model, dict(frames=510, s=1024, depth=2, rounds=8, planar=False), "frames"),
    (roofline.frame_model, dict(frames=510, s=1024, depth=2, rounds=3, planar=True), "frames"),
    (roofline.serving_model, dict(sequences=64, frames=126, s=128, depth=2, rounds=38),
     "sequences"),
    (roofline.picp_model, dict(n=1024, rounds=4, planar=False), "n"),
    (roofline.picp_model, dict(n=8192, rounds=3, planar=True), "rounds"),
    (roofline.linearize_model, dict(n=8192), "n"),
    (roofline.matcher_model, dict(q=1024, k=1 << 20, d=10), "k"),
    (roofline.segment_sum_model, dict(n=600_000, t=512, r=36), "n"),
    (roofline.take_table_model, dict(n=600_000, t=512, r=12), "n"),
    (roofline.sparse_ba_model, dict(n=592_677, f=512, l=100_000, cg_iters=64), "cg_iters"),
    (roofline.eight_point_model, dict(b=64, s=128, n=128), "b"),
    (roofline.map_fold_model, dict(b=64, t=15_360, d=10, capacity=1024), "t"),
]


@pytest.mark.parametrize("model,kw,axis", MODELS)
def test_models_scale_linearly(model, kw, axis):
    """Along its work axis every count is affine (each step adds the same
    work) and the count that binds grows."""
    at = [model(**dict(kw, **{axis: kw[axis] * m})) for m in (1, 2, 3)]
    for field in ("tc_flops", "fp32_ops", "hbm_bytes"):
        v = [getattr(x, field) for x in at]
        assert v[2] - v[1] == pytest.approx(v[1] - v[0], rel=1e-12, abs=1e-6), field
    chip = roofline.spec_for(SXM)
    t = [x.speed_of_light_s(chip) for x in at]
    assert t[0] < t[1] < t[2]


def test_fp64_rate_and_the_eight_point_model():
    """The FP64 CUDA-core rate is SMs x 64 x the clock (34 TFLOP/s on the
    SXM5, a multiply-add two); P1's work is all float64, its live count the
    data's, and an FP64-only model binds by operations once bytes are few."""
    sxm = roofline.spec_for(SXM)
    assert sxm.fp64_ops == 132 * 64 * 1.98e9
    assert abs(2 * sxm.fp64_ops / 1e12 - 34) < 0.6   # 33.45, the data sheet rounds to 34
    full, half = roofline.eight_point_model(1, 1024, 1024), roofline.eight_point_model(
        1, 1024, 1024, live=512)
    assert full.fp32_ops == 0.0 and full.tc_flops == 0.0
    assert full.fp64_ops - half.fp64_ops == (45 + roofline.EIGHT_POINT_ROW_OPS) * 512
    t, by = roofline.KernelModel("x", 0.0, 0.0, 0.0, fp64_ops=1e9).bound(sxm)
    assert by == "operations" and t == pytest.approx(1e9 / sxm.fp64_ops)


def test_op_counts_grow_with_gn_rounds():
    a = roofline.frame_model(128, 1024, 2, 10)
    b = roofline.frame_model(128, 1024, 2, 20)
    assert b.fp32_ops - a.fp32_ops == 10 * 128 * 1024 * roofline.GN_OPS_PER_POINT_ROUND[False]
    assert a.hbm_bytes == b.hbm_bytes
    assert roofline.GN_OPS_PER_POINT_ROUND == {False: 177, True: 135}


def _plain_lane_ops(planar: bool, n: int = 1000) -> int:
    """Arithmetic ops a lane of one GN round's plain version issues: every op
    with an output of N values under a dispatch counter, data movement left
    out, plus the round's lane sums (30 or 12 adds a lane)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from visual_odometry_tpu_torch.ops.kernels import frame_kernel
    from visual_odometry_tpu_torch.utils import synthetic

    moves = {"stack", "cat", "view", "expand", "clone", "copy_", "_to_copy", "select", "slice",
             "unbind", "lift_fresh", "detach", "alias", "_unsafe_view"}

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (isinstance(out, torch.Tensor) and out.numel() == n
                    and func.overloadpacket.__name__ not in moves):
                Count.ops += 1
            return out

    cam = synthetic.default_camera()
    par = frame_kernel.pack_params(cam.camera_matrix, cam.params(), torch.eye(4), 1e4, 1.0, 1e-12,
                                   False, False, 0.0, planar, None).unbind(0)
    gen = torch.Generator().manual_seed(0)
    w = torch.rand((n, 3), generator=gen) + torch.tensor([0.0, 0.0, 2.0])
    m = torch.rand((n, 2), generator=gen) * 100
    with Count():
        frame_kernel._gn_lane_rows(par, tuple(par[28:40]), w[:, 0], w[:, 1], w[:, 2], m[:, 0],
                                   m[:, 1], torch.ones(n), planar)
    return Count.ops + (12 if planar else 30)


@pytest.mark.parametrize("planar", [False, True])
def test_gn_count_is_no_more_than_the_plain_round_issues(planar):
    """The model's count (a multiply-add once, the cheapest grouping) lies
    below the plain version's separately issued ops and above what fusing
    every multiply of it into an add could save (about a third)."""
    plain = _plain_lane_ops(planar)
    model = roofline.GN_OPS_PER_POINT_ROUND[planar]
    assert 0.6 * plain < model < plain, (model, plain)


def test_report_and_speed_of_light():
    chip = roofline.spec_for(SXM)
    m = roofline.matcher_model(1024, 131072, 10)
    light = m.speed_of_light_s(chip)
    assert m.bound(chip) == (light, "operations")
    rep = m.report(2 * light, chip)
    assert rep["matcher_roofline_fraction"] == pytest.approx(0.5)
    assert 0 < rep["matcher_mfu"] <= 1.0
    for key in ("matcher_time_us", "matcher_gbps", "matcher_tc_gflops", "matcher_fp32_gops"):
        assert np.isfinite(rep[key])
    with pytest.raises(ValueError, match="least time"):
        m.report(0.9 * light, chip)
    # No tensor-core work: no mfu to report.
    assert "picp_mfu" not in roofline.picp_model(1024, 100).report(1.0, chip)


def test_matcher_precisions_share_one_floor():
    exact = roofline.matcher_model(1024, 1 << 20, 10)
    fast = roofline.matcher_model(1024, 1 << 20, 10, precision="fast")
    assert (exact.tc_flops, exact.fp32_ops, exact.hbm_bytes) == (
        fast.tc_flops, fast.fp32_ops, fast.hbm_bytes)
    assert (exact.name, fast.name) == ("matcher", "matcher_fast")


def test_no_model_takes_a_geometry_tile_padding_or_route():
    models = [roofline.match_pairs_model, roofline.join_model, roofline.gather_model,
              roofline.frame_model, roofline.serving_model, roofline.picp_model,
              roofline.linearize_model, roofline.matcher_model, roofline.segment_sum_model,
              roofline.take_table_model, roofline.sparse_ba_model, roofline.pipeline_floor_s]
    forbidden = ("tile", "pad", "geometry", "cta", "thread", "block", "warp", "cluster",
                 "lane", "route", "backend", "split", "grid")
    for model in models:
        for name in inspect.signature(model).parameters:
            assert not any(w in name.lower() for w in forbidden), (model.__name__, name)


# Bounds at the paths' shapes on an H100 SXM, ms, as PERF.md section 6 lists
# them (at the GN rounds a frame of its chip run).
PATH_BOUNDS = [
    (roofline.match_pairs_model(510, 1024, 10), 0.03228, "operations"),
    (roofline.match_pairs_model(1, 1024, 10), 0.0000633, "operations"),
    (roofline.join_model(510, 1024, 2), 0.003274, "bytes"),
    (roofline.gather_model(510, 1024, 10), 0.01310, "bytes"),
    (roofline.gather_model(510, 1024, 2), 0.003118, "bytes"),
    (roofline.frame_model(510, 1024, 2, 7.871), 0.02317, "operations"),
    (roofline.frame_model(510, 1024, 2, 3.008, planar=True), 0.007760, "operations"),
    (roofline.picp_model(1024, 4), 0.00002167, "operations"),
    (roofline.picp_model(8192, 3, planar=True), 0.00009917, "operations"),
    (roofline.matcher_model(1024, 1 << 20, 10), 0.03241, "operations"),
    (roofline.serving_model(64, 126, 128, 2, 37.79), 0.2092, "operations"),
    (roofline.serving_model(64, 126, 128, 2, 3.429, planar=True), 0.01709, "operations"),
    (roofline.serving_model(4, 142, 1024, 2, 22.52), 0.07088, "operations"),
    (roofline.segment_sum_model(600_000, 512, 36), 0.02653, "bytes"),
    (roofline.segment_sum_model(600_000, 512, 6), 0.005019, "bytes"),
    (roofline.take_table_model(600_000, 512, 12), 0.009321, "bytes"),
    (roofline.take_table_model(600_000, 512, 6), 0.005019, "bytes"),
    (roofline.linearize_model(8192), 0.00005878, "bytes"),
    (roofline.sparse_ba_model(592_677, 512, 100_000, 64), 1.654, "bytes"),
]


@pytest.mark.parametrize("model,ms,by", PATH_BOUNDS)
def test_bounds_at_the_paths_shapes(model, ms, by):
    t, got_by = model.bound(roofline.spec_for(SXM))
    assert got_by == by
    assert t * 1e3 == pytest.approx(ms, rel=5e-4)


def test_pipeline_floor_is_the_sum_of_its_stages():
    """Path B's floor: K1 over 511 pairs, K2, three K3 gathers and K4 over 510
    frames at 3 rounds, and the map fold's two sorts of 512 x 1024 rows of 15
    floats (a read and a write each)."""
    chip = roofline.spec_for(SXM)
    stages = (roofline.match_pairs_model(511, 1024, 10), roofline.join_model(510, 1024, 2),
              roofline.gather_model(510, 1024, 2), roofline.gather_model(510, 1024, 2),
              roofline.gather_model(510, 1024, 10), roofline.frame_model(510, 1024, 2, 3))
    fold = 2 * 2 * 512 * 1024 * 15 * 4 / chip.hbm_bw
    want = sum(m.speed_of_light_s(chip) for m in stages) + fold
    assert roofline.pipeline_floor_s(512, 1024, chip) == pytest.approx(want, rel=1e-12)
    assert roofline.pipeline_floor_s(1024, 1024, chip) > want


def test_measure_on_the_cpu_at_tiny_shapes():
    out = roofline.measure(device="cpu", queries=16, rows=256, points=64, gn_rounds=3,
                           frames=3, slots=64, frame_rounds=2, reps=2, rounds=1)
    assert out["device"] == "cpu" and "spec" not in out
    assert not any(k.endswith(("_roofline_fraction", "_mfu")) for k in out)
    for name in ("matcher", "picp", "frame"):
        for field in ("time_us", "call_us", "gbps", "fp32_gops"):
            assert math.isfinite(out[f"{name}_{field}"]) and out[f"{name}_{field}"] > 0
    assert out["frame_us_per_frame"] == pytest.approx(out["frame_time_us"] / 3)


def test_measure_sparse_ba_on_the_cpu_at_tiny_shapes():
    out = roofline.measure_sparse_ba(device="cpu", f=8, l=200, cg_iterations=3, reps=2, rounds=1)
    assert out["sparse_ba_observations"] > 0
    for field in ("sparse_ba_time_us", "sparse_ba_gbps", "sparse_ba_ms_per_iter"):
        assert math.isfinite(out[field]) and out[field] > 0


def test_measure_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline.measure()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        roofline.measure_sparse_ba()
