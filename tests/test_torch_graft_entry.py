"""The port's graft entry (``visual_odometry_tpu_torch/graft_entry``) against
the JAX repository's root ``__graft_entry__``, and ``utils/config.ACCURATE_CONFIG``.

``entry``'s step runs on JAX's own bootstrapped state, carried across through
``utils/convert``, so the float64 bootstrap departure does not enter; the
bounds are the parity contract's (pose 1e-4, triangulations 5e-4, equal
inlier counts). On the entry's synthetic scene the step tracks no inlier in
either package (the default camera's z_far = 5 lies short of the monocular
scale), so the pose is the solver's identity start and the triangulations
carry that comparison; ``tracking_state``'s step tracks every slot, and holds
the solve. The dry run runs in worlds of 1 and 2 gloo CPU ranks, its five
sharded checks in the world of 2, with its scaling workloads cut to the
CPU's: at the JAX dry run's shapes they need K8 at F = 2,048 and run on the
card (chip_smoke.py, path J).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from visual_odometry_tpu_torch import graft_entry
from visual_odometry_tpu_torch.parallel import scaling
from visual_odometry_tpu_torch.utils import convert
from visual_odometry_tpu_torch.utils.config import ACCURATE_CONFIG, VOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_entry():
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    return __graft_entry__


def test_synthetic_state_draws_equal_jax(jax_entry):
    """The same numpy draws: appearances and ids bit for bit, frame 2's
    projections within float32 rounding of the same world, the same masks."""
    _, jcfg, _, jframe = jax_entry._synthetic_state()
    camera, cfg, state, frame = graft_entry._synthetic_state(device="cpu")
    assert (cfg.n_slots, cfg.map_capacity) == (jcfg.n_slots, jcfg.map_capacity) == (128, 256)
    np.testing.assert_array_equal(frame.appearances.numpy(), np.asarray(jframe.appearances))
    np.testing.assert_array_equal(frame.ids.numpy(), np.asarray(jframe.ids))
    np.testing.assert_array_equal(frame.mask.numpy(), np.asarray(jframe.mask))
    np.testing.assert_allclose(frame.points.numpy(), np.asarray(jframe.points), atol=1e-3)
    assert int(state.tri_valid.sum()) > 100


def test_entry_step_matches_jax(jax_entry):
    jfn, (jstate, jframe) = jax_entry.entry()
    jpose, jtri, jinl = (np.asarray(x) for x in jfn(jstate, jframe))
    fn, _ = graft_entry.entry(device="cpu")
    state = convert.vo_state_from_arrays(
        ref={k: np.asarray(v) for k, v in jstate.ref._asdict().items()},
        point_lookup=np.asarray(jstate.point_lookup), tri_points=np.asarray(jstate.tri_points),
        tri_valid=np.asarray(jstate.tri_valid), x_curr=np.asarray(jstate.x_curr),
        history=np.asarray(jstate.history),
        map_arrays={k: np.asarray(v) for k, v in jstate.map._asdict().items()})
    frame = convert.frame_data_from_arrays(**{k: np.asarray(v)
                                              for k, v in jframe._asdict().items()})
    pose, tri, inl = fn(state, frame)
    np.testing.assert_allclose(pose.numpy(), jpose, atol=1e-4)
    np.testing.assert_allclose(tri.numpy(), jtri, atol=5e-4)
    assert int(inl) == int(jinl)


def test_tracking_step_matches_jax():
    """The entry's step on ``tracking_state``, whose next frame tracks every
    slot as an inlier: the same frames through the JAX package's
    ``initialize`` with its deep camera, the JAX state carried across, the
    step against JAX's ``frame_step``: pose at the parity contract's 1e-4, the
    same inliers and triangulation validity. The triangulated values are not
    compared: the camera moves partly along its axis, and the points near the
    focus of expansion put 2e-6 of pose difference at 0.9% of depth (measured
    on this state); the entry's own step carries that comparison."""
    import jax.numpy as jnp

    from visual_odometry_tpu.models import pipeline as jpipeline
    from visual_odometry_tpu.utils import synthetic as jsynthetic
    from visual_odometry_tpu.utils.config import VOConfig as JConfig
    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.utils import synthetic

    camera, cfg, _, frame = graft_entry.tracking_state(device="cpu")
    pts, apps, masks = synthetic.generate_tracking_sequence(np.random.default_rng(5), 3,
                                                            cfg.n_slots)
    jframes = [jpipeline.FrameData(points=jnp.asarray(pts[i]), appearances=jnp.asarray(apps[i]),
                                   mask=jnp.asarray(masks[i]),
                                   ids=jnp.arange(cfg.n_slots, dtype=jnp.int32))
               for i in range(3)]
    jcamera = jsynthetic.deep_camera()
    jcfg = JConfig(n_slots=cfg.n_slots, map_capacity=cfg.map_capacity)
    jstate, _ = jpipeline.initialize(jcamera, jcfg, jframes[0], jframes[1])
    jnext, jout = jpipeline.frame_step(jcamera, jcfg, jstate, jframes[2])
    state = convert.vo_state_from_arrays(
        ref={k: np.asarray(v) for k, v in jstate.ref._asdict().items()},
        point_lookup=np.asarray(jstate.point_lookup), tri_points=np.asarray(jstate.tri_points),
        tri_valid=np.asarray(jstate.tri_valid), x_curr=np.asarray(jstate.x_curr),
        history=np.asarray(jstate.history),
        map_arrays={k: np.asarray(v) for k, v in jstate.map._asdict().items()})
    new_state, out = pipeline.frame_step(camera, cfg, state, frame)
    assert int(out.num_inliers) == int(jout.num_inliers) == cfg.n_slots
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(jout.pose), atol=1e-4)
    np.testing.assert_array_equal(new_state.tri_valid.numpy(), np.asarray(jnext.tri_valid))
    assert bool(torch.isfinite(new_state.tri_points).all())


# The dry run with its workloads cut to the CPU's (the JAX dry run's at F =
# 1,024 and 2,048 run on the card, chip_smoke.py's path J).
TINY = [scaling.workload(scaling.DP, seqs_total=4, frames=8, n_slots=32, gn_iterations=5,
                         reps=1, workload="toy"),
        scaling.workload(scaling.SP, frames=48, n_slots=32, overlap=4, gn_iterations=5, reps=1,
                         workload="production_length"),
        scaling.workload(scaling.SP, frames=96, n_slots=32, overlap=4, gn_iterations=5, reps=1,
                         workload="long_sequence", ns=(1, 2)),
        scaling.workload(scaling.LM, frames=16, num_landmarks=2048, cg_iterations=4, reps=1,
                         workload="sparse_ba")]


@pytest.fixture(scope="module")
def dryrun():
    return graft_entry.dryrun_multichip(2, device="cpu", workloads=TINY)


def test_dryrun_sharded_checks_in_two_ranks(dryrun):
    """The five sharded checks pass in the world of 2 gloo CPU ranks (a (2, 1)
    mesh), and every rank returns the same whole results."""
    ranks, _ = dryrun
    assert len(ranks) == 2
    for r in ranks:
        assert r["mesh"] == (2, 1)
        assert r["matcher_idx"] == list(range(8))
        assert r["dense_ba_num_obs"] > 0 and r["sparse_ba_num_obs"] > 0
        assert tuple(r["sp_trajectory"].shape) == (14, 4, 4)
        assert tuple(r["dp_trajectories"].shape) == (4, 14, 4, 4)
    for key in ("sp_trajectory", "dp_trajectories"):
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    # each dp rank's block is one whole copy of the sequence: all four alike
    dp = ranks[0]["dp_trajectories"]
    assert all(torch.equal(dp[0], dp[i]) for i in range(1, 4))


def test_dryrun_rows_pass_its_thresholds(dryrun):
    """Every workload has a row at n = 1 and 2, and they pass the dry run's
    thresholds (which dryrun_multichip has already held them to)."""
    _, rows = dryrun
    assert [(r["workload"], r["n_devices"]) for r in rows] == [
        (w["workload"], n) for w in TINY for n in (1, 2)]
    graft_entry.check_scaling_rows(rows, 2)


def _rows(dp=0.95, prod=0.9, long=0.92, lm=0.95):
    rows = [{"metric": scaling.DP, "n_devices": 4, "partition_efficiency": dp},
            {"metric": scaling.SP, "workload": "production_length", "n_devices": 4,
             "partition_efficiency": prod},
            {"metric": scaling.SP, "workload": "long_sequence", "n_devices": 4,
             "partition_efficiency": long},
            {"metric": scaling.LM, "n_devices": 4, "partition_efficiency": lm}]
    return rows


@pytest.mark.parametrize("kw", [{}, {"dp": 0.89}, {"prod": 0.84}, {"long": 0.89}, {"lm": 0.89}])
def test_check_scaling_rows_holds_the_jax_thresholds(kw):
    if not kw:
        graft_entry.check_scaling_rows(_rows(), 4)
        return
    with pytest.raises(AssertionError):
        graft_entry.check_scaling_rows(_rows(**kw), 4)


def test_scaling_workloads_are_the_jax_dry_runs():
    ws = graft_entry.scaling_workloads(8)
    assert [(w["metric"], w["workload"]) for w in ws] == [
        (scaling.DP, "toy"), (scaling.SP, "toy"), (scaling.SP, "production_length"),
        (scaling.SP, "long_sequence"), (scaling.LM, "sparse_ba")]
    assert (ws[2]["frames"], ws[2]["n_slots"], ws[2]["overlap"], ws[2]["gn_iterations"]) == (
        1024, 128, 10, 10)
    assert ws[3]["frames"] == 2048 and ws[3]["ns"] == (1, 8)
    assert (ws[4]["frames"], ws[4]["num_landmarks"], ws[4]["cg_iterations"]) == (48, 4096, 16)


def test_accurate_config_equals_jax():
    from visual_odometry_tpu.utils import config as jconfig

    assert convert.config_from_dict(dataclasses.asdict(jconfig.ACCURATE_CONFIG)) == ACCURATE_CONFIG
    assert ACCURATE_CONFIG == VOConfig(refine_iterations=15)


@pytest.mark.parametrize("call", ["entry", "selfcheck", "dryrun"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(call):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the calls would run there")
    fn = {"entry": graft_entry.entry, "selfcheck": graft_entry.selfcheck,
          "dryrun": lambda: graft_entry.dryrun_multichip(2)}[call]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
