"""CPU tests of the output check: the reference agrees with the program's
CPU path (its plain versions) on tiny sequences, and a run whose timed path
is broken underneath, or the control (the reference in bfloat16) in the
program's place, comes out not correct. Each cell runs at its own limits
(``limits/<workload>.json``) on a few short sequences; the card's run of
the same checks is ``vobench/calibrate.py``."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from visual_odometry_tpu_torch.models import landmark_map, pipeline
from visual_odometry_tpu_torch.ops.kernels import frame_kernel
from visual_odometry_tpu_torch.parallel import multiseq

from vobench import harness

# The tracking cells: those whose configuration tracks the default generator's
# sequences (a configuration with a generator of its own has its own tests).
CELLS = tuple(w["name"] for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())
              ["workloads"] if "generator" not in harness.cell(w["name"]).config)


def tiny(name: str, root=harness.REPO) -> harness.Cell:
    c = harness.cell(name, root)
    c.config = copy.deepcopy(c.config)
    if c.traffic["entry"] == "relocalize_frame":
        # A map of 2^14 rows holding 80% of 16,000 landmarks on two crossing
        # 52 m streets (the configuration's density); 8 query frames of 128 slots.
        c.config["scene"].update(landmarks=16000, mapped=12800, map_rows=1 << 14,
                                 extent=52.0, streets_per_axis=1, features_per_frame=120)
        c.config["slots"] = 128
        c.config["vo_config"].update(n_slots=128, map_capacity=1 << 14)
        c.traffic = dict(c.traffic, pool_calls=8, trace_calls=2)
        return c
    # A third of the path's period: long enough for the speed to change; a
    # chunked configuration's 24 frames a chunk, so that its chunks plan.
    chunks = int(c.config["vo_config"]["num_chunks"])
    c.config["frames"] = (max(10, int(c.config["scene"]["period"]) // 3) if chunks == 1
                          else 24 * chunks)
    if c.config["slots"] > 256:   # the plain frame loop on 1,024 lanes is slow on a CPU
        c.config["slots"] = 256
        c.config["vo_config"].update(n_slots=256, map_capacity=512)
    c.traffic = dict(c.traffic, pool_calls=2, trace_calls=2,
                     sequences_per_call=min(2, c.traffic["sequences_per_call"]))
    return c


def run(c: harness.Cell, seed: int = 4_000_000_007, control=None) -> dict:
    result, code = harness.run(c, seed, 0.1, False, "cpu", time.perf_counter(), control)
    assert code == 0
    return result


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_program(name):
    c = tiny(name)
    result = run(c)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert set(result["metrics"]) == {m["name"] for m, _ in c.end_to_end}
    assert 0.0 < result["occupancy"]["map_fill_mean"] <= 1.0


def _unchanged_state(orig):
    def track(camera_matrix, cam_params, x_init, *args, **kw):
        poses, tri, ok, stats = orig(camera_matrix, cam_params, x_init, *args, **kw)
        return x_init.expand_as(poses).clone(), tri, ok, stats
    return track


def _altered_answer(orig):
    def track(*args, **kw):
        poses, tri, ok, stats = orig(*args, **kw)
        poses = poses.clone()
        f = poses.shape[0] // 2
        poses[f, :3, 3] *= 2.0   # one frame's translation doubled
        return poses, tri, ok, stats
    return track


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_answer"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_frame_loop_is_not_correct(name, fault, monkeypatch):
    orig = frame_kernel.track_frames
    broken = {"unchanged_state": _unchanged_state, "altered_answer": _altered_answer}[fault]
    monkeypatch.setattr(frame_kernel, "track_frames", broken(orig))
    result = run(tiny(name))
    assert not result["correct"], result["checks"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    orig = multiseq.run_sequences_batched

    def half(camera, config, points, appearances, masks, **kw):
        b, h = points.shape[0], points.shape[0] // 2
        traj, maps, outs = orig(camera, config, points[:h], appearances[:h], masks[:h], **kw)

        def fill(x):
            return torch.cat([x, x[:b - h]])
        return fill(traj), landmark_map.LandmarkMap(*map(fill, maps)), \
            pipeline.FrameOutput(*map(fill, outs))

    monkeypatch.setattr(multiseq, "run_sequences_batched", half)
    result = run(tiny("ref128.fleet64"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    result = run(tiny(name), 4_000_000_009, control=torch.bfloat16)
    assert result["control"] == "bfloat16"
    assert result["correct"] is False, result["checks"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    c = tiny("ref128.single")
    result, code = harness.run(c, 4_000_000_011, 0.1, False, "cpu", time.perf_counter())
    assert result is None and code == 4
