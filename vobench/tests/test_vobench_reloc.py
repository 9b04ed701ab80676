"""CPU tests of what a configuration brings beside its reference: its own
generator (``generator`` key), and the numbers its reference's ``gaps``
computes, each judged against the cell's limits file; and of the
relocalization cell built on them.

* The four tracking cells read through the harness what their generator,
  reference and comparison give called directly: the same pools and the same
  six numbers, bit for bit.
* A number the reference computes that has no limit fails the run, and so
  does a number the limits file holds that the reference does not compute.
* The relocalization cell ``reloc1650k.single`` runs here from a copy of
  ``BENCHMARK.json`` that holds ``RELOC_ENTRIES`` where the file does not.
  Its reference (``reference/vo_reloc.py``) agrees with
  ``pipeline.relocalize_frame``'s plain CPU path on a map of 2^14 rows and 8
  query frames of 128 slots, and judges not correct at
  ``limits/reloc1650k.single.json`` the bfloat16 control and runs broken
  underneath: the solve returning the prior unchanged, a doubled translation,
  half the queries' matches dropped, two calls' query frames swapped (each
  solved from the other's prior), and the
  matcher's bfloat16 filter taken as its answer without the exact
  re-selection.

Run from the repository root: ``python -m pytest vobench/tests -q``."""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import types

import pytest
import torch

from visual_odometry_tpu_torch.ops import matching, picp

from vobench import compare, harness, peaks, tracing, workmodels
from vobench.reference import vo_reloc
from test_vobench_check import CELLS, run, tiny

RELOC = "reloc1650k.single"
SEED = 4_000_000_201
# What BENCHMARK.json gains with the cell.
RELOC_ENTRIES = {
    "configs": [{
        "name": "vo_reloc1650k",
        "source": "Sattler et al., CVPR 2018, Benchmarking 6DOF Outdoor Visual Localization in "
                  "Changing Conditions: Aachen Day-Night, 4,328 images, 1.65 M 3-D points; "
                  "queries at ORB_SLAM2 Monocular/EuRoC.yaml",
        "file": "vobench/configs/vo_reloc1650k.json", "reduced": [],
        "why": "a robot on vo_dense1024's EuRoC settings relocalizes against an Aachen-sized prior "
               "map: 1,650,000 live landmarks in 2^21 rows, 1,024 slots a query frame, K7 then "
               "K6 from a pose prior"}],
    "workloads": [{
        "name": RELOC, "config": "vo_reloc1650k", "traffic": "reloc_pool64", "chips": 1,
        "why": "a relocalization service: one lost robot's EuRoC frame a call against all 2^21 "
               "map rows of a 1.7 km city grid, closed loop, pool of 64 frames; K7 leads, then "
               "K6; no frame loop, no fold"}],
    "per_layer": [{
        "name": "map_match_roofline", "unit": "%", "better": "higher", "source": "device_trace",
        "layer": "kernels", "moves": "frames_per_s", "workloads": [RELOC]}],
    "listed_in": ["call_p95_ms", "device_idle_pct", "kernels_per_call"],
}


def with_reloc(root):
    """``root`` made a checkout whose BENCHMARK.json holds ``RELOC_ENTRIES``."""
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    if RELOC not in {w["name"] for w in bench["workloads"]}:
        for group in ("configs", "workloads", "per_layer"):
            bench[group] += RELOC_ENTRIES[group]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in RELOC_ENTRIES["listed_in"]:
                m["workloads"].append(RELOC)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = with_reloc(tmp_path_factory.mktemp("reloc"))
    (root / "vobench").symlink_to(harness.REPO / "vobench")
    return root


def test_the_tracking_cells_name_no_generator():
    assert set(CELLS) == {"ref128.fleet64", "dense1024.seq512", "ref128.single",
                          "dense1024.chunks4"}
    for name in CELLS:
        c = harness.cell(name)
        assert "generator" not in c.config
        assert c.generator_path == harness.REPO / harness.DEFAULT_GENERATOR
        assert set(c.limits) == set(compare.NUMBERS)


def _same(a, b) -> bool:
    """Bit-for-bit equality of tensors, or of lists and tuples of them."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("name", CELLS)
def test_a_tracking_cell_reads_the_same_pool_and_numbers(name):
    from vobench import generator

    c = tiny(name)
    pool = harness.make_pool(c, SEED, "cpu")
    t = c.traffic
    direct = generator.make_pool(int(t["pool_calls"]) * int(t["sequences_per_call"]),
                                 int(c.config["frames"]), int(c.config["slots"]),
                                 int(c.config["appearance_dim"]), c.config["camera"],
                                 c.config["scene"], SEED, "cpu")
    assert list(pool) == ["points", "appearances", "masks"]
    for k in direct:
        assert torch.equal(pool[k], direct[k]), k
    module = harness.reference(c)
    ref = harness.run_reference(c, pool)
    with torch.no_grad():
        ref_direct = module.track(pool["points"], pool["appearances"], pool["masks"],
                                  c.config["vo_config"], c.config["camera"], torch.float64)
    assert set(ref) == set(ref_direct)
    for k in ref_direct:
        assert _same(ref[k], ref_direct[k]), k
    entry = harness.make_entry(c, pool, "cpu")
    kept = {k: entry.collect(entry(k)) for k in range(entry.calls)}
    gaps = getattr(module, "gaps", compare.gaps)
    expected = {}
    for number in compare.NUMBERS:
        vals = [gaps(out, compare.select(ref_direct, entry.sequences(k)))[number]
                for k, out in sorted(kept.items())]
        expected[number] = float("nan") if any(v != v for v in vals) else max(vals)
    numbers = harness.check(c, entry, kept, ref)
    assert list(numbers) == list(compare.NUMBERS)
    assert numbers == expected
    correct, checks = harness._judge(c, numbers, True)
    assert correct and list(checks) == list(compare.NUMBERS)


def _with_reference(root, tmp_path, source: str) -> harness.Cell:
    path = tmp_path / "stub_reference.py"
    path.write_text(source)
    return dataclasses.replace(harness.cell(RELOC, root), reference_path=path)


class _OneCall:
    def sequences(self, k):
        return range(k, k + 1)


def test_a_number_computed_without_a_limit_fails(root, tmp_path):
    c = _with_reference(root, tmp_path, (
        "def gaps(prog, ref):\n"
        "    return {'pose_gap': 0.0, 'count_gap': 0.0, 'inlier_gap': float(prog['n'])}\n"))
    found = harness.check(c, _OneCall(), {0: {"n": 0}, 1: {"n": 0}}, {"n": torch.zeros(2)})
    assert found == {"pose_gap": 0.0, "count_gap": 0.0, "inlier_gap": 0.0}
    correct, checks = harness._judge(c, found, True)
    assert not correct
    assert checks["inlier_gap"] == {"value": 0.0, "limit": None}
    assert checks["pose_gap"]["limit"] == c.limits["pose_gap"]


def test_a_limited_number_not_computed_fails(root, tmp_path):
    c = _with_reference(root, tmp_path, (
        "def gaps(prog, ref):\n"
        "    return {'pose_gap': float(prog['n'] - ref['n'][0])}\n"))
    found = harness.check(c, _OneCall(), {0: {"n": 0}, 1: {"n": 0}}, {"n": torch.tensor([0, 0])})
    assert found == {"pose_gap": 0.0}
    correct, checks = harness._judge(c, found, True)
    assert not correct and checks["count_gap"] == {"value": None, "limit": c.limits["count_gap"]}
    correct, _ = harness._judge(c, {"pose_gap": 0.0, "count_gap": 0.0}, True)
    assert correct
    # A number that one call's reading lacks reads NaN over the calls.
    assert math.isnan(compare.worst([{"count_gap": 0.0}, {}])["count_gap"])


def test_a_missing_generator_fails_in_cell(tmp_path):
    with_reloc(tmp_path)
    shutil.copytree(harness.REPO / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "vobench/configs/vo_reloc1650k.json"
    config = json.loads(path.read_text())
    config["generator"] = "vobench/generators/missing.py"
    path.write_text(json.dumps(config))
    with pytest.raises(FileNotFoundError, match="vobench/generators/missing.py"):
        harness.cell(RELOC, tmp_path)


def test_the_reloc_cell_is_found_by_name(root):
    c = harness.cell(RELOC, root)
    assert c.generator_path == root / "vobench/generators/reloc.py"
    assert set(c.limits) == {"pose_gap", "count_gap"}
    assert {m["name"] for m, _ in c.end_to_end} == {"frames_per_s", "call_p95_ms", "setup_s"}
    assert {m["name"] for m, _ in c.per_layer} == {"device_idle_pct", "kernels_per_call",
                                                   "map_match_roofline"}
    assert c.config["vo_config"]["map_capacity"] == c.config["scene"]["map_rows"] == 1 << 21


def test_the_reloc_pool_holds_the_map_and_the_priors(root):
    c = tiny(RELOC, root)
    pool = harness.make_pool(c, SEED, "cpu")
    again = harness.make_pool(c, SEED, "cpu")
    for k in pool:
        assert torch.equal(pool[k], again[k]), k
    scene = c.config["scene"]
    assert pool["points"].shape == (8, 1, 128, 2)
    assert int(pool["map_valid"].sum()) == scene["mapped"]
    assert bool(pool["map_valid"][:scene["mapped"]].all())
    held = harness.generator(c).occupancy(pool)
    assert held["live_slots_min"] == scene["features_per_frame"]
    assert held["map_rows_live"] == scene["mapped"] and held["map_rows"] == 1 << 14
    rot = pool["priors"][:, :3, :3].double()
    assert torch.allclose(rot @ rot.transpose(1, 2), torch.eye(3, dtype=torch.float64),
                          atol=1e-5)
    # The landmarks lie on the streets' facades, within the square the map spans.
    half = 0.5 * scene["extent"]
    points = pool["map_points"][pool["map_valid"]]
    assert float(points[:, [0, 2]].abs().max()) <= half + 8.0
    assert float(points[:, 1].abs().max()) <= 1.0
    # No query row equals a map row: every live slot's nearest row lies at a distance.
    live = pool["masks"][:, 0].reshape(-1)
    q = pool["appearances"][:, 0].reshape(-1, 10)[live]
    dist, _ = vo_reloc.nearest(q, torch.ones(len(q), dtype=torch.bool), pool["map_appearances"],
                               pool["map_valid"], torch.float64)
    assert float(dist.min()) > 0.0


def test_the_query_poses_face_their_facade():
    from vobench.generators import reloc

    scene = {"streets_per_axis": 2, "extent": 100.0, "wobble": [0.0] * 6}
    street = torch.arange(4)
    pose = reloc.query_poses(street, torch.full((4,), 10.0, dtype=torch.float64),
                             torch.zeros(4, dtype=torch.float64), scene)
    r_st, o_st = reloc.streets(scene, "cpu")
    assert torch.equal(o_st[:, 2], torch.tensor([-25.0, 25.0, 0.0, 0.0], dtype=torch.float64))
    # A point 5 m in front of the camera on its street's facade side.
    local = torch.tensor([10.0, 0.0, 5.0], dtype=torch.float64)
    world = (r_st @ local) + o_st
    cam = (pose[:, :3, :3] @ world[:, :, None])[..., 0] + pose[:, :3, 3]
    assert torch.allclose(cam, torch.tensor([0.0, 0.0, 5.0], dtype=torch.float64).expand(4, 3),
                          atol=1e-12)


def test_the_reloc_reference_agrees_with_the_program(root):
    c = tiny(RELOC, root)
    result = run(c, SEED)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 16
    assert list(result["checks"]) == ["pose_gap", "count_gap"]
    assert result["checks"]["count_gap"]["value"] == 0.0
    assert result["checks"]["pose_gap"]["value"] < 1e-3
    assert set(result["metrics"]) == {m["name"] for m, _ in c.end_to_end}
    assert "map_fill_mean" not in result["occupancy"]
    assert result["occupancy"]["map_rows_live"] == c.config["scene"]["mapped"]


def test_the_reloc_reference_matches_as_the_program_does(root):
    c = tiny(RELOC, root)
    pool = harness.make_pool(c, SEED, "cpu")
    q = pool["appearances"][:, 0].reshape(-1, 10)
    qm = pool["masks"][:, 0].reshape(-1)
    dist, idx = vo_reloc.nearest(q, qm, pool["map_appearances"], pool["map_valid"],
                                 torch.float64)
    p_dist, p_idx = matching.best_match(q, qm, pool["map_appearances"], pool["map_valid"])
    r2 = float(torch.tensor(0.1, dtype=torch.float32) ** 2)
    matched, p_matched = qm & (dist < r2), qm & (p_dist < r2)
    assert torch.equal(matched, p_matched)
    assert torch.equal(idx[matched], p_idx[matched].long())
    assert 0.7 < float(matched.double().sum() / qm.double().sum()) < 0.9
    assert float(dist[matched].min()) > 0.0


def test_map_match_roofline_reads_the_stage_device_time(root):
    reader = harness.load_module(harness.REPO / "vobench/metrics/map_match_roofline.py")
    c = harness.cell(RELOC, root)
    chip = peaks.chip("NVIDIA H100 80GB HBM3", 132)

    class Entry:
        def map_match_work(self):
            return workmodels.matcher_model(1024, 1 << 21, 10)

    ops = [tracing.DeviceOp("best_match_tc_kernel", "kernel", 0.0, 648.0, "vo/map_match"),
           tracing.DeviceOp("picp_solve_kernel", "kernel", 700.0, 235.0, "vo/solve")]
    trace = tracing.Trace(window_us=1400.0, calls=2, ops=ops, busy_us=883.0, idle={},
                          call_kernels=[1, 1])
    ctx = types.SimpleNamespace(cell=c, entry=Entry(), window=types.SimpleNamespace(trace=trace),
                                chip=chip)
    least = Entry().map_match_work().least_s(chip)
    assert least == pytest.approx(64.819e-6, rel=1e-4)   # bound by the compares
    assert reader.read(ctx) == pytest.approx(100.0 * 2 * least / 648e-6)
    trace.ops = ops[1:]
    assert reader.read(ctx) is None


def _unchanged_state(orig):
    def solve(camera, *args, **kw):
        _, stats = orig(camera, *args, **kw)
        return camera, stats   # the pose prior returned as the solution
    return solve


def _doubled_translation(orig):
    def solve(*args, **kw):
        cam, stats = orig(*args, **kw)
        pose = cam.world_in_camera.clone()
        pose[:3, 3] *= 2.0
        return picp.with_pose(cam, pose), stats
    return solve


def _half_the_matches(orig):
    def best_match(queries, q_mask, *args, **kw):
        dist, idx = orig(queries, q_mask, *args, **kw)
        dist = dist.clone()
        dist[queries.shape[0] // 2:] = 3.4e38   # the second half of the queries match nothing
        return dist, idx
    return best_match


def _bf16_filter(orig):
    def best_match(queries, q_mask, rows, row_valid, **kw):
        # The top-1 by a bfloat16 gram (the fast filter's) with no exact
        # re-selection: its distance and its row are the answer.
        q, r = queries.bfloat16().float(), torch.where(row_valid[:, None], rows, 0.0)
        d = ((queries * queries).sum(-1)[:, None]
             + torch.where(row_valid, (r * r).sum(-1), float("inf"))[None, :]
             - 2.0 * (q @ r.bfloat16().float().T))
        dist, idx = d.min(dim=1)
        return torch.where(q_mask, dist.clamp_min(0.0), float("inf")), idx.to(torch.int32)
    return best_match


def _frames_swapped(orig):
    def make_entry(*args, **kw):
        entry = orig(*args, **kw)
        entry.frames[0], entry.frames[1] = entry.frames[1], entry.frames[0]
        return entry
    return make_entry


@pytest.mark.parametrize("fault", ["control", "unchanged_state", "doubled_translation",
                                   "half_the_matches", "frames_swapped", "bf16_filter"])
def test_a_broken_relocalization_is_not_correct(root, fault, monkeypatch):
    if fault in ("unchanged_state", "doubled_translation"):
        broken = _unchanged_state if fault == "unchanged_state" else _doubled_translation
        monkeypatch.setattr(picp, "solve", broken(picp.solve))
    elif fault in ("half_the_matches", "bf16_filter"):
        broken = _half_the_matches if fault == "half_the_matches" else _bf16_filter
        monkeypatch.setattr(matching, "best_match", broken(matching.best_match))
    elif fault == "frames_swapped":
        monkeypatch.setattr(harness, "make_entry", _frames_swapped(harness.make_entry))
    control = torch.bfloat16 if fault == "control" else None
    c = tiny(RELOC, root)
    if fault == "bf16_filter":
        # The cell's full frames (1,000 features in 1,024 slots), so that a
        # share of wrong matches counts as many as in the cell's calls.
        c.config["scene"]["features_per_frame"] = 1000
        c.config["slots"] = 1024
        c.config["vo_config"]["n_slots"] = 1024
    result = run(c, SEED, control=control)
    assert not result["correct"], result["checks"]
