"""CPU tests of the reference a configuration names (its ``reference`` key):
the harness loads that module's ``track`` and, where it has one, its
``gaps``; the cells on ``reference/vo.py`` read what ``vo.track`` and
``compare.gaps`` give, bit for bit; the chunked reference
(``reference/vo_chunked.py``) agrees with ``posegraph.run_sequence_chunked``
on the CPU and judges a chunked run broken underneath, and its control, not
correct, at ``limits/dense1024.chunks4.json``."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from visual_odometry_tpu_torch.models import landmark_map, pipeline
from visual_odometry_tpu_torch.parallel import posegraph

from vobench import compare, harness
from vobench.reference import vo
from test_vobench_check import run, tiny

CHUNKED = "dense1024.chunks4"
SEED = 4_000_000_101   # the chunked check's seeds; the control's is SEED + 2
ON_VO = tuple(w["name"] for w in json.loads((harness.REPO / "BENCHMARK.json").read_text())
              ["workloads"]
              if harness.cell(w["name"]).reference_path == harness.REPO / "vobench/reference/vo.py")


def test_the_existing_cells_name_vo():
    assert set(ON_VO) == {"ref128.fleet64", "dense1024.seq512", "ref128.single"}


@pytest.mark.parametrize("name", ON_VO)
def test_a_cell_on_vo_reads_what_vo_and_compare_give(name):
    c = tiny(name)
    pool = harness.make_pool(c, SEED, "cpu")
    ref = harness.run_reference(c, pool)
    with torch.no_grad():
        direct = vo.track(pool["points"], pool["appearances"], pool["masks"],
                          c.config["vo_config"], c.config["camera"])
    assert set(ref) == set(direct)
    for k in direct:
        assert torch.equal(ref[k], direct[k]), k
    entry = harness.make_entry(c, pool, "cpu")
    kept = {k: entry.collect(entry(k)) for k in range(entry.calls)}
    numbers = harness.check(c, entry, kept, ref)
    expected = compare.worst([compare.gaps(out, compare.select(direct, entry.sequences(k)))
                              for k, out in sorted(kept.items())])
    assert list(numbers) == list(compare.NUMBERS)
    assert numbers == expected


def _bench_copy(tmp_path, reference: str) -> str:
    """A copy of the benchmark whose cell ``stub.single`` runs ``vo_ref128``
    with ``reference`` as its configuration's reference."""
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.REPO / "vobench", tmp_path / "vobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((tmp_path / "vobench/configs/vo_ref128.json").read_text())
    config.update(name="vo_stub", reference=reference)
    (tmp_path / "vobench/configs/vo_stub.json").write_text(json.dumps(config))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stub.single", "config": "vo_stub",
                               "traffic": "single_pool64", "chips": 1, "why": "a stub"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return "stub.single"


def test_a_missing_reference_fails_in_cell(tmp_path):
    name = _bench_copy(tmp_path, "vobench/reference/missing.py")
    with pytest.raises(FileNotFoundError, match="vobench/reference/missing.py"):
        harness.cell(name, tmp_path)


def test_a_named_reference_brings_its_track_and_gaps(tmp_path):
    name = _bench_copy(tmp_path, "vobench/reference/stub.py")
    (tmp_path / "vobench/reference/stub.py").write_text(
        "def track(points, appearances, masks, vo, cam, dtype):\n"
        "    return {'rows': points[:, 0, 0, 0].to(dtype)}\n\n"
        "def gaps(prog, ref):\n"
        "    d = float((prog['rows'] - ref['rows']).abs().max())\n"
        "    return {n: d for n in ('boot_gap', 'pose_gap', 'tri_gap', 'map_gap',\n"
        "                           'count_gap', 'mismatch')}\n")
    c = harness.cell(name, tmp_path)
    assert c.reference_path == tmp_path / "vobench/reference/stub.py"
    points = torch.arange(3.0).reshape(3, 1, 1, 1).expand(3, 2, 2, 2)
    ref = harness.run_reference(c, {"points": points, "appearances": None, "masks": None})
    assert torch.equal(ref["rows"], torch.arange(3.0, dtype=torch.float64))

    class Entry:
        def sequences(self, k):
            return range(k, k + 1)

    kept = {k: {"rows": torch.tensor([k + 0.5])} for k in range(3)}
    assert harness.check(c, Entry(), kept, ref) == dict.fromkeys(compare.NUMBERS, 0.5)


def test_the_chunked_reference_agrees_with_the_program():
    c = tiny(CHUNKED)
    assert c.reference_path == harness.REPO / "vobench/reference/vo_chunked.py"
    result = run(c, SEED)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 4
    assert result["checks"]["mismatch"]["value"] == 0


def _in_stitch(monkeypatch, name: str, broken):
    """Replace posegraph's ``name`` by ``broken(original, index of the call
    in this stitch)`` while ``_track_and_stitch`` runs."""
    orig_fn, orig_stitch = getattr(posegraph, name), posegraph._track_and_stitch
    calls = []

    def counted(*args, **kw):
        calls.append(None)
        return broken(orig_fn, len(calls) - 1, *args, **kw)

    def stitch(*args, **kw):
        calls.clear()
        monkeypatch.setattr(posegraph, name, counted)
        try:
            return orig_stitch(*args, **kw)
        finally:
            monkeypatch.setattr(posegraph, name, orig_fn)

    monkeypatch.setattr(posegraph, "_track_and_stitch", stitch)


def _boundary_doubled(orig, i, *args):
    med, cnt = orig(*args)
    return (med * 2.0 if i == 0 else med), cnt   # the first boundary's shared-point ratio


def _last_chunk_unscaled(orig, i, poses, s):
    return poses.clone() if i == 3 else orig(poses, s)   # chunk 3 of 4 keeps its own scale


def _start_moved(orig):
    def plan(*args, **kw):
        starts, length = orig(*args, **kw)
        return (starts[0], starts[1] + 1, *starts[2:]), length
    return plan


def _half_the_map(orig):
    def merge(*args, **kw):
        m = orig(*args, **kw)
        half = m.valid.shape[-1] // 2
        valid = m.valid.clone()
        valid[..., half:] = False
        return m._replace(valid=valid, count=torch.clamp(m.count, max=half))
    return merge


def _half_the_chunks(orig):
    """The chunks' trackers on the CPU (a loop of ``pipeline._track``): the
    second half of the chunks given the first half's results."""
    runs = []

    def track(*args, **kw):
        runs.append(orig(*args, **kw) if len(runs) % 4 < 2 else runs[-2])
        return runs[-1]
    return track


@pytest.mark.parametrize("fault", ["boundary_doubled", "chunk_unscaled", "start_moved",
                                   "half_the_map", "half_the_chunks"])
def test_a_broken_chunked_run_is_not_correct(fault, monkeypatch):
    if fault == "half_the_chunks":
        monkeypatch.setattr(pipeline, "_track", _half_the_chunks(pipeline._track))
    elif fault == "boundary_doubled":
        _in_stitch(monkeypatch, "_masked_median", _boundary_doubled)
    elif fault == "chunk_unscaled":
        _in_stitch(monkeypatch, "_scale_translations", _last_chunk_unscaled)
    elif fault == "start_moved":
        monkeypatch.setattr(posegraph, "plan_chunks", _start_moved(posegraph.plan_chunks))
    else:
        monkeypatch.setattr(landmark_map, "merge_stream",
                            _half_the_map(landmark_map.merge_stream))
    result = run(tiny(CHUNKED), SEED)
    assert not result["correct"], result["checks"]


def test_the_chunked_control_is_not_correct():
    result = run(tiny(CHUNKED), SEED + 2, control=torch.bfloat16)
    assert result["control"] == "bfloat16"
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
def test_a_chunked_call_on_the_card():
    """One call of the chunked cell on two pool items, on the card: its trace
    holds the plan's scores, the stitch and the fold, and both calls are
    correct at the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    harness.program.load_kernels()
    dev = torch.device("cuda", 0)
    c = harness.cell(CHUNKED)
    c.traffic = dict(c.traffic, pool_calls=2)
    pool = harness.make_pool(c, SEED, dev)
    entry = harness.make_entry(c, pool, dev)
    kept = {0: entry.collect(entry(0))}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        kept[1] = entry.collect(entry(1))
        torch.cuda.synchronize()
    assert {"vo/bootstrap_scores", "vo/stitch", "vo/map_fold"} <= {e.name for e in prof.events()}
    ref = harness.run_reference(c, pool)
    correct, checks = harness._judge(c, harness.check(c, entry, kept, ref), True)
    assert correct, checks
