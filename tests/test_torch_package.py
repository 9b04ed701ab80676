"""Packaging contracts of visual_odometry_tpu_torch: it never imports JAX or
the JAX package, imports no GPU machinery at import time, chip_smoke.py
refuses to report a result on a host without a CUDA card, and every public
name of the JAX package has a counterpart in the port or a documented reason."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "visual_odometry_tpu_torch")
JAX_PKG = os.path.join(ROOT, "visual_odometry_tpu")

# Public names of the JAX package that the port's matching module does not
# define under the same name. Renamed: (JAX module, name) -> "port module:its
# name" (README.md, "The PyTorch/CUDA port", shows both tables).
RENAMED = {
    ("ops/matching.py", "pairwise_sq_dists"):
        "ops/kernels/matcher_kernel.py:pairwise_sq_dists",
    ("ops/pallas/matcher_kernel.py", "match_pairs_pallas"):
        "ops/kernels/matcher_kernel.py:match_pairs",
    ("ops/pallas/matcher_kernel.py", "best_match_pallas"):
        "ops/kernels/matcher_kernel.py:best_match",
    ("ops/pallas/frame_kernel.py", "track_frames_fused"):
        "ops/kernels/frame_kernel.py:track_frames",
    ("ops/pallas/frame_kernel.py", "track_frames_fused_serving"):
        "ops/kernels/frame_kernel.py:track_frames_batched",
    ("ops/pallas/gather_kernel.py", "take_lanes"): "ops/kernels/gather_kernel.py:gather_rows",
    ("ops/pallas/picp_kernel.py", "gn_loop"): "ops/kernels/frame_kernel.py:track_frames",
    ("ops/pallas/picp_kernel.py", "gn_loop_se2"): "ops/kernels/frame_kernel.py:track_frames",
    ("ops/pallas/picp_kernel.py", "gn_loop_batched"):
        "ops/kernels/frame_kernel.py:track_frames_batched",
    ("ops/pallas/picp_kernel.py", "gn_loop_se2_batched"):
        "ops/kernels/frame_kernel.py:track_frames_batched",
    ("ops/pallas/picp_kernel.py", "linearize_pallas"): "ops/kernels/picp_kernel.py:linearize",
}
# ... and not carried over, with the reason.
NOT_CARRIED_OVER = {
    "Array": "the jnp.ndarray alias of every JAX module; the port annotates torch.Tensor",
    "V5E": "utils/roofline's TPU v5e peaks; the port reads the card's from spec_for",
    "V5E_BF16": "the same, bf16",
    "dispatch_overhead_s": "a TPU tunnel's dispatch latency; roofline.launch_floor measures "
                           "the card's",
    "PALLAS_MIN_DB": "ops/matching's TPU routing threshold; the port launches K7 for any "
                     "CUDA tensor",
    "LANE": "the TPU's 128-lane vector width, a Pallas tiling constant",
}


def _modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return mods


def test_port_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where `import jax` fails."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['visual_odometry_tpu'] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "assert not any(k.startswith('jax') for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|visual_odometry_tpu)(\.|\s|$)", re.M)
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f
    for script in ("chip_smoke.py", "chip_ab.py"):
        with open(os.path.join(ROOT, script)) as fh:
            assert not pat.search(fh.read()), script


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; chip_smoke.py runs for real there")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_ab_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; chip_ab.py runs for real there")
    for mode in ("serving", "launch"):
        res = subprocess.run([sys.executable, "chip_ab.py", mode, ROOT, "--pairs", "1"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ab"' not in res.stdout


def test_default_device_needs_cuda():
    from visual_odometry_tpu_torch import default_device

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()


def test_precision_is_pinned_to_float32():
    import visual_odometry_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_library_lists_every_source_and_symbol():
    """Every CUDA source under csrc/ is built, every bound symbol is exported
    by one of them, and every kernel that counts launches names a bound symbol."""
    from visual_odometry_tpu_torch.ops.kernels import _lib

    on_disk = sorted(f for f in os.listdir(_lib.CSRC))
    assert sorted(_lib.SOURCES + _lib.HEADERS) == on_disk
    text = "".join(open(os.path.join(_lib.CSRC, f)).read() for f in _lib.SOURCES)
    for symbol in _lib._SIGNATURES:
        assert re.search(r"VO_EXPORT int " + symbol + r"\(", text), symbol
    for kernel in _lib.launches:
        base = kernel.removesuffix("_fast")
        assert "vo_" + base in _lib._SIGNATURES, kernel
    mods = set(_modules())
    for new in ("ops.picp", "ops.picp_se2", "ops.linalg6", "ops.stats", "ops.kernels.picp_kernel",
                "utils.checkpoint", "utils.timing", "utils.profiling",
                "ops.kernels.segsum_kernel", "parallel", "parallel.multiseq",
                "parallel.sparse_ba", "parallel.bundle_adjustment", "models.refinement",
                "parallel.scaling", "graft_entry"):
        assert "visual_odometry_tpu_torch." + new in mods
    for src in ("track_frames.cu", "picp_linearize.cu", "take_table.cu", "segment_sum.cu",
                "eight_point.cu", "map_fold.cu"):
        assert src in _lib.SOURCES
    assert "visual_odometry_tpu_torch.ops.kernels.epipolar_kernel" in mods
    assert "visual_odometry_tpu_torch.ops.kernels.map_kernel" in mods
    for kernel in ("track_frames_batched", "track_frames_batched_planar", "segment_sum",
                   "take_table", "picp_linearize", "eight_point", "map_fold"):
        assert _lib.launches[kernel] == 0


def test_chip_smoke_names_every_kernel():
    """chip_smoke.KERNELS lists all eleven kernels of the JAX package (K4-K8
    in both estimation groups, K7 in both precisions) and the port-only P1 and P2:
    every launch counter, each with a source that is built and the TPU kernel
    it replaces (P1, P2: the JAX function each computes, which has no kernel)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from visual_odometry_tpu_torch.ops.kernels import _lib

    assert set(chip_smoke.KERNELS) == set(_lib.launches)
    replaced = set()
    for name, (source, replaces, path) in chip_smoke.KERNELS.items():
        assert os.path.basename(source) in _lib.SOURCES, name
        assert os.path.isfile(os.path.join(ROOT, source)), name
        tpu_file, line = replaces.split(":")
        with open(os.path.join(ROOT, tpu_file)) as fh:
            assert int(line) <= len(fh.readlines()), name
        if name in chip_smoke.PORT_ONLY:
            assert not tpu_file.startswith("visual_odometry_tpu/ops/pallas/"), name
        else:
            replaced.add(replaces)
        assert path in "ABCDEFG", name
    assert chip_smoke.PORT_ONLY == ("eight_point", "map_fold")
    # Eleven kernels; K6 has two call sites (solve_fused, solve_se2_fused), and
    # the planar K5 and K8 are named by their GN loops' lines.
    assert len(replaced) == 13


def test_trace_writes_a_chrome_trace(tmp_path):
    """``profiling.trace`` writes the block's torch.profiler trace into the
    directory, with the pipeline's ``vo/<stage>`` ranges in it; where it cannot
    write, it raises instead of quietly writing nothing."""
    import json

    import numpy as np

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.utils import profiling, synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig

    pts, apps, masks = (torch.from_numpy(x) for x in
                        synthetic.generate_tracking_sequence(np.random.default_rng(0), 4, 64))
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        pipeline.run_sequence(synthetic.deep_camera(), VOConfig(n_slots=64, map_capacity=128),
                              pts, apps, masks)
    (path,) = log_dir.iterdir()
    assert path.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"vo/bootstrap_init", "vo/frame_loop"} <= names
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    with pytest.raises(RuntimeError, match="directory"):
        with profiling.trace(str(blocked)):
            torch.ones(4).sum()


def _names(path: str, imported: bool = False) -> set:
    """Top-level functions, classes and assigned names of a module, by ``ast``
    (nothing is imported); with ``imported`` also the names its ``from``
    imports bind."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imported and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return names


def _public(names: set) -> set:
    return {n for n in names if not n.startswith("_")}


def _jax_modules():
    """(JAX source, its port's source) for every module of the JAX package,
    ``ops/pallas`` mapped to ``ops/kernels``, and the root ``__graft_entry__``
    to ``graft_entry``."""
    pairs = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                pairs.append((rel, rel.replace(os.path.join("ops", "pallas"),
                                               os.path.join("ops", "kernels"))))
    pairs.append(("../__graft_entry__.py", "graft_entry.py"))
    return sorted(pairs)


@pytest.mark.parametrize("jax_rel,port_rel", _jax_modules())
def test_every_public_jax_name_has_a_counterpart(jax_rel, port_rel):
    """Walks the JAX module's public names with ``ast`` (no JAX import) and
    requires each in the port's matching module, or in RENAMED (the port's
    name must exist where the table says) or NOT_CARRIED_OVER. The root entry
    also keeps its ``_synthetic_state``."""
    port = os.path.join(PKG, port_rel)
    assert os.path.isfile(port), f"no port of {jax_rel}: {port_rel} is missing"
    have = _names(port, imported=True)
    wanted = _public(_names(os.path.join(JAX_PKG, jax_rel)))
    if port_rel == "graft_entry.py":
        wanted.add("_synthetic_state")
    missing = []
    for name in sorted(wanted - have):
        renamed = RENAMED.get((jax_rel.replace(os.sep, "/"), name))
        if renamed is not None:
            module, port_name = renamed.split(":")
            assert port_name in _names(os.path.join(PKG, module)), renamed
        elif name not in NOT_CARRIED_OVER:
            missing.append(name)
    assert not missing, f"{jax_rel}: no counterpart in {port_rel} for {missing}"


def test_not_carried_over_table_is_current():
    """Every RENAMED and NOT_CARRIED_OVER entry names a JAX public name that the
    port's matching module really lacks: the tables hold no stale line."""
    lacking = set()
    for jax_rel, port_rel in _jax_modules():
        gap = (_public(_names(os.path.join(JAX_PKG, jax_rel)))
               - _names(os.path.join(PKG, port_rel), imported=False))
        lacking |= {(jax_rel.replace(os.sep, "/"), n) for n in gap}
    assert set(RENAMED) <= lacking
    assert set(NOT_CARRIED_OVER) <= {n for _, n in lacking}
