"""Packaging contracts of visual_odometry_tpu_torch: it never imports JAX or
the JAX package, imports no GPU machinery at import time, and chip_smoke.py
refuses to report a result on a host without a CUDA card."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "visual_odometry_tpu_torch")


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
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        assert not pat.search(fh.read())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; chip_smoke.py runs for real there")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


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
                "parallel.sparse_ba", "parallel.bundle_adjustment", "models.refinement"):
        assert "visual_odometry_tpu_torch." + new in mods
    for src in ("track_frames.cu", "picp_linearize.cu", "take_table.cu", "segment_sum.cu"):
        assert src in _lib.SOURCES
    for kernel in ("track_frames_batched", "track_frames_batched_planar", "segment_sum",
                   "take_table", "picp_linearize"):
        assert _lib.launches[kernel] == 0


def test_chip_smoke_names_every_kernel():
    """chip_smoke.KERNELS lists all eleven kernels of the JAX package (K4-K8
    in both estimation groups, K7 in both precisions): every launch counter,
    each with a source that is built and the TPU kernel it replaces."""
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
        replaced.add(replaces)
        assert path in "ABCDEFG", name
    # Eleven kernels; K6 has two call sites (solve_fused, solve_se2_fused), and
    # the planar K5 and K8 are named by their GN loops' lines.
    assert len(replaced) == 13


def test_stage_times_samples_the_entry_points_own_steps():
    """``profiling.stage_times`` collects one sample a call for each step the
    pipeline marks with ``profiling.stage``, for run_sequence in the fused and
    the frame_step form and for relocalize_frame, and nothing outside it."""
    import numpy as np

    from visual_odometry_tpu_torch.models import pipeline
    from visual_odometry_tpu_torch.utils import profiling, synthetic
    from visual_odometry_tpu_torch.utils.config import VOConfig

    pts, apps, masks = (torch.from_numpy(x) for x in
                        synthetic.generate_tracking_sequence(np.random.default_rng(0), 8, 64))
    camera, cfg = synthetic.deep_camera(), VOConfig(n_slots=64, map_capacity=128)
    with profiling.stage_times() as timer:
        traj, map_state, _ = pipeline.run_sequence(camera, cfg, pts, apps, masks)
        pipeline.run_sequence(camera, cfg.replace(scan_backend="step"), pts, apps, masks)
        frame = pipeline.FrameData(pts[3], apps[3], masks[3],
                                   torch.full((64,), -1, dtype=torch.int32))
        pipeline.relocalize_frame(camera, cfg, map_state, frame, torch.eye(4))
    counts = {k: len(v) for k, v in timer.samples.items()}
    assert counts == {
        "bootstrap_match": 2, "bootstrap_init": 2, "batched_match": 2, "join_chains": 1,
        "pixel_gathers": 1, "frame_loop": 1, "appearance_gathers": 1, "frame_step_loop": 1,
        "chains_and_transform": 2, "map_fold": 2, "overflow_check": 2,
        "map_match": 1, "radius_and_gather": 1, "solve": 1,
    }
    assert all(x >= 0.0 for v in timer.samples.values() for x in v)
    pipeline.run_sequence(camera, cfg, pts, apps, masks)      # outside: no new sample
    assert {k: len(v) for k, v in timer.samples.items()} == counts
    assert bool(torch.isfinite(traj).all())
