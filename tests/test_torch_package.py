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
