"""visual_odometry_tpu_torch — the PyTorch/CUDA port of visual_odometry_tpu.

Monocular visual odometry over the reference dataset format (8-point
bootstrap, mid-point triangulation, projective-ICP tracking, appearance
association, exact-appearance landmark map, offline evaluation), with the
main path's hot loops as CUDA kernels written for Hopper (``csrc/``, bound
through ``ops/kernels``). Module names mirror ``visual_odometry_tpu`` so each
function's counterpart is easy to find; the JAX package is the reference
this one is tested against.

Importing the package touches no GPU and builds nothing: kernels are built
with ``nvcc`` at their first launch.
"""

__version__ = "0.1.0"

import torch as _torch

# Precision policy: geometry needs true float32. TF32 keeps ~10 mantissa
# bits, which breaks the epipolar/GN numerics exactly as bf16 did on the TPU
# (the JAX package pins "highest" matmul precision for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def default_device() -> _torch.device:
    """The device the entry points run on when none is given: the CUDA card.

    Raises when CUDA is absent; CPU runs (the tests) pass ``device="cpu"``
    explicitly, so a missing card never silently becomes a CPU run.
    """
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to run "
            "the plain PyTorch versions on the CPU"
        )
    return _torch.device("cuda")
