"""Checkpoint / resume for the tracking pipeline
(port of visual_odometry_tpu.utils.checkpoint).

The tracker state (:class:`models.pipeline.VOState`) plus the
trajectory-so-far round-trips through one ``.npz`` file with the JAX
package's field names, so a file either package wrote loads in the other.
All state is explicit; ``pipeline.continue_sequence`` resumes from it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import default_device
from ..models import pipeline
from . import convert


def save_state(file_path: str, state: pipeline.VOState, trajectory) -> None:
    np.savez_compressed(file_path, trajectory=np.asarray(trajectory),
                        **convert.vo_state_to_arrays(state))


def load_state(file_path: str, device=None) -> Tuple[pipeline.VOState, np.ndarray]:
    """Returns (state on ``device``, trajectory as numpy). ``device`` None is
    the CUDA card (:func:`default_device`, which raises without one); pass
    ``device="cpu"`` to resume through the plain versions on the CPU."""
    device = torch.device(device) if device is not None else default_device()
    with np.load(file_path) as z:
        arrays = {k: z[k] for k in z.files}
    trajectory = arrays.pop("trajectory")
    return convert.vo_state_from_flat(arrays, device=device), trajectory
