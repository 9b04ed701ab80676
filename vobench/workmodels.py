"""Work models of the kernels the benchmark reads a roofline share of.

Frozen copy of ``visual_odometry_tpu_torch/utils/roofline.py`` at commit
9bfc263 (``GN_SHARED_OPS``, ``GN_OPS_PER_POINT_ROUND``,
``FRAME_OPS_PER_LANE``, ``JOIN_OPS_PER_LEVEL``, ``_frame_counts``,
``_params_bytes``, ``frame_model``, ``serving_model``). The counting rule is
the least work any implementation with the same outputs must do: a multiply
feeding an add counts once, each input byte is read once and each output
byte written once, and the GN rounds are the rounds these inputs need, which
the caller takes from the benchmark's reference, never from the program.

``matcher_model`` is a frozen copy of ``utils/roofline.py``
``matcher_model`` at commit 909746c (K7, the map-scale top-1).
"""

from __future__ import annotations

import dataclasses

from . import peaks

# Operations of one lane in one GN round (csrc/gn_loop.cuh gn_point_terms).
GN_SHARED_OPS = (9, 9, 3, 2, 13, 2, 2, 5, 4, 15, 5)
GN_OPS_PER_POINT_ROUND = {
    False: sum(GN_SHARED_OPS) + 12 + 12 + 42 + 12 + 30,
    True: sum(GN_SHARED_OPS) + 6 + 6 + 18 + 6 + 12 + 6 + 12,
}
# One tracked frame's lane work outside the GN rounds: the carried
# triangulation moved by the last pose, the first join level, the solver
# weight, the dead-slot selects, the mid-point triangulation and the
# correspondence count; each further join level 7.
FRAME_OPS_PER_LANE = 84
JOIN_OPS_PER_LEVEL = 7


@dataclasses.dataclass(frozen=True)
class Work:
    """The work of one call of a kernel function."""

    name: str
    fp32_ops: float
    hbm_bytes: float
    tc_flops: float = 0.0   # tensor-core FLOPs

    def least_s(self, chip: peaks.Chip) -> float:
        """Least seconds on ``chip``: the largest of operations over the FP32
        rate, tensor-core FLOPs over the bf16 tensor-core rate and bytes over
        the memory bandwidth."""
        return max(self.fp32_ops / chip.fp32_ops, self.tc_flops / chip.tc_bf16_flops,
                   self.hbm_bytes / chip.hbm_bw)


def _frame_counts(frames: int, s: int, depth: int, rounds: float, planar: bool):
    lane = (FRAME_OPS_PER_LANE + JOIN_OPS_PER_LEVEL * (depth - 1)
            + rounds * GN_OPS_PER_POINT_ROUND[planar])
    return (frames * s * lane,
            frames * (s * (5.0 * depth + 17 + 13) + 80) + 13.0 * s)


def _params_bytes(planar: bool) -> float:
    return 4.0 * (64 if planar else 40)


def frame_model(frames: int, s: int, depth: int, rounds: float, planar: bool = False) -> Work:
    """K4 (K5 planar): one sequence's fused loop over ``frames`` tracked frames
    of S lanes at ``rounds`` GN rounds a frame."""
    ops, moved = _frame_counts(frames, s, depth, rounds, planar)
    return Work("frame", ops, moved + _params_bytes(planar))


def serving_model(sequences: int, frames: int, s: int, depth: int, rounds: float,
                  planar: bool = False) -> Work:
    """K8: the loops of ``sequences`` sequences at ``rounds`` GN rounds a frame
    (their mean), each with its start pose."""
    ops, moved = _frame_counts(frames, s, depth, rounds, planar)
    return Work("serving", sequences * ops, sequences * (moved + 48.0) + _params_bytes(planar))


def matcher_model(q: int, k: int, d: int) -> Work:
    """K7, the top-1 of Q queries against K rows of D: the gram 2 Q K D on
    the tensor cores and one compare a pair (both of the kernel's modes
    filter on a tensor-core gram and re-select among the rows the filter
    leaves, so one floor holds both); queries, rows and masks in, a
    (distance, index) a query out."""
    return Work("matcher", fp32_ops=float(q * k + (q + k) * d),
                hbm_bytes=4.0 * d * (q + k) + q + k + 8.0 * q, tc_flops=2.0 * q * k * d)
