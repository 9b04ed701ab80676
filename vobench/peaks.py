"""Published peaks of the cards the benchmark runs on.

Frozen copy of ``visual_odometry_tpu_torch/utils/roofline.py``
``DATA_SHEETS`` and ``spec_for`` at commit 9bfc263: NVIDIA's H100 data
sheet and product briefs, dense rates, at the card's full power limit (a
card set below it runs slower under load; the run prints the limit beside
its numbers). Each FP32 rate is SMs x 128 lanes x the boost clock, a
multiply-add one operation.
"""

from __future__ import annotations

import dataclasses

FP32_LANES_PER_SM = 128

# By torch.cuda.get_device_name(): (boost clock Hz, device-memory bytes/s,
# dense bf16 tensor-core FLOP/s).
DATA_SHEETS = {
    "NVIDIA H100 80GB HBM3": (1.98e9, 3.35e12, 989e12),
    "NVIDIA H100 PCIe": (1.755e9, 2.0e12, 756e12),
    "NVIDIA H100 NVL": (1.785e9, 3.9e12, 835e12),
}


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    sms: int
    fp32_ops: float       # CUDA-core FP32 operations/s
    hbm_bw: float         # device-memory bytes/s
    tc_bf16_flops: float  # dense bf16 tensor-core FLOP/s


def chip(name: str, sms: int) -> "Chip | None":
    """The peaks of a card by its name and SM count; None for a card not in the table."""
    sheet = DATA_SHEETS.get(name)
    if sheet is None:
        return None
    clock, hbm_bw, tc = sheet
    return Chip(name=name, sms=int(sms), fp32_ops=sms * FP32_LANES_PER_SM * clock, hbm_bw=hbm_bw,
                tc_bf16_flops=tc)
