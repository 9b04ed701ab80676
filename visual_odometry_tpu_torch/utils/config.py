"""Configuration for the VO pipeline (port of visual_odometry_tpu.utils.config).

Same field names and defaults as the JAX ``VOConfig``, so a config converts
field for field (``utils/convert.config_from_dict``). The defaults reproduce
the reference's ``vo_complete`` (gn_iterations=100, kernel_threshold=1e4,
damping=1, match_radius=0.1, min_num_inliers=0).

Backend knobs take ``auto | cuda | torch``:

  * ``auto``  — the CUDA kernel for a CUDA tensor, the plain PyTorch version
    for a CPU tensor;
  * ``cuda``  — the kernel; a CPU tensor raises;
  * ``torch`` — the plain PyTorch version on any device.

``matcher_backend`` routes the pair matcher (kernel K1), ``scan_backend`` the
fused frame loop and its helpers (K2 join candidates, K3 lane gathers, K4
frame tracking). ``solver_backend`` routes the standalone PICP solve, which
this package does not port yet; it is validated and kept for field parity.
"""

from __future__ import annotations

import dataclasses

BACKENDS = ("auto", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class VOConfig:
    # --- static shapes ---
    n_slots: int = 128          # measurement slots per frame
    map_capacity: int = 1024    # landmark-map capacity

    # --- solver ---
    gn_iterations: int = 100
    kernel_threshold: float = 10000.0
    damping: float = 1.0
    min_num_inliers: int = 0
    keep_outliers: bool = False
    gn_tolerance: float = 1e-12     # early exit on ||dx||^2; <= 0: fixed budget
    gn_min_iterations: int = 1
    warm_start: bool = False

    # --- data association ---
    match_radius: float = 0.1
    matcher_backend: str = "auto"
    matcher_precision: str = "highest"

    # --- estimation group (planar est_SE2 is not ported yet) ---
    planar: bool = False
    cam_in_robot: "tuple | None" = None

    # --- sequence parallelism (not ported yet) ---
    num_chunks: int = 1
    chunk_overlap: int = 10

    # --- global refinement (not ported yet) ---
    refine_iterations: int = 0
    refine_damping: float = 1.0
    refine_backend: str = "dense"

    # --- numerics / backends ---
    solver_backend: str = "auto"
    scan_backend: str = "auto"
    # Depth of the precomputed world-join candidate chains (K2); lanes whose
    # duplicate-target multiplicity exceeds it raise FusedJoinDepthError.
    fused_join_depth: int = 2

    def __post_init__(self):
        for name in ("matcher_backend", "scan_backend", "solver_backend"):
            value = getattr(self, name)
            if value not in BACKENDS:
                raise ValueError(f"{name}={value!r}; expected one of {BACKENDS}")
        if self.fused_join_depth < 1:
            raise ValueError("fused_join_depth must be >= 1")

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    def check_supported(self) -> None:
        """Raise NotImplementedError for options this port does not run yet."""
        if self.planar:
            raise NotImplementedError(
                "planar=True (est_SE2, kernel K5) is not ported yet: ROADMAP.md "
                "queue 1 item 7 / queue 2 K5"
            )
        if self.num_chunks > 1:
            raise NotImplementedError(
                "num_chunks > 1 (chunked tracking, parallel/posegraph) is not "
                "ported yet: ROADMAP.md queue 1 item 11"
            )
        if self.refine_iterations > 0:
            raise NotImplementedError(
                "refine_iterations > 0 (bundle adjustment) is not ported yet: "
                "ROADMAP.md queue 1 items 9-10"
            )


DEFAULT_CONFIG = VOConfig()
