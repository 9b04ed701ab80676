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

``matcher_backend`` routes the pair matcher (kernel K1) and the map-scale
top-1 matcher (K7), ``scan_backend`` the fused frame loop and its helpers (K2
join candidates, K3 lane gathers, K4 frame tracking, K5 its planar form),
``solver_backend`` the standalone SE(3) PICP solve of ``ops/picp.solve`` (K6;
``torch`` is the plain round-by-round loop).

``scan_backend`` has one more value, ``step``: the frame loop as a Python
loop over ``pipeline.frame_step`` (the JAX package's ``"xla"`` scan), which
solves each frame through ``ops/picp.solve`` or ``ops/picp_se2.solve_se2``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BACKENDS = ("auto", "cuda", "torch")
SCAN_BACKENDS = BACKENDS + ("step",)
MATCHER_PRECISIONS = ("highest", "fast")
REFINE_BACKENDS = ("dense", "sparse")


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

    # --- estimation group (reference branch est_SE2) ---
    # planar=True constrains the per-frame solve to SE(2) increments in the
    # robot plane (ops/picp_se2, kernel K5). cam_in_robot is the camera mount
    # as a nested tuple (hashable, as in the JAX config); None = identity.
    planar: bool = False
    cam_in_robot: "tuple | None" = None

    # --- sequence parallelism (not ported yet) ---
    num_chunks: int = 1
    chunk_overlap: int = 10

    # --- global refinement (models/refinement): bundle adjustment after
    # tracking when refine_iterations > 0; "dense" is the Schur form over an
    # (F, L) grid, "sparse" the COO form with matrix-free Schur-CG (K9, K10).
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
        for name, allowed in (("matcher_backend", BACKENDS), ("scan_backend", SCAN_BACKENDS),
                              ("solver_backend", BACKENDS),
                              ("matcher_precision", MATCHER_PRECISIONS),
                              ("refine_backend", REFINE_BACKENDS)):
            value = getattr(self, name)
            if value not in allowed:
                raise ValueError(f"{name}={value!r}; expected one of {allowed}")
        if self.fused_join_depth < 1:
            raise ValueError("fused_join_depth must be >= 1")

    def replace(self, **kw) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    def planar_mount(self):
        """The (4, 4) float32 mount matrix as a numpy array, or None."""
        if self.cam_in_robot is None:
            return None
        return np.asarray(self.cam_in_robot, np.float32)

    def with_planar_mount(self, cam_in_robot) -> "VOConfig":
        """Enable SE(2) estimation with the given camera-mount pose."""
        mount = tuple(tuple(float(x) for x in row) for row in np.asarray(cam_in_robot))
        return self.replace(planar=True, cam_in_robot=mount)

    def check_supported(self) -> None:
        """Raise NotImplementedError for options this port does not run yet."""
        if self.num_chunks > 1:
            raise NotImplementedError(
                "num_chunks > 1 (chunked tracking, parallel/posegraph) is not "
                "ported yet: ROADMAP.md queue 1 item 11"
            )


DEFAULT_CONFIG = VOConfig()
