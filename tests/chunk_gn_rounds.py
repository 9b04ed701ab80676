"""GN rounds a frame of chunked tracking: the JAX package against the port, on the CPU.

Path H of ``chip_smoke.py`` tracks path B's sequence (512 frames x 1,024
slots from seed 0 under ``deep_camera``) as 4 chunks. This script makes the
same plan, tracks the chosen chunks (``pipeline._track`` on each chunk's
frames, as ``run_sequence_chunked`` tracks them) and the same frames
serially, in both packages, and prints each run's GN rounds a frame: the JAX
package's through its ``xla`` scan (the while-loop of its ``picp.solve``,
counted), the port's as its plain version of K4 reports them in
``FrameOutput.gn_rounds`` (the kernels report the same rounds: they agree
with it bit for bit). The JAX bootstrap runs in
float64 as the port's does (``test_torch_pipeline.jax_bootstrap_in_double``);
``--float32-bootstrap`` gives the JAX package's own.

    JAX_PLATFORMS=cpu python tests/chunk_gn_rounds.py [--frames 512] [--slots 1024] [--chunks 0,1]

The plain pair matcher runs 32 pairs at a time (the pairs are independent,
the results the same), which keeps the run at the defaults near 5 GB.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_pipeline import jax_bootstrap_in_double  # noqa: E402
from visual_odometry_tpu.models import pipeline as jpipe  # noqa: E402
from visual_odometry_tpu.ops import picp as jpicp  # noqa: E402
from visual_odometry_tpu.utils import synthetic as jsyn  # noqa: E402
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig  # noqa: E402
from visual_odometry_tpu_torch.models import pipeline as tpipe  # noqa: E402
from visual_odometry_tpu_torch.ops.kernels import matcher_kernel  # noqa: E402
from visual_odometry_tpu_torch.parallel import posegraph  # noqa: E402
from visual_odometry_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from visual_odometry_tpu_torch.utils.config import VOConfig  # noqa: E402


def _counting_solve(camera, world_points, measured_points, weights, num_iterations,
                    kernel_threshold=10000.0, damping=1.0, keep_outliers=False, tolerance=0.0,
                    backend="auto", min_num_inliers=0, min_iterations=1):
    """The JAX package's ``picp.solve`` on its ``xla`` backend with a
    tolerance exit, line for line, handing back its round count as
    ``num_inliers`` (which the scan only reports)."""
    live = weights > 0.0
    world_points = jnp.where(live[:, None], world_points, 1.0)
    measured_points = jnp.where(live[:, None], measured_points, 0.0)
    kt = jnp.asarray(kernel_threshold, world_points.dtype)
    dp = jnp.asarray(damping, world_points.dtype)
    init_stats = jpicp.PICPStats(
        chi_inliers=jnp.zeros((), world_points.dtype),
        chi_outliers=jnp.zeros((), world_points.dtype),
        num_inliers=jnp.zeros((), jnp.int32),
    )
    tol = jnp.asarray(tolerance, world_points.dtype)

    def cond(carry):
        _, _, it, dx2 = carry
        return (it < num_iterations) & ((dx2 > tol) | (it < min_iterations))

    def body(carry):
        cam, _, it, _ = carry
        cam, stats, dx = jpicp.one_round(
            cam, world_points, measured_points, weights, kt, dp, keep_outliers,
            min_num_inliers,
        )
        return cam, stats, it + 1, jnp.sum(dx * dx)

    cam, stats, it, _ = jax.lax.while_loop(
        cond, body, (camera, init_stats, jnp.int32(0), jnp.asarray(jnp.inf, world_points.dtype))
    )
    return cam, stats._replace(num_inliers=it)


@contextlib.contextmanager
def _swapped(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _sliced_matcher(step: int = 32):
    plain = matcher_kernel.match_pairs_plain

    def run(app1, mask1, app2, mask2):
        parts = [plain(app1[a:a + step], mask1[a:a + step], app2[a:a + step], mask2[a:a + step])
                 for a in range(0, app1.shape[0], step)]
        return tuple(torch.cat(x) for x in zip(*parts))

    return run


def jax_rounds(points, appearances, masks, slots: int, double_bootstrap: bool = True,
               count: bool = True):
    """The JAX package's ``_track`` (``xla`` scan) on these frames: (GN rounds
    a tracked frame (F-2,) or None, poses (F-2, 4, 4))."""
    cfg = JaxConfig(n_slots=slots, map_capacity=2 * slots, scan_backend="xla")
    ids = jnp.full(masks.shape, -1, jnp.int32)
    args = [jnp.asarray(x) for x in (points, appearances, masks)]
    boot = jax_bootstrap_in_double() if double_bootstrap else contextlib.nullcontext()
    solve = _counting_solve if count else jpipe.picp.solve
    with boot, _swapped(jpipe.picp, "solve", solve):
        jax.clear_caches()
        _, outs, _ = jax.jit(jpipe._track, static_argnums=(1, 6))(
            jsyn.deep_camera(), cfg, *args, ids, False)
        rounds, poses = np.asarray(outs.num_inliers), np.asarray(outs.pose)
    jax.clear_caches()
    return (rounds if count else None), poses


def port_rounds(points, appearances, masks, slots: int):
    """The port's ``_track`` on these frames through the plain versions:
    (its GN rounds a tracked frame, ``FrameOutput.gn_rounds`` (F-2,), poses
    (F-2, 4, 4))."""
    cfg = VOConfig(n_slots=slots, map_capacity=2 * slots)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (points, appearances, masks)]
    ids = torch.full(t[2].shape, -1, dtype=torch.int32)
    with _swapped(matcher_kernel, "match_pairs_plain", _sliced_matcher()):
        _, outs, _ = tpipe._track(tsyn.deep_camera(), cfg, *t, ids, False)
    return outs.gn_rounds.numpy(), outs.pose.numpy()


def _summary(rounds, cap: int) -> dict:
    return dict(mean=float(rounds.mean()), capped=int((rounds >= cap).sum()),
                mean_uncapped=float(rounds[rounds < cap].mean()), frames=int(rounds.size))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--slots", type=int, default=1024)
    ap.add_argument("--chunks", default="0,1", help="which chunks of the plan, by index")
    ap.add_argument("--float32-bootstrap", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    pts, apps, masks = tsyn.generate_tracking_sequence(np.random.default_rng(0), a.frames, a.slots)
    cfg = VOConfig(n_slots=a.slots, map_capacity=2 * a.slots)
    cap = cfg.gn_iterations
    with _swapped(matcher_kernel, "match_pairs_plain", _sliced_matcher()):
        t = [torch.from_numpy(x) for x in (pts, apps, masks)]
        starts, length, _ = posegraph._plan(cfg, *t, torch.full(t[2].shape, -1, dtype=torch.int32),
                                            False, 4, 10, None)
    report = dict(frames=a.frames, slots=a.slots, starts=list(starts), chunk_len=length,
                  gn_iterations=cap, jax_bootstrap="float32" if a.float32_bootstrap else "float64",
                  chunks={})
    for c in (int(x) for x in a.chunks.split(",")):
        lo, hi = starts[c], min(starts[c] + length, a.frames)
        seg = [x[lo:hi] for x in (pts, apps, masks)]
        ser = [x[:hi] for x in (pts, apps, masks)]
        row = {}
        for pkg, fn in (("jax", lambda *x: jax_rounds(*x, a.slots, not a.float32_bootstrap)[0]),
                        ("port", lambda *x: port_rounds(*x, a.slots)[0])):
            row[pkg + "_chunk"] = _summary(fn(*seg), cap)
            # The serial run's tracked frame j is frame j + 2: frames lo+2..hi-1.
            row[pkg + "_serial_same_frames"] = _summary(fn(*ser)[lo:hi - 2], cap)
        report["chunks"][f"chunk {c} (frames {lo}-{hi - 1})"] = row
        print(json.dumps({f"chunk {c}": row}), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
