"""The port's utils/selfcheck on the CPU, against the JAX package's.

``run_all(device="cpu")`` runs the eight checks with each kernel's plain
version on the kernel side. Held here:

* the checks pass and return the JAX ``run_all``'s keys;
* each check's inputs are the JAX check's: the seeded draws (points, poses,
  mounts, appearances, masks, descriptors) bit for bit; pixels projected by
  each package's ``project_points`` within two float32 ulps at the image's
  widest coordinates (512-640 px), 1.22e-4 px (XLA's CPU product sums in
  another order than PyTorch's; seen: one such ulp), the visibility masks
  equal;
* the structural numbers equal the JAX checks' (interpret mode, one check at
  a time, the JAX bootstrap in float64 as the port's is): the map size, the
  pair matcher's valid count, the serving batch's map counts;
* each check can fail: with its kernel side's plain version perturbed (a
  pose nudged by 1e-2, an index off by one) it raises ``AssertionError``.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_odometry_tpu.ops import se3 as jse3
from visual_odometry_tpu.ops.camera import project_points as jproject
from visual_odometry_tpu.parallel import multiseq as jmulti
from visual_odometry_tpu.utils import selfcheck as jsc
from visual_odometry_tpu.utils import synthetic as jsyn
from visual_odometry_tpu.utils.config import VOConfig as JaxConfig
from visual_odometry_tpu_torch.ops.kernels import frame_kernel, matcher_kernel, picp_kernel
from visual_odometry_tpu_torch.parallel import multiseq as tmulti
from visual_odometry_tpu_torch.utils import selfcheck as tsc
from visual_odometry_tpu_torch.utils import synthetic as tsyn
from visual_odometry_tpu_torch.utils.config import VOConfig

from test_torch_pipeline import jax_bootstrap_in_double

# The keys of the JAX run_all (visual_odometry_tpu/utils/selfcheck.py:37-377).
JAX_KEYS = {
    "picp_pose_diff_fixed", "picp_pose_diff_early_exit", "picp_se2_pose_diff_fixed",
    "picp_se2_pose_diff_early_exit", "frame_traj_diff", "map_size", "frame_planar_traj_diff",
    "planar_subgroup_dev", "serving_traj_diff", "serving_vs_serial", "matcher_dist_diff",
    "matcher_fast_rescore_err", "matcher_fast_tie_picks", "pair_matcher_n_valid",
}
PIXEL_ATOL = 2 * float(np.spacing(np.float32(512.0)))


@pytest.fixture(scope="module")
def results():
    return tsc.run_all(device="cpu")


def test_run_all_passes_with_the_jax_keys(results):
    assert set(results) == JAX_KEYS
    assert all(np.isfinite(v) for v in results.values())
    # Every key is one the JAX module writes (the two-solve keys as f-strings).
    source = inspect.getsource(jsc)
    for key in JAX_KEYS:
        stem = key.removesuffix("_fixed").removesuffix("_early_exit")
        assert f'"{key}"' in source or f'f"{stem}_{{name}}"' in source, key
    assert [c.__name__ for c in tsc.CHECKS] == list(tsc.LAUNCHES)


def test_run_all_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsc.run_all()


def _jax_picp_inputs(rng, x_gt=None):
    world = jsyn.generate_points3d(rng, 192)
    if x_gt is None:
        x_gt = jsyn.generate_pose(rng)
    meas, valid = jproject(jsyn.default_camera(x_gt), jnp.asarray(world))
    return world, x_gt, np.asarray(meas), np.asarray(valid)


def _same_inputs(port, jax_side):
    """The seeded draws bit for bit; pixels within PIXEL_ATOL."""
    world, x_gt, meas, w = port
    j_world, j_x, j_meas, j_valid = jax_side
    np.testing.assert_array_equal(world.numpy(), j_world)
    np.testing.assert_array_equal(np.asarray(x_gt), np.asarray(j_x))
    np.testing.assert_array_equal(w.numpy() > 0, j_valid)
    np.testing.assert_allclose(meas.numpy(), j_meas, rtol=0, atol=PIXEL_ATOL)


def test_picp_inputs_are_the_jax_checks():
    _same_inputs(tsc.picp_inputs(np.random.default_rng(0)),
                 _jax_picp_inputs(np.random.default_rng(0)))
    mount, *port = tsc.se2_inputs(4)
    j_mount = np.array(jse3.v2t_euler(jnp.float32(tsc.SE2_MOUNT_V)))
    np.testing.assert_array_equal(mount, j_mount)
    j_x = np.array(np.linalg.inv(j_mount) @ np.array(jse3.v2t_se2(jnp.float32([0.15, -0.08, 0.1])))
                   @ j_mount)
    _same_inputs(port, _jax_picp_inputs(np.random.default_rng(4), j_x))


@pytest.mark.parametrize("seed,count", [(1, 1), (5, 1), (7, 4)])
def test_sequence_inputs_are_the_jax_checks(seed, count):
    port = tsc.sequence_inputs(seed, count)
    if count == 1:
        port = tuple(x[None] for x in port)
    for i in range(count):
        jp, ja, jm = jsyn.generate_tracking_sequence(np.random.default_rng(seed + i), 10, 64)
        np.testing.assert_array_equal(port[1][i].numpy(), ja)
        np.testing.assert_array_equal(port[2][i].numpy(), jm)
        np.testing.assert_allclose(port[0][i].numpy(), jp, rtol=0, atol=PIXEL_ATOL)
    j_mount = np.array(jse3.v2t_euler(jnp.float32(tsc.PLANAR_MOUNT_V)))
    np.testing.assert_array_equal(tsc._mount(tsc.PLANAR_MOUNT_V), j_mount)


def _jax_matcher_inputs(seed, fast):
    """The JAX checks' draws, as check_matcher(_fast) make them."""
    rng = np.random.default_rng(seed)
    k, q_n = (4096, 256) if fast else (2048, 256)
    db = rng.uniform(-1, 1, (k, 10)).astype(np.float32)
    q = db[rng.integers(0, k, q_n)].copy()
    if fast:
        q += rng.normal(0, 0.005, q.shape).astype(np.float32)
    else:
        q[::3] += 0.01
    db_mask = np.ones(k, bool)
    db_mask[::7 if fast else 5] = False
    return q, np.ones(q_n, bool), db, db_mask


def test_matcher_inputs_are_the_jax_checks():
    for got, want in ((tsc.matcher_inputs(2), _jax_matcher_inputs(2, False)),
                      (tsc.matcher_fast_inputs(6), _jax_matcher_inputs(6, True))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    a1 = rng.uniform(-1, 1, (6, 128, 10)).astype(np.float32)
    a2 = a1 + rng.normal(0, 0.02, (6, 128, 10)).astype(np.float32)
    m1 = rng.uniform(size=(6, 128)) > 0.2
    m2 = rng.uniform(size=(6, 128)) > 0.2
    for a, b in zip(tsc.pair_matcher_inputs(3), (a1, m1, a2, m2)):
        np.testing.assert_array_equal(a, b)


def test_structural_numbers_equal_the_jax_checks(results):
    with jax_bootstrap_in_double():
        assert results["map_size"] == jsc.check_frame_pipeline(interpret=True)["map_size"]
    assert (results["pair_matcher_n_valid"]
            == jsc.check_pair_matcher(interpret=True)["pair_matcher_n_valid"])


def test_serving_map_counts_equal_the_jax_checks():
    """check_frame_serving requires its batch-aware side's map counts to equal
    the loop form's; the loop form's equal the JAX check's vmap form's."""
    seqs = [jsyn.generate_tracking_sequence(np.random.default_rng(7 + i), 10, 64)
            for i in range(4)]
    cfg = dict(n_slots=64, map_capacity=256, gn_iterations=30)
    with jax_bootstrap_in_double():
        _, jmaps, _ = jmulti.run_sequences_batched(
            jsyn.deep_camera(), JaxConfig(**cfg),
            *(jnp.asarray(np.stack([s[k] for s in seqs])) for k in range(3)), backend="vmap")
    _, maps, _ = tmulti.run_sequences_batched(tsyn.deep_camera(), VOConfig(**cfg),
                                              *tsc.sequence_inputs(7, count=4), backend="torch")
    np.testing.assert_array_equal(maps.count.numpy(), np.asarray(jmaps.count))


def _nudge_pose(fn):
    """The first output (a pose or the poses) moved by 1e-2."""
    def perturbed(*args, **kwargs):
        pose, *rest = fn(*args, **kwargs)
        return (pose + 1e-2, *rest)
    return perturbed


def _shift_index(fn):
    """Every int32 output (the indices) off by one, inside its range."""
    def perturbed(*args, **kwargs):
        return tuple(torch.where(x > 0, x - 1, x + 1) if x.dtype == torch.int32 else x
                     for x in fn(*args, **kwargs))
    return perturbed


def _shift_candidates(fn):
    def perturbed(*args, **kwargs):
        cand = fn(*args, **kwargs)
        s = cand.idx.shape[-1]
        return cand._replace(idx=(cand.idx + 1) % s)
    return perturbed


@pytest.mark.parametrize("check,module,name,perturb", [
    ("check_picp_solver", picp_kernel, "_solve_plain", _nudge_pose),
    ("check_picp_se2_solver", picp_kernel, "_solve_plain", _nudge_pose),
    ("check_frame_pipeline", frame_kernel, "track_frames_plain", _nudge_pose),
    ("check_frame_pipeline", frame_kernel, "join_candidates_plain", _shift_candidates),
    ("check_frame_pipeline_planar", frame_kernel, "track_frames_plain", _nudge_pose),
    ("check_frame_serving", frame_kernel, "track_frames_batched_plain", _nudge_pose),
    ("check_matcher", matcher_kernel, "best_match_plain", _shift_index),
    ("check_matcher_fast", matcher_kernel, "best_match_plain", _shift_index),
    ("check_pair_matcher", matcher_kernel, "match_pairs_plain", _shift_index),
])
def test_each_check_fails_on_a_perturbed_kernel_side(monkeypatch, check, module, name, perturb):
    monkeypatch.setattr(module, name, perturb(getattr(module, name)))
    with pytest.raises(AssertionError):
        getattr(tsc, check)(device="cpu")
