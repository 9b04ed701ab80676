"""Entry driver: one sequence a call through the program's sequence-parallel
path, ``parallel.posegraph.run_sequence_chunked``, called as
``apps.run_vo_complete`` calls it when ``num_chunks`` > 1: the bootstrap
scores (K1 over every consecutive pair, a batched homography fit, a host
read), the chunk plan, the chunks' bootstraps in one P1, K1-K3 over the
flattened chunks, one K8 launch (a cluster of 4 CTAs a chunk at 1,024
slots), the stitch, one map fold and the overflow check.

The call returns no chunk starts, so the entry reads the plan the call made
off ``posegraph.plan_chunks``, which it wraps to record what it returns.
"""

from __future__ import annotations

import torch

from visual_odometry_tpu_torch.parallel import posegraph

from vobench import program, workmodels


class Entry:
    def __init__(self, pool: dict, config: dict, traffic: dict, device):
        if traffic["sequences_per_call"] != 1:
            raise ValueError("run_sequence_chunked tracks one sequence a call")
        self.pool = pool
        self.vo = program.vo_config(config)
        self.camera = program.camera(config, device)
        self.calls = pool["points"].shape[0]
        self.frames_per_call = pool["points"].shape[1]
        self.plans = []
        plan = getattr(posegraph.plan_chunks, "__wrapped__", posegraph.plan_chunks)

        def recorded(*args, **kw):
            out = plan(*args, **kw)
            self.plans.append(out)
            return out

        recorded.__wrapped__ = plan
        posegraph.plan_chunks = recorded

    def sequences(self, k: int) -> range:
        return range(k, k + 1)

    def __call__(self, k: int):
        p = self.pool
        self.plans.clear()
        trajectory, landmark_map, diags = posegraph.run_sequence_chunked(
            self.camera, self.vo, p["points"][k], p["appearances"][k], p["masks"][k],
            num_chunks=self.vo.num_chunks, overlap=self.vo.chunk_overlap)
        return trajectory, landmark_map, diags, self.plans[-1][0]

    def collect(self, raw) -> dict:
        trajectory, landmark_map, diags, starts = raw
        return {
            "trajectory": trajectory[None],
            "map_points": landmark_map.points[None],
            "map_apps": landmark_map.appearances[None],
            "map_valid": landmark_map.valid[None],
            "map_count": landmark_map.count.reshape(1),
            "scales": diags.scales[None],
            "num_ratio_obs": diags.num_ratio_obs[None],
            "starts": torch.tensor(starts)[None],
        }

    def frame_loop_work(self, rounds) -> workmodels.Work:
        """K8's work in a call whose chunks' GN rounds a tracked frame are
        ``rounds`` (a list of one (C, L - 2) tensor, the reference's)."""
        (r,) = rounds
        return workmodels.serving_model(r.shape[0], r.shape[1], self.vo.n_slots,
                                        self.vo.fused_join_depth, float(r.double().mean()),
                                        self.vo.planar)
