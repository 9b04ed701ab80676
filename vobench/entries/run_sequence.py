"""Entry driver: one sequence a call through the program's main path,
``models.pipeline.run_sequence`` (what ``apps.run_vo_complete`` runs for one
chunk): the bootstrap (K1, P1), the batched match (K1), the join chains
(K2), the lane gathers (K3), the fused frame loop (K4) and the map fold."""

from __future__ import annotations

from visual_odometry_tpu_torch.models import pipeline

from vobench import program, workmodels


class Entry:
    def __init__(self, pool: dict, config: dict, traffic: dict, device):
        if traffic["sequences_per_call"] != 1:
            raise ValueError("run_sequence tracks one sequence a call")
        self.pool = pool
        self.vo = program.vo_config(config)
        self.camera = program.camera(config, device)
        self.calls = pool["points"].shape[0]
        self.frames_per_call = pool["points"].shape[1]

    def sequences(self, k: int) -> range:
        return range(k, k + 1)

    def __call__(self, k: int):
        p = self.pool
        return pipeline.run_sequence(self.camera, self.vo, p["points"][k], p["appearances"][k],
                                     p["masks"][k])

    def collect(self, raw) -> dict:
        return program.collect(*program.add_sequence_axis(raw))

    def frame_loop_work(self, rounds) -> workmodels.Work:
        """K4's work in a call whose GN rounds a tracked frame are ``rounds`` (1, F - 2)."""
        return workmodels.frame_model(rounds.shape[1], self.vo.n_slots, self.vo.fused_join_depth,
                                      float(rounds.double().mean()), self.vo.planar)
