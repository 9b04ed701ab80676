"""Entry driver: a batch of sequences a call through the program's serving
entry, ``parallel.multiseq.run_sequences_batched``: one pair match and one
bootstrap launch (K1, P1) for the batch, K1-K3 over the flattened batch, one
K8 launch for every sequence's frame loop and one map fold for the batch."""

from __future__ import annotations

from visual_odometry_tpu_torch.parallel import multiseq

from vobench import program, workmodels


class Entry:
    def __init__(self, pool: dict, config: dict, traffic: dict, device):
        self.pool = pool
        self.batch = int(traffic["sequences_per_call"])
        self.vo = program.vo_config(config)
        self.camera = program.camera(config, device)
        sequences = pool["points"].shape[0]
        if sequences % self.batch:
            raise ValueError(f"a pool of {sequences} sequences is no whole number of batches "
                             f"of {self.batch}")
        self.calls = sequences // self.batch
        self.frames_per_call = self.batch * pool["points"].shape[1]

    def sequences(self, k: int) -> range:
        return range(k * self.batch, (k + 1) * self.batch)

    def __call__(self, k: int):
        return multiseq.run_sequences_batched(self.camera, self.vo,
                                              *program.block(self.pool, k * self.batch,
                                                             self.batch))

    def collect(self, raw) -> dict:
        return program.collect(*raw)

    def frame_loop_work(self, rounds) -> workmodels.Work:
        """K8's work in a call whose GN rounds a tracked frame are ``rounds`` (B, F - 2)."""
        return workmodels.serving_model(rounds.shape[0], rounds.shape[1], self.vo.n_slots,
                                        self.vo.fused_join_depth, float(rounds.double().mean()),
                                        self.vo.planar)
