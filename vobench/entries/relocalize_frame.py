"""Entry driver: one query frame a call through the program's map-scale
relocalization, ``models.pipeline.relocalize_frame``, as
``apps.run_relocalize`` calls it: the frame's descriptors matched against
every row of the prior map (K7), the strict radius and the gather of the
matched map points, then the pose solve from the frame's prior (K6).

The set-up builds the program's ``LandmarkMap`` from the pool's map once;
every call reads it and changes nothing."""

from __future__ import annotations

import torch

from visual_odometry_tpu_torch.models import pipeline
from visual_odometry_tpu_torch.models.landmark_map import LandmarkMap

from vobench import program, workmodels


class Entry:
    def __init__(self, pool: dict, config: dict, traffic: dict, device):
        if traffic["sequences_per_call"] != 1 or pool["points"].shape[1] != 1:
            raise ValueError("relocalize_frame takes one query frame a call")
        self.vo = program.vo_config(config)
        self.camera = program.camera(config, device)
        valid = pool["map_valid"]
        if valid.shape[0] != self.vo.map_capacity:
            raise ValueError(f"a map of {valid.shape[0]} rows under map_capacity "
                             f"{self.vo.map_capacity}")
        self.map = LandmarkMap(points=pool["map_points"].clone(),
                               appearances=pool["map_appearances"].clone(),
                               valid=valid.clone(), count=valid.sum().to(torch.int32))
        s = pool["masks"].shape[-1]
        no_ids = torch.full((s,), -1, dtype=torch.int32, device=valid.device)
        self.frames = [pipeline.FrameData(p[0], a[0], m[0], no_ids) for p, a, m in
                       zip(pool["points"], pool["appearances"], pool["masks"])]
        self.priors = pool["priors"]
        self.calls = len(self.frames)
        self.frames_per_call = 1

    def sequences(self, k: int) -> range:
        return range(k, k + 1)

    def __call__(self, k: int):
        return pipeline.relocalize_frame(self.camera, self.vo, self.map, self.frames[k],
                                         self.priors[k])

    def collect(self, raw) -> dict:
        pose, stats, matches = raw
        return {"pose": pose[None], "num_matches": matches.reshape(1),
                "num_inliers": stats.num_inliers.reshape(1),
                "chi_inliers": stats.chi_inliers.reshape(1)}

    def map_match_work(self) -> workmodels.Work:
        """K7's work in a call: the frame's slots against every map row."""
        q, d = self.frames[0].appearances.shape
        return workmodels.matcher_model(q, self.map.valid.shape[0], d)
