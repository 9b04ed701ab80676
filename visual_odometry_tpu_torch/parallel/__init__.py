"""Batched serving and global refinement (port of visual_odometry_tpu.parallel)."""
