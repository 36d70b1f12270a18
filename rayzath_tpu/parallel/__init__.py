"""Multi-chip scaling: device meshes, ray sharding, distributed train steps.

The reference is single-node single-GPU (cudaSetDevice(0),
RayZath/cuda_engine_core.cu:17); its only parallelism is one CUDA thread per
pixel. The scaling axis (SURVEY.md §2.7) is the ray/pixel dimension:
shard the wavefront across a 1-D device mesh, replicate the scene
(BVH + triangles + materials + atlases fit device memory), and reduce only
sample counters / gradients with psum.
"""
from .mesh import (make_mesh, RAYS_AXIS, shard_state, replicate_scene,
                   sharded_render_steps)
from .train import training_step, image_loss
from .scaling import measure_scaling, format_report

__all__ = [
    "make_mesh", "RAYS_AXIS", "shard_state", "replicate_scene",
    "sharded_render_steps", "training_step", "image_loss",
    "measure_scaling", "format_report",
]
