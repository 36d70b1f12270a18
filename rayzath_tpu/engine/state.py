"""Progressive render state (the explicit, checkpointable analog of the
reference's FrameBuffers + TracingStates, cuda_camera.cuh:32-110).

The state IS the checkpoint: accumulation image (rgb sum + alpha = sample
count), depth/space buffers, per-ray persistent path state (origin, direction,
throughput, medium material id, path depth, near/far), and the pass counter
that seeds the counter-based RNG. ``save``/``load`` round-trip it through .npz.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils import pytree as struct

BIG = 3.402823466e38
PATH_LIMIT = 255  # reference TracingState::sm_path_limit (cuda_camera.cuh:18)
WORLD_MATERIAL_ID = 0


@struct.dataclass
class RenderState:
    accum: jnp.ndarray       # [H,W,4] rgb sum + alpha = terminated-sample count
    depth_buf: jnp.ndarray   # [H,W]
    space_buf: jnp.ndarray   # [H,W,3] first-hit points (reprojection)
    origin: jnp.ndarray      # [R,3]
    direction: jnp.ndarray   # [R,3]
    throughput: jnp.ndarray  # [R,3]
    medium: jnp.ndarray      # [R] i32 material id of the medium the ray travels in
    path_depth: jnp.ndarray  # [R] i32
    near: jnp.ndarray        # [R]
    far: jnp.ndarray         # [R]
    #: cumulative log-likelihood of the path's discrete free-flight events
    #: (score-function estimator for d/d scattering; 0 when no scattering
    #: medium was traversed — see integrator.bounce_step)
    score: jnp.ndarray = None  # [R]
    pass_idx: jnp.ndarray = None  # scalar i32 (RNG counter / pass index)
    width: int = struct.field(pytree_node=False, default=0)
    height: int = struct.field(pytree_node=False, default=0)


def init_state(width: int, height: int) -> RenderState:
    """Fresh state: paths are 'terminated' so the first bounce regenerates
    camera rays for every pixel (regeneration-in-place, reference
    cuda_render_kernel.cu:50-65)."""
    r = width * height
    return RenderState(
        accum=jnp.zeros((height, width, 4), jnp.float32),
        depth_buf=jnp.zeros((height, width), jnp.float32),
        space_buf=jnp.zeros((height, width, 3), jnp.float32),
        origin=jnp.zeros((r, 3), jnp.float32),
        direction=jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (r, 1)),
        throughput=jnp.ones((r, 3), jnp.float32),
        medium=jnp.full(r, WORLD_MATERIAL_ID, jnp.int32),
        path_depth=jnp.full(r, PATH_LIMIT, jnp.int32),
        near=jnp.zeros(r, jnp.float32),
        far=jnp.full(r, BIG, jnp.float32),
        score=jnp.zeros(r, jnp.float32),
        pass_idx=jnp.int32(0),
        width=width,
        height=height,
    )


def save_state(path: str, state: RenderState) -> None:
    np.savez_compressed(
        path,
        **{f: np.asarray(getattr(state, f)) for f in (
            "accum", "depth_buf", "space_buf", "origin", "direction",
            "throughput", "medium", "path_depth", "near", "far", "score",
            "pass_idx")},
        width=state.width, height=state.height,
    )


def load_state(path: str) -> RenderState:
    z = np.load(path)
    return RenderState(
        accum=jnp.asarray(z["accum"]), depth_buf=jnp.asarray(z["depth_buf"]),
        space_buf=jnp.asarray(z["space_buf"]), origin=jnp.asarray(z["origin"]),
        direction=jnp.asarray(z["direction"]), throughput=jnp.asarray(z["throughput"]),
        medium=jnp.asarray(z["medium"]), path_depth=jnp.asarray(z["path_depth"]),
        near=jnp.asarray(z["near"]), far=jnp.asarray(z["far"]),
        score=(jnp.asarray(z["score"]) if "score" in z
               else jnp.zeros_like(jnp.asarray(z["near"]))),
        pass_idx=jnp.asarray(z["pass_idx"]),
        width=int(z["width"]), height=int(z["height"]),
    )
