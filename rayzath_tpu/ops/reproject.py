"""Spatio-temporal reprojection (reference Cuda::Camera::reproject,
cuda_camera.cuh:380-426 + spacialReprojection kernel,
cuda_postprocess_kernel.cu:5-16).

When the camera moves, progressive accumulation restarts — but the previous
frame's HDR accumulation is reused by projecting each new primary-hit point
into the PREVIOUS camera: if the point lands on-screen and its distance agrees
with the previous depth buffer within 1%, the previous pixel's accumulated
value (rgb sum AND alpha = sample count) is blended in with weight
``temporal_blend`` (reference default 0.75).

The reference runs this between the first render pass and the cumulative
passes; here it is a standalone jitted op the renderer applies right after a
camera change, seeding the fresh accumulation buffer.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import camera as cam_ops


@partial(jax.jit, static_argnames=("cfg",))
def primary_hits(scene, cam, cfg):
    """Depth + world-space hit points of pinhole center rays for every pixel.

    Returns (depth [H,W], space [H,W,3]). Used to seed reprojection after a
    camera move (the analog of the space buffer filled by renderFirstPass,
    cuda_render_kernel.cu:39-43).
    """
    from ..engine.integrator import closest_hit  # local import: avoids cycle

    H, W = cam.height, cam.width
    pix = cam_ops.pixel_grid(W, H)
    o, d = cam_ops.simple_ray(cam, pix)
    R = o.shape[0]
    near = jnp.full(R, cam.near_far[0])
    far = jnp.full(R, cam.near_far[1])
    t, tid, b1, b2, ext, _tp = closest_hit(scene, cfg, o, d, near, far)
    t = jnp.where(tid >= 0, t, far)
    space = o + d * t[:, None]
    return t.reshape(H, W), space.reshape(H, W, 3)


@jax.jit
def reproject_accum(space_buf, prev_cam, prev_accum, prev_depth, temporal_blend):
    """Blend the previous accumulation into a fresh one via reprojection.

    space_buf   [H,W,3]: primary-hit points under the NEW camera
    prev_cam:   DeviceCamera of the previous frame
    prev_accum  [H,W,4]: previous HDR accumulation (rgb sum + sample count)
    prev_depth  [H,W]:   previous primary depth buffer
    Returns the seeded accumulation [H,W,4].
    """
    H, W = prev_accum.shape[0], prev_accum.shape[1]
    p = space_buf.reshape(-1, 3)

    # transform to previous local camera space (transformBackward: columns of
    # rot are the camera axes, so local = (p - pos) @ rot)
    local = cam_ops.rotate_rows(p - prev_cam.position, prev_cam.rot.T)
    lz = local[:, 2]
    in_front = lz > 0.0

    # project on the previous screen (inverse of ops/camera.py simple_ray)
    aspect = jnp.float32(W) / jnp.float32(H)
    tana = jnp.tan(prev_cam.fov * 0.5)
    lz_safe = jnp.where(in_front, lz, 1.0)
    fx = ((local[:, 0] / lz_safe) / tana + 0.5) * W
    fy = ((local[:, 1] / lz_safe) / (-tana / aspect) + 0.5) * H
    on_screen = (fx >= 0.0) & (fx < W) & (fy >= 0.0) & (fy < H)
    ix = jnp.clip(fx.astype(jnp.int32), 0, W - 1)
    iy = jnp.clip(fy.astype(jnp.int32), 0, H - 1)

    # depth agreement within 1% (cuda_camera.cuh:414-419)
    point_dist = jnp.linalg.norm(p - prev_cam.position, axis=-1)
    buffer_dist = prev_depth[iy, ix]
    ok = (in_front & on_screen
          & (jnp.abs(point_dist - buffer_dist) < 0.01 * point_dist))

    prev = prev_accum[iy, ix]  # [R,4]
    seeded = jnp.where(ok[:, None], prev * temporal_blend, 0.0)
    return seeded.reshape(H, W, 4)
