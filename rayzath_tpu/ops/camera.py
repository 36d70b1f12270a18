"""Camera ray generation (vectorized, differentiable).

Mirrors reference ``Cuda::Camera::generateRay`` (cuda_camera.cuh:335-379):
pinhole direction from pixel center, anti-aliasing jitter (both axes use
0.5/width — a reference quirk kept for parity), thin-lens aperture sampling
toward the focal point, then camera rotation + translation. ``simple_ray``
mirrors ``generateSimpleRay`` (no jitter/aperture; used for picking).
"""
from __future__ import annotations

import jax.numpy as jnp

from .vec import normalize, TWO_PI


def rotate_rows(v, rot):
    """``v @ rot.T`` for [R,3] rows, as elementwise f32 multiply-adds: no
    matmul, so no TF32 (which would move rays by ~1e-3 relative and flip
    hits at triangle edges) and the same result for any batch shape."""
    return v[:, 0:1] * rot[:, 0] + v[:, 1:2] * rot[:, 1] + v[:, 2:3] * rot[:, 2]


def pixel_grid(width: int, height: int, row0=0):
    """Flat pixel coordinates [R,2] (x, y) in row-major order, R = W*height.

    ``row0`` offsets the y coordinates: a row-sharded wavefront (one shard =
    ``height`` consecutive image rows starting at global row ``row0``)
    generates exactly the rays the full-image grid would."""
    y, x = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32) + row0,
                        jnp.arange(width, dtype=jnp.float32), indexing="ij")
    return jnp.stack([x.ravel(), y.ravel()], axis=1)


def generate_rays(cam, pixels, u):
    """Thin-lens camera rays.

    cam: DeviceCamera; pixels [R,2] float; u [R,4] uniforms
    (jitter_x, jitter_y, aperture_angle, aperture_radius).
    Returns (origin [R,3], direction [R,3]).
    """
    w = jnp.float32(cam.width)
    h = jnp.float32(cam.height)
    aspect = w / h
    tana = jnp.tan(cam.fov * 0.5)
    dx = ((pixels[:, 0] + 0.5) / w - 0.5) * tana
    dy = ((pixels[:, 1] + 0.5) / h - 0.5) * (-tana / aspect)
    # AA jitter: both axes scaled by 0.5/width (reference cuda_camera.cuh:351-355)
    dx = dx + (0.5 / w) * (u[:, 0] * 2.0 - 1.0)
    dy = dy + (0.5 / w) * (u[:, 1] * 2.0 - 1.0)
    direction = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=1)

    focal_point = direction * cam.focal_distance
    ap_angle = u[:, 2] * TWO_PI
    ap_radius = jnp.sqrt(u[:, 3]) * cam.aperture
    origin = jnp.stack([ap_radius * jnp.sin(ap_angle),
                        ap_radius * jnp.cos(ap_angle),
                        jnp.zeros_like(ap_angle)], axis=1)
    direction = focal_point - origin

    origin = rotate_rows(origin, cam.rot) + cam.position
    direction = normalize(rotate_rows(direction, cam.rot))
    return origin, direction


def simple_ray(cam, pixels):
    """Pinhole ray through pixel center (reference generateSimpleRay,
    cuda_camera.cuh:305-328)."""
    w = jnp.float32(cam.width)
    h = jnp.float32(cam.height)
    aspect = w / h
    tana = jnp.tan(cam.fov * 0.5)
    dx = ((pixels[:, 0] + 0.5) / w - 0.5) * tana
    dy = ((pixels[:, 1] + 0.5) / h - 0.5) * (-tana / aspect)
    direction = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=1)
    origin = jnp.broadcast_to(cam.position, direction.shape)
    direction = normalize(rotate_rows(direction, cam.rot))
    return origin, direction


def sky_texcrd(direction):
    """Sky-sphere texture coordinates from a direction
    (reference World::calculateTexcrd, cuda_world.cuh:121-126)."""
    u = -(0.5 + jnp.arctan2(direction[:, 2], direction[:, 0]) / TWO_PI)
    v = 0.5 + jnp.arcsin(jnp.clip(direction[:, 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=1)
