"""Stackless BVH traversal: the per-ray skip-link walk and its entry points.

The reference walks a two-level BVH with one CUDA thread per ray and a
32-deep index stack (RayZath/cuda_bvh.cuh:114-232, cuda_instance.cuh:35-164).
Here every world is one flattened BVH over the world-space triangle soup, and
the walk (one ray per GPU lane, ops/traverse_gpu.py) is stackless:
``aabb_links`` holds, per ray-direction octant and node, the node box, its
near child (``first``, -1 for leaves) and its subtree skip link (host side,
ops/bvh.py ``compute_skip_links`` — the same direction-sign child ordering
the reference derives per step, cuda_bvh.cuh:149-158). Per step a ray either
descends (first) or skips.

:func:`closest` and :func:`shadow` are the traversal entry points of the
integrator. Hit decisions are discrete, so the closest-hit walk takes
``stop_gradient`` of its inputs and (t, b1, b2) are re-derived differentiably
by ops/intersect.refine_tri; the shadow walk's transmission gets a custom
VJP whose backward pass replays the dense, differentiable
``project_shadow`` over every triangle (path replay: the transmission
product is order-independent).
"""
from __future__ import annotations

from functools import partial

import jax
import numpy as np

from .bvh import build_bvh, compute_skip_links, triangle_aabbs
from .intersect import project_shadow, triangle_frames_jnp
from .traverse_gpu import gpu_closest, gpu_shadow


def bvh_tables(v0, e1, e2, leaf_size: int = 8, bucket=None):
    """Host-side BVH over triangles [F,3] (v0 + edges) in the walk's layout.

    Returns (order, aabb_links, node_begin, node_count): ``order`` [F]
    permutes the triangles into leaf order (the tables index the permuted
    arrays). An empty soup gets one empty leaf, so every walk ends at once.
    ``bucket(n) -> m >= n`` pads the node tables to ``m`` never-visited
    nodes, so small edits keep the device shapes (and the jit cache)."""
    if len(v0) == 0:
        order = np.zeros(0, np.int32)
        node_min = node_max = np.zeros((1, 3), np.float32)
        begin, count = np.zeros(1, np.int32), np.zeros(1, np.int32)
        first8, skip8 = np.zeros((8, 1), np.int32), np.ones((8, 1), np.int32)
        leaf = np.ones(1, np.int32)
    else:
        pmin, pmax = triangle_aabbs(v0, v0 + e1, v0 + e2)
        bvh = build_bvh(pmin, pmax, leaf_size=leaf_size)
        order, node_min, node_max = bvh.order, bvh.node_min, bvh.node_max
        begin, count = bvh.node_begin, bvh.node_count
        first8, skip8 = compute_skip_links(begin, count, bvh.node_axis)
        leaf = count
    n = len(begin)
    m = bucket(n) if bucket is not None else n
    if m > n:
        # the padded nodes are never reached: "finished" moves from n to m
        skip8 = np.where(skip8 == n, m, skip8)
        pad = m - n
        node_min = np.concatenate([node_min, np.zeros((pad, 3), np.float32)])
        node_max = np.concatenate([node_max, np.zeros((pad, 3), np.float32)])
        first8 = np.pad(first8, ((0, 0), (0, pad)))
        skip8 = np.pad(skip8, ((0, 0), (0, pad)), constant_values=m)
        begin, count, leaf = (np.pad(a, (0, pad)) for a in (begin, count,
                                                            leaf))
    links = build_aabb_links(node_min, node_max, leaf, first8, skip8)
    return order, links, begin, count


def build_aabb_links(node_min, node_max, node_count, first8, skip8):
    """Host-side [8, 8N] traversal table: per octant o and node n, column
    o*N + n holds (min xyz, max xyz, first, skip); first = -1 marks a leaf."""
    n = len(node_count)
    leaf = node_count > 0
    out = np.empty((8, 8 * n), np.float32)
    for o in range(8):
        s = slice(o * n, (o + 1) * n)
        out[0:3, s] = np.asarray(node_min, np.float32).T
        out[3:6, s] = np.asarray(node_max, np.float32).T
        out[6, s] = np.where(leaf, -1.0, first8[o].astype(np.float32))
        out[7, s] = skip8[o].astype(np.float32)
    return out


def _on_platform(kernel, *args):
    # lowered per platform: the compiled Triton kernel for CUDA, the same
    # kernel through the Pallas interpreter for the CPU (the tests, the
    # headless "CPU" engine); no other platform lowers
    return jax.lax.platform_dependent(
        *args, **{p: partial(kernel, interpret=p == "cpu")
                  for p in ("cpu", "cuda")})


def closest(origin, direction, near, far, aabb_links, node_begin, node_count,
            tri_v0, tri_e1, tri_e2):
    """Closest hit per ray in (near, far): (t [R], tri_id [R] i32, -1 = miss).
    Discrete: no gradient flows through it."""
    args = jax.lax.stop_gradient((origin, direction, near, far, aabb_links,
                                  node_begin, node_count, tri_v0, tri_e1,
                                  tri_e2))
    return _on_platform(gpu_closest, *args)


@jax.custom_vjp
def shadow(origin, direction, dist, aabb_links, node_begin, node_count,
           tri_v0, tri_e1, tri_e2, op_rgb, op_a):
    """Transmission-filtered visibility (reference anyIntersection,
    cuda_bvh.cuh:172-232): the product of per-triangle opacity colours over
    every hit in (0, dist). Returns (rgb [R,3], a [R]); a ray stops once
    alpha < 1e-4 (reference early-out, cuda_instance.cuh:110)."""
    return _on_platform(gpu_shadow, origin, direction, dist, aabb_links,
                        node_begin, node_count, tri_v0, tri_e1, tri_e2,
                        op_rgb, op_a)


def _shadow_fwd(origin, direction, dist, aabb_links, node_begin, node_count,
                tri_v0, tri_e1, tri_e2, op_rgb, op_a):
    out = shadow(origin, direction, dist, aabb_links, node_begin, node_count,
                 tri_v0, tri_e1, tri_e2, op_rgb, op_a)
    return out, (origin, direction, dist, tri_v0, tri_e1, tri_e2, op_rgb, op_a)


def _shadow_bwd(res, g):
    # dense replay: where the alpha early-out has not saturated the product,
    # this is the exact gradient; beyond it the light term is ~0 anyway
    def replay(origin, direction, dist, tri_v0, tri_e1, tri_e2, op_rgb, op_a):
        pw, pc = triangle_frames_jnp(tri_v0, tri_e1, tri_e2)
        return project_shadow(origin, direction, dist, pw, pc, op_rgb, op_a,
                              chunk=min(512, tri_v0.shape[0]))

    _, vjp = jax.vjp(replay, *res)
    d_o, d_d, d_dist, d_v0, d_e1, d_e2, d_rgb, d_a = vjp(g)
    return (d_o, d_d, d_dist, None, None, None, d_v0, d_e1, d_e2, d_rgb, d_a)


shadow.defvjp(_shadow_fwd, _shadow_bwd)
