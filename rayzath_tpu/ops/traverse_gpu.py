"""Per-ray stackless BVH walk as Pallas kernels for the GPU (Triton route).

The reference renderer walks its BVH with one CUDA thread per ray
(RayZath/cuda_bvh.cuh:114-232). These kernels do the same: one ray per lane,
a block of ``BLOCK`` rays per program, and each lane keeps its whole walk
state (current node, best t and id, or the shadow transmission) in registers.
A block only waits for its own slowest ray.

Per step a lane gathers its node's row of the per-octant table
(``aabb_links`` of ops/traverse.py, transposed to one 8-float row per
(octant, node)): the node box, the near child (``first``, -1 for a leaf) and
the subtree skip link. Lanes at a leaf whose box they hit loop over the leaf's
triangles with gathered loads and run Moller-Trumbore in f32 on the CUDA
cores. There is no matmul, no shared-memory table and no sort inside.

``interpret`` runs the same kernels through the Pallas interpreter; the
traversal entry points pass it only when the platform is the CPU.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .intersect import DET_EPS, BIG

BLOCK = 128   # rays per program (one ray per lane, 4 warps)
_LINK_W = 8   # floats per (octant, node) row: min xyz, max xyz, first, skip
_TRI_W = 9    # floats per triangle: v0, e1, e2
_SHADOW_W = 13  # v0, e1, e2, opacity rgb, opacity alpha


def _inv(d):
    return 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                           jnp.where(d < 0, -1e-12, 1e-12), d)


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _gather(ref, idx, mask):
    return plgpu.load(ref.at[jnp.where(mask, idx, 0)], mask=mask, other=0)


def _ray_setup(dx, dy, dz, n_nodes):
    octant = ((dx < 0).astype(jnp.int32)
              | ((dy < 0).astype(jnp.int32) << 1)
              | ((dz < 0).astype(jnp.int32) << 2))
    return _inv(dx), _inv(dy), _inv(dz), octant * n_nodes


def _node_step(links_ref, row0, node, active, o, inv):
    """Gather the lanes' node rows; returns (tmin, tmax, first, skip)."""
    ox, oy, oz = o
    ix, iy, iz = inv
    row = (row0 + node) * _LINK_W

    def f(k):
        return _gather(links_ref, row + k, active)

    tx1, tx2 = (f(0) - ox) * ix, (f(3) - ox) * ix
    ty1, ty2 = (f(1) - oy) * iy, (f(4) - oy) * iy
    tz1, tz2 = (f(2) - oz) * iz, (f(5) - oz) * iz
    tmin = jnp.maximum(jnp.maximum(jnp.minimum(tx1, tx2), jnp.minimum(ty1, ty2)),
                       jnp.minimum(tz1, tz2))
    tmax = jnp.minimum(jnp.minimum(jnp.maximum(tx1, tx2), jnp.maximum(ty1, ty2)),
                       jnp.maximum(tz1, tz2))
    return tmin, tmax, f(6), f(7)


def _moller_trumbore(tri_ref, base, m, o, d):
    """Reference numerics (cuda_render_parts.cuh:1023-1083) for one triangle
    per lane; returns (t, inside)."""
    ox, oy, oz = o
    dx, dy, dz = d

    def g(k):
        return _gather(tri_ref, base + k, m)

    v0x, v0y, v0z = g(0), g(1), g(2)
    e1x, e1y, e1z = g(3), g(4), g(5)
    e2x, e2y, e2z = g(6), g(7), g(8)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det = det + jnp.where(jnp.abs(det) < DET_EPS, DET_EPS, 0.0)
    inv_det = 1.0 / det
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    b1 = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    b2 = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    inside = (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    return t, inside


def _leaf_loop(begin_ref, count_ref, node, do_leaf, body, carry):
    """Run ``body(k, tri, m, carry)`` over the leaf triangles of every lane
    in ``do_leaf``; skipped entirely when no lane of the block is at a leaf."""
    def run(carry):
        begin = _gather(begin_ref, node, do_leaf)
        count = jnp.where(do_leaf, _gather(count_ref, node, do_leaf), 0)

        def step(k, carry):
            m = k < count
            return body(jnp.where(m, begin + k, 0), m, carry)

        return jax.lax.fori_loop(0, jnp.max(count), step, carry)

    return jax.lax.cond(_any(do_leaf), run, lambda c: c, carry)


def _closest_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                    near_ref, far_ref, links_ref, begin_ref, count_ref, tri_ref,
                    t_ref, id_ref, *, n_nodes: int):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    near, far = near_ref[...], far_ref[...]
    ix, iy, iz, row0 = _ray_setup(*d, n_nodes)

    def cond(c):
        return _any(c[0] < n_nodes)

    def walk(c):
        node, best_t, best_id = c
        active = node < n_nodes
        nid = jnp.where(active, node, 0)
        tmin, tmax, first, skip = _node_step(links_ref, row0, nid, active, o,
                                             (ix, iy, iz))
        hit_box = (active & (tmax >= near) & (tmin <= tmax)
                   & (tmin <= jnp.minimum(far, best_t)))
        is_leaf = first < 0.0

        def tri_body(tri, m, c):
            bt, bi = c
            t, inside = _moller_trumbore(tri_ref, tri * _TRI_W, m, o, d)
            better = m & inside & (t > near) & (t < bt)
            return jnp.where(better, t, bt), jnp.where(better, tri, bi)

        best_t, best_id = _leaf_loop(begin_ref, count_ref, nid,
                                     hit_box & is_leaf, tri_body,
                                     (best_t, best_id))
        nxt = jnp.where(hit_box & ~is_leaf, first, skip).astype(jnp.int32)
        return jnp.where(active, nxt, node), best_t, best_id

    start = jnp.zeros(near.shape, jnp.int32)
    _, t, tid = jax.lax.while_loop(
        cond, walk, (start, jnp.minimum(far, BIG),
                     jnp.full(near.shape, -1, jnp.int32)))
    t_ref[...] = t
    id_ref[...] = tid


def _shadow_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, dist_ref,
                   links_ref, begin_ref, count_ref, tri_ref,
                   r_ref, g_ref, b_ref, a_ref, *, n_nodes: int):
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    dist = dist_ref[...]
    ix, iy, iz, row0 = _ray_setup(*d, n_nodes)

    def cond(c):
        return _any(c[0] < n_nodes)

    def walk(c):
        node, mask = c
        active = node < n_nodes
        nid = jnp.where(active, node, 0)
        tmin, tmax, first, skip = _node_step(links_ref, row0, nid, active, o,
                                             (ix, iy, iz))
        hit_box = active & (tmax >= 0.0) & (tmin <= tmax) & (tmin <= dist)
        is_leaf = first < 0.0

        def tri_body(tri, m, mask):
            base = tri * _SHADOW_W
            t, inside = _moller_trumbore(tri_ref, base, m, o, d)
            hit = m & inside & (t > 0.0) & (t < dist)
            return tuple(jnp.where(hit, c * _gather(tri_ref, base + 9 + k, hit),
                                   c)
                         for k, c in enumerate(mask))

        mask = _leaf_loop(begin_ref, count_ref, nid, hit_box & is_leaf,
                          tri_body, mask)
        nxt = jnp.where(hit_box & ~is_leaf, first, skip).astype(jnp.int32)
        # reference early-out once the ray is (nearly) opaque,
        # cuda_instance.cuh:110
        nxt = jnp.where(mask[3] < 1e-4, n_nodes, nxt)
        return jnp.where(active, nxt, node), mask

    ones = jnp.ones(dist.shape, jnp.float32)
    _, (mr, mg, mb, ma) = jax.lax.while_loop(
        cond, walk, (jnp.zeros(dist.shape, jnp.int32), (ones, ones, ones, ones)))
    r_ref[...] = mr
    g_ref[...] = mg
    b_ref[...] = mb
    a_ref[...] = ma


def _launch(kernel, name, origin, direction, ray_cols, aabb_links,
            node_begin, node_count, tri, out_dtypes, interpret):
    """One program per ``BLOCK`` rays (the last block padded); the tables
    are whole-array refs the lanes gather from. The node table is
    ``aabb_links`` transposed: one 8-float row per (octant, node)."""
    cols = ([origin[:, k] for k in range(3)]
            + [direction[:, k] for k in range(3)] + list(ray_cols))
    r = origin.shape[0]
    rp = -(-r // BLOCK) * BLOCK
    cols = [jnp.pad(c, (0, rp - r)) for c in cols]
    tables = [aabb_links.T.reshape(-1), node_begin, node_count, tri]
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(t.shape, lambda i: (0,)) for t in tables]
    outs = pl.pallas_call(
        partial(kernel, n_nodes=node_begin.shape[0]),
        grid=(rp // BLOCK,),
        in_specs=[lane] * len(cols) + whole,
        out_specs=[lane] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in out_dtypes],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK // 32,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*cols, *tables)
    return [x[:r] for x in outs]


@partial(jax.jit, static_argnames=("interpret",))
def gpu_closest(origin, direction, near, far, aabb_links, node_begin,
                node_count, tri_v0, tri_e1, tri_e2, interpret: bool = False):
    """Closest hit per ray: (t [R], tri_id [R] i32, -1 = miss)."""
    tri = jnp.concatenate([tri_v0, tri_e1, tri_e2], axis=1).reshape(-1)
    t, tid = _launch(_closest_kernel, "bvh_closest", origin, direction,
                     (near, far), aabb_links, node_begin, node_count, tri,
                     (jnp.float32, jnp.int32), interpret)
    return t, tid


@partial(jax.jit, static_argnames=("interpret",))
def gpu_shadow(origin, direction, dist, aabb_links, node_begin, node_count,
               tri_v0, tri_e1, tri_e2, op_rgb, op_a, interpret: bool = False):
    """Transmission through every hit in (0, dist): (rgb [R,3], a [R])."""
    tri = jnp.concatenate([tri_v0, tri_e1, tri_e2, op_rgb, op_a[:, None]],
                          axis=1).reshape(-1)
    mr, mg, mb, ma = _launch(_shadow_kernel, "bvh_shadow", origin, direction,
                             (dist,), aabb_links, node_begin, node_count, tri,
                             (jnp.float32,) * 4, interpret)
    return jnp.stack([mr, mg, mb], axis=1), ma
