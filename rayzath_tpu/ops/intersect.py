"""Batched ray/triangle intersection (Moller-Trumbore).

Numerical semantics follow the reference device intersector
(RayZath/cuda_render_parts.cuh:1023-1083): the determinant is nudged by +1e-7
when |det| < 1e-7, hits require b1 in [0,1], b2 >= 0, b1+b2 <= 1 and
t in (near, far); ``external`` (front-face) is det > 0.

Two strategies are provided (the renderer picks statically by scene size):

* ``brute_force_closest`` / ``brute_force_shadow`` — all-pairs rays x triangle
  tiles via ``lax.scan``. Fully vectorized work with zero divergence; the
  test oracle, and the path for scenes under ``brute_force_threshold``.
* the per-ray BVH walk lives in ops/traverse.py.

``refine_hit`` recomputes (t, b1, b2) differentiably from a resolved triangle id,
which is what path-replay backprop differentiates through (the discrete hit
decision itself is treated as constant, as in standard path-replay).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .vec import dot, cross

DET_EPS = 1e-7
BIG = 3.402823466e38


# ---------------------------------------------------------------------------
# unit-triangle projection method (the matmul intersector)
# ---------------------------------------------------------------------------
#
# Per triangle, precompute M = inv([e1 e2 n]) (n = e1 x e2) and c = -M v0.
# A world point p maps to local coords M p + c where (x, y) are the
# barycentrics (b1, b2) and z vanishes on the triangle plane. For a ray:
#     o' = M o + c,   d' = M d
#     t  = -o'_z / d'_z,   b1 = o'_x + t d'_x,   b2 = o'_y + t d'_y
# so ALL per-(ray, triangle) quantities come from two matmuls
# [R,3] @ [3, 3F] plus fused elementwise work on [R,F] tiles.
# This replaces the cross-product Moller-Trumbore broadcast (which
# materializes [R,F,3] intermediates); hit (t, b1, b2) are
# re-derived differentiably afterwards by ``refine_hit``, which keeps the
# reference's exact MT numerics (cuda_render_parts.cuh:1023-1083) on the
# gathered winning triangle.


def triangle_frames(v0: "np.ndarray", e1, e2):
    """Host-side precompute of projection frames.

    Returns (w [3, 3F], c [3F]) float32, laid out as the x-rows block, then
    y-rows, then z-rows, so ``o @ w + c`` yields [R, 3F] = [ox | oy | oz].
    Degenerate (padded) triangles get w = 0, c = (-1, -1, 1): b1 = -1 keeps
    them invalid for every ray without producing NaNs.
    """
    import numpy as np
    f = len(v0)
    if f == 0:
        return np.zeros((3, 0), np.float32), np.zeros(0, np.float32)
    n = np.cross(e1, e2)
    b = np.stack([e1, e2, n], axis=-1)              # [F,3,3] columns
    det = np.linalg.det(b)
    ok = np.abs(det) > 1e-30
    b_safe = np.where(ok[:, None, None], b, np.eye(3, dtype=b.dtype))
    m = np.linalg.inv(b_safe)                       # rows: b1, b2, z
    c = -np.einsum("fij,fj->fi", m, v0)
    m = np.where(ok[:, None, None], m, 0.0)
    c = np.where(ok[:, None], c, np.array([-1.0, -1.0, 1.0]))
    w = np.concatenate([m[:, 0, :], m[:, 1, :], m[:, 2, :]], axis=0).T  # [3,3F]
    cc = np.concatenate([c[:, 0], c[:, 1], c[:, 2]], axis=0)            # [3F]
    return w.astype(np.float32), cc.astype(np.float32)


def triangle_frames_jnp(v0, e1, e2):
    """Traceable (differentiable) twin of :func:`triangle_frames`, used by
    the shadow traversal's replay backward pass."""
    n = jnp.cross(e1, e2)
    b = jnp.stack([e1, e2, n], axis=-1)                 # [F,3,3] columns
    det = jnp.linalg.det(b)
    ok = jnp.abs(det) > 1e-30
    b_safe = jnp.where(ok[:, None, None], b, jnp.eye(3, dtype=b.dtype))
    m = jnp.linalg.inv(b_safe)                          # rows: b1, b2, z
    c = -jnp.einsum("fij,fj->fi", m, v0,
                    precision=jax.lax.Precision.HIGHEST)
    m = jnp.where(ok[:, None, None], m, 0.0)
    c = jnp.where(ok[:, None], c, jnp.asarray([-1.0, -1.0, 1.0]))
    w = jnp.concatenate([m[:, 0, :], m[:, 1, :], m[:, 2, :]], axis=0).T
    cc = jnp.concatenate([c[:, 0], c[:, 1], c[:, 2]], axis=0)
    return w, cc


def _project_terms(origin, direction, w, c):
    """Matmul projection of rays onto triangle frames.

    origin/direction [R,3]; w [3, 3F]; c [3F]. Returns (t, b1, b2, dz)
    each [R, F].
    """
    f = w.shape[1] // 3
    # HIGHEST keeps the products in f32 (bf16 or TF32 inputs shatter ray
    # geometry into speckle)
    hi = jax.lax.Precision.HIGHEST
    ol = jnp.matmul(origin, w, precision=hi) + c    # [R, 3F]
    dl = jnp.matmul(direction, w, precision=hi)     # [R, 3F]
    ox, oy, oz = ol[:, :f], ol[:, f:2 * f], ol[:, 2 * f:]
    dx, dy, dz = dl[:, :f], dl[:, f:2 * f], dl[:, 2 * f:]
    dz = dz + jnp.where(jnp.abs(dz) < DET_EPS, DET_EPS, 0.0)
    t = -oz / dz
    b1 = ox + t * dx
    b2 = oy + t * dy
    return t, b1, b2, dz


@partial(jax.jit, static_argnames=("chunk",))
def project_closest(origin, direction, near, far, tri_w, tri_c, chunk: int = 512):
    """Closest hit of rays [R,3] against all triangle frames (see above).

    Returns (t [R], tri_id [R] i32, -1 = miss). Barycentrics/orientation are
    recomputed by the caller via ``refine_hit`` on the winning id.
    """
    r = origin.shape[0]
    f = tri_w.shape[1] // 3
    n_chunks = -(-f // chunk)
    fp = n_chunks * chunk
    # pad to a chunk multiple with never-hit frames (w = 0, c = (-1,-1,1))
    w_all = jnp.pad(tri_w.reshape(3, 3, f), ((0, 0), (0, 0), (0, fp - f)))
    c_all = jnp.pad(tri_c.reshape(3, f), ((0, 0), (0, fp - f)))
    c_all = c_all.at[0, f:].set(-1.0).at[1, f:].set(-1.0).at[2, f:].set(1.0)

    def block(i0, best_t, best_id):
        w = jax.lax.dynamic_slice_in_dim(w_all, i0, chunk, 2).reshape(3, 3 * chunk)
        c = jax.lax.dynamic_slice_in_dim(c_all, i0, chunk, 1).reshape(3 * chunk)
        t, b1, b2, _ = _project_terms(origin, direction, w, c)
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > near[:, None]) & (t < best_t[:, None]))
        t = jnp.where(valid, t, BIG)
        tk = jnp.min(t, axis=1)
        k = jnp.argmin(t, axis=1).astype(jnp.int32)
        upd = tk < best_t
        best_id = jnp.where(upd, i0 + k, best_id)
        best_t = jnp.where(upd, tk, best_t)
        return best_t, best_id

    best_t = jnp.minimum(far, BIG)
    best_id = jnp.full(r, -1, jnp.int32)
    if n_chunks == 1:
        best_t, best_id = block(0, best_t, best_id)
    else:
        def body(carry, i):
            bt, bi = block(i * chunk, carry[0], carry[1])
            return (bt, bi), None
        (best_t, best_id), _ = jax.lax.scan(
            body, (best_t, best_id), jnp.arange(n_chunks))
    return best_t, best_id


@partial(jax.jit, static_argnames=("chunk",))
def project_shadow(origin, direction, dist, tri_w, tri_c,
                   tri_opacity_rgb, tri_opacity_a, chunk: int = 512):
    """Transmission-filtered shadow test via projection frames (reference
    anyIntersection semantics, cuda_instance.cuh:92-164): multiply opacity
    color over every intersection in (0, dist). Returns (rgb [R,3], a [R])."""
    r = origin.shape[0]
    f = tri_w.shape[1] // 3
    n_chunks = -(-f // chunk)
    fp = n_chunks * chunk
    w_all = jnp.pad(tri_w.reshape(3, 3, f), ((0, 0), (0, 0), (0, fp - f)))
    c_all = jnp.pad(tri_c.reshape(3, f), ((0, 0), (0, fp - f)))
    c_all = c_all.at[0, f:].set(-1.0).at[1, f:].set(-1.0).at[2, f:].set(1.0)
    rgb_all = jnp.pad(tri_opacity_rgb, ((0, fp - f), (0, 0)), constant_values=1.0)
    a_all = jnp.pad(tri_opacity_a, (0, fp - f), constant_values=1.0)

    def block(i0, mr, mg, mb, ma):
        w = jax.lax.dynamic_slice_in_dim(w_all, i0, chunk, 2).reshape(3, 3 * chunk)
        c = jax.lax.dynamic_slice_in_dim(c_all, i0, chunk, 1).reshape(3 * chunk)
        rgb = jax.lax.dynamic_slice_in_dim(rgb_all, i0, chunk, 0)
        a = jax.lax.dynamic_slice_in_dim(a_all, i0, chunk, 0)
        t, b1, b2, _ = _project_terms(origin, direction, w, c)
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > 0.0) & (t < dist[:, None]))
        mr = mr * jnp.prod(jnp.where(valid, rgb[None, :, 0], 1.0), axis=1)
        mg = mg * jnp.prod(jnp.where(valid, rgb[None, :, 1], 1.0), axis=1)
        mb = mb * jnp.prod(jnp.where(valid, rgb[None, :, 2], 1.0), axis=1)
        ma = ma * jnp.prod(jnp.where(valid, a[None, :], 1.0), axis=1)
        return mr, mg, mb, ma

    ones = jnp.ones(r)
    mr = mg = mb = ma = ones
    if n_chunks == 1:
        mr, mg, mb, ma = block(0, mr, mg, mb, ma)
    else:
        def body(carry, i):
            return block(i * chunk, *carry), None
        (mr, mg, mb, ma), _ = jax.lax.scan(
            body, (mr, mg, mb, ma), jnp.arange(n_chunks))
    return jnp.stack([mr, mg, mb], axis=1), ma


def _mt_core(origin, direction, v0, e1, e2):
    """Moller-Trumbore terms for rays [R,1,3] against triangles [1,T,3].

    Returns (t, b1, b2, det) each [R,T].
    """
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    det = det + jnp.where(jnp.abs(det) < DET_EPS, DET_EPS, 0.0)
    inv_det = 1.0 / det
    tvec = origin - v0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, b1, b2, det


@partial(jax.jit, static_argnames=("chunk",))
def brute_force_closest(origin, direction, near, far, tri_v0, tri_e1, tri_e2, chunk: int = 512):
    """Closest hit of rays [R,3] against ALL triangles [F,3] (F % chunk == 0 after pad).

    Returns (t [R], tri_id [R] i32 (-1 = miss), b1, b2, external [R] bool).
    """
    R = origin.shape[0]
    F = tri_v0.shape[0]
    n_chunks = -(-F // chunk)
    Fp = n_chunks * chunk

    def pad(a):
        return jnp.pad(a, ((0, Fp - F), (0, 0)), constant_values=1e30 if a is tri_v0 else 0.0)

    v0 = pad(tri_v0).reshape(n_chunks, chunk, 3)
    e1 = pad(tri_e1).reshape(n_chunks, chunk, 3)
    e2 = pad(tri_e2).reshape(n_chunks, chunk, 3)

    o = origin[:, None, :]
    d = direction[:, None, :]

    def body(carry, tris):
        best_t, best_id, best_b1, best_b2, best_ext, base = carry
        cv0, ce1, ce2 = tris
        t, b1, b2, det = _mt_core(o, d, cv0[None], ce1[None], ce2[None])
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > near[:, None]) & (t < best_t[:, None]))
        t = jnp.where(valid, t, BIG)
        k = jnp.argmin(t, axis=1)
        rows = jnp.arange(R)
        tk = t[rows, k]
        upd = tk < best_t
        best_id = jnp.where(upd, base + k.astype(jnp.int32), best_id)
        best_b1 = jnp.where(upd, b1[rows, k], best_b1)
        best_b2 = jnp.where(upd, b2[rows, k], best_b2)
        best_ext = jnp.where(upd, det[rows, k] > 0.0, best_ext)
        best_t = jnp.where(upd, tk, best_t)
        return (best_t, best_id, best_b1, best_b2, best_ext, base + chunk), None

    init = (jnp.minimum(far, BIG), jnp.full(R, -1, jnp.int32),
            jnp.zeros(R), jnp.zeros(R), jnp.ones(R, bool), jnp.int32(0))
    (t, tri_id, b1, b2, ext, _), _ = jax.lax.scan(body, init, (v0, e1, e2))
    return t, tri_id, b1, b2, ext


@partial(jax.jit, static_argnames=("chunk",))
def brute_force_shadow(origin, direction, dist, tri_v0, tri_e1, tri_e2,
                       tri_opacity_rgb, tri_opacity_a, chunk: int = 512):
    """Transmission-filtered shadow test (reference anyIntersection,
    cuda_instance.cuh:92-164): multiply per-triangle opacity color over every
    intersection in (0, dist).

    ``tri_opacity_rgb`` [F,3] / ``tri_opacity_a`` [F] are the per-triangle
    *constant* opacity colors (texture-modulated alpha is applied by the caller
    via the textured shadow path when maps are present).

    Returns shadow mask rgb [R,3] and alpha [R].
    """
    R = origin.shape[0]
    F = tri_v0.shape[0]
    n_chunks = -(-F // chunk)
    Fp = n_chunks * chunk

    def pad3(a, fill=0.0):
        return jnp.pad(a, ((0, Fp - F), (0, 0)), constant_values=fill)

    v0 = pad3(tri_v0, 1e30).reshape(n_chunks, chunk, 3)
    e1 = pad3(tri_e1).reshape(n_chunks, chunk, 3)
    e2 = pad3(tri_e2).reshape(n_chunks, chunk, 3)
    orgb = pad3(tri_opacity_rgb, 1.0).reshape(n_chunks, chunk, 3)
    oa = jnp.pad(tri_opacity_a, (0, Fp - F), constant_values=1.0).reshape(n_chunks, chunk)

    o = origin[:, None, :]
    d = direction[:, None, :]

    def body(carry, tris):
        mrgb, ma = carry
        cv0, ce1, ce2, crgb, ca = tris
        t, b1, b2, _ = _mt_core(o, d, cv0[None], ce1[None], ce2[None])
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > 0.0) & (t < dist[:, None]))
        # product over hit triangles in this chunk
        rgb_f = jnp.where(valid[..., None], crgb[None], 1.0)
        a_f = jnp.where(valid, ca[None], 1.0)
        mrgb = mrgb * jnp.prod(rgb_f, axis=1)
        ma = ma * jnp.prod(a_f, axis=1)
        return (mrgb, ma), None

    init = (jnp.ones((R, 3)), jnp.ones(R))
    (mrgb, ma), _ = jax.lax.scan(body, init, (v0, e1, e2, orgb, oa))
    return mrgb, ma


def refine_hit(origin, direction, tri_id, tri_v0, tri_e1, tri_e2):
    """Differentiably recompute (t, b1, b2, det) for already-resolved hits.

    Gathers triangle data by ``tri_id`` (clamped; callers mask misses) and
    reruns Moller-Trumbore — gradients flow to ray and triangle parameters
    while the discrete hit id stays fixed (path-replay backprop).
    """
    from .gather import gather_rows
    idx = jnp.maximum(tri_id, 0)
    v0 = gather_rows(tri_v0, idx)
    e1 = gather_rows(tri_e1, idx)
    e2 = gather_rows(tri_e2, idx)
    return refine_tri(origin, direction, v0, e1, e2)


def refine_tri(origin, direction, v0, e1, e2):
    """Per-ray explicit Moller-Trumbore refine: one triangle per ray, all
    [R,3]. Returns (t, b1, b2, det). Used directly by the two-level path,
    which transforms the hit triangle to world space first."""
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    det = det + jnp.where(jnp.abs(det) < DET_EPS, DET_EPS, 0.0)
    inv_det = 1.0 / det
    tvec = origin - v0
    b1 = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    b2 = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, b1, b2, det


def aabb_hit(origin, inv_dir, near, far, bb_min, bb_max):
    """Slab test (reference BoundingBox::rayIntersection,
    cuda_render_parts.cuh:1170-1190). All args broadcastable; returns bool."""
    t1 = (bb_min - origin) * inv_dir
    t2 = (bb_max - origin) * inv_dir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tmax >= near) & (tmin <= tmax) & (tmin <= far)
