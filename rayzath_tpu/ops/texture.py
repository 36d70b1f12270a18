"""Vectorized texture-map fetch from packed atlases.

Semantics mirror the reference ``TextureBuffer::fetch`` (render_parts.hpp:209-221)
and the CUDA texture path (cuda_buffer.cuh TextureBuffer): the UV transform is
``uv += translation; uv.rotate(rotation); uv *= scale``; the v axis is flipped
(image row 0 = top, v = 1); point or bilinear filtering with
wrap/clamp/mirror/border addressing.

All maps live in two atlases (color RGBA + scalar), with per-map integer rects,
so a single gather-based kernel serves every map kind.
"""
from __future__ import annotations

import jax.numpy as jnp

FILTER_POINT = 0
FILTER_LINEAR = 1
ADDRESS_WRAP = 0
ADDRESS_CLAMP = 1
ADDRESS_MIRROR = 2
ADDRESS_BORDER = 3


def _apply_address(x, mode):
    """Apply address mode to normalized coordinate x (any shape); returns
    (coord in [0,1), border_mask)."""
    wrap = jnp.mod(x, 1.0)
    clamp = jnp.clip(x, 0.0, 1.0 - 1e-6)
    period = jnp.mod(x, 2.0)
    mirror = jnp.where(period > 1.0, 2.0 - period, period)
    mirror = jnp.clip(mirror, 0.0, 1.0 - 1e-6)
    border_out = (x < 0.0) | (x >= 1.0)
    coord = jnp.where(mode == ADDRESS_WRAP, wrap,
             jnp.where(mode == ADDRESS_CLAMP, clamp,
              jnp.where(mode == ADDRESS_MIRROR, mirror, clamp)))
    is_border = (mode == ADDRESS_BORDER) & border_out
    return coord, is_border


def _transform_uv(uv, map_uv, map_id):
    """uv += translation; rotate; *= scale (reference render_parts.hpp:209-212)."""
    prm = map_uv[map_id]  # [R,5]: sx, sy, rot, tx, ty
    u = uv[..., 0] + prm[..., 3]
    v = uv[..., 1] + prm[..., 4]
    c, s = jnp.cos(prm[..., 2]), jnp.sin(prm[..., 2])
    ur = u * c - v * s
    vr = u * s + v * c
    return ur * prm[..., 0], vr * prm[..., 1]


def block_indices(rects, h_atlas: int, w_atlas: int):
    """Static [H*W, 4] linear indices of each texel's 2x2 bilinear block,
    with the +1 neighbors clamped WITHIN their map's rect (matching the
    per-map clip the gather-based fetch applied). Junk texels outside every
    rect clamp against the atlas edge; they are never addressed by a valid
    (map_id, uv). Built once per atlas at scene compile (numpy)."""
    import numpy as np
    yy, xx = np.meshgrid(np.arange(h_atlas), np.arange(w_atlas),
                         indexing="ij")
    x1 = np.minimum(xx + 1, w_atlas - 1)
    y1 = np.minimum(yy + 1, h_atlas - 1)
    for (y0, x0, hh, ww) in np.asarray(rects).reshape(-1, 4):
        sl = (slice(y0, y0 + hh), slice(x0, x0 + ww))
        x1[sl] = np.minimum(x1[sl], x0 + ww - 1)
        y1[sl] = np.minimum(y1[sl], y0 + hh - 1)

    def lin(y, x):
        return (y * w_atlas + x).astype(np.int32)

    return np.stack([lin(yy, xx), lin(yy, x1), lin(y1, xx), lin(y1, x1)],
                    axis=-1).reshape(-1, 4)


def fetch(color_atlas, scalar_atlas, map_rect, map_flags, map_uv, map_id, uv,
          atlas=None, col_blk=None, sc_blk=None):
    """Fetch maps for a batch: ``map_id`` [R] int32 (>=0), ``uv`` [R,2].

    Returns [R,4]: RGBA for color-atlas maps; scalar maps broadcast the value
    to all four channels.

    ``atlas``: static hint (0=color, 1=scalar, None=mixed batch). Most call
    sites know their map kind statically — the hint halves the gather count.
    Every [R]-row gather from an atlas is a full pass over the wavefront,
    so this function gathers exactly 4 corners from exactly one atlas when
    it can — the point-filter result is derived from the bilinear corners
    (floor(f) == floor(f-0.5) + [frac >= 0.5], exactly), not re-gathered.
    What each gather costs on the GPU has not been measured."""
    mid = jnp.maximum(map_id, 0)
    u, v = _transform_uv(uv, map_uv, mid)
    flags = map_flags[mid]
    filt, addr, which = flags[..., 0], flags[..., 1], flags[..., 2]
    rect = map_rect[mid]
    y0, x0 = rect[..., 0], rect[..., 1]
    h, w = rect[..., 2], rect[..., 3]

    un, ub = _apply_address(u, addr)
    vn, vb = _apply_address(v, addr)
    vn = 1.0 - vn  # v flip (reference render_parts.hpp:214)
    is_border = ub | vb

    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)

    caw = color_atlas.shape[1]
    saw = scalar_atlas.shape[1]
    col_flat = color_atlas.reshape(-1, 4)
    sc_flat = scalar_atlas.reshape(-1)

    # bilinear corners (texel centers at +0.5)
    fx = un * wf - 0.5
    fy = vn * hf - 0.5
    x_lo = jnp.floor(fx).astype(jnp.int32)
    y_lo = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - x_lo.astype(jnp.float32))[..., None]
    ay = (fy - y_lo.astype(jnp.float32))[..., None]

    if (col_blk is not None if atlas == 0 else
            (sc_blk is not None and atlas == 1)):
        # ONE row gather of the texel's precomputed 2x2 block instead of 4
        # corner gathers: the block table carries each texel's clamped
        # neighbors (block_indices), so clipping x_lo/y_lo into the rect and
        # zeroing the weight at the left/top edge reproduces the 4-gather
        # result exactly (at the left edge both corners were the same texel,
        # so the interpolation weight is irrelevant there)
        ax = jnp.where((x_lo < 0)[..., None], 0.0, ax)
        ay = jnp.where((y_lo < 0)[..., None], 0.0, ay)
        xc = jnp.clip(x_lo, 0, w - 1) + x0
        yc = jnp.clip(y_lo, 0, h - 1) + y0
        if atlas == 1:
            srow = jnp.take(sc_blk, yc * saw + xc, axis=0)    # [R, 4]
            v00 = srow[:, 0:1]
            v10 = srow[:, 1:2]
            v01 = srow[:, 2:3]
            v11 = srow[:, 3:4]
            one = ((v00 * (1 - ax) + v10 * ax) * (1 - ay)
                   + (v01 * (1 - ax) + v11 * ax) * ay)
            # broadcast to rgba AFTER interpolation: quarter the math
            def bc(x):
                return jnp.broadcast_to(x, x.shape[:-1] + (4,))
            v00, v10, v01, v11 = bc(v00), bc(v10), bc(v01), bc(v11)
            linear_val = bc(one)
        else:
            crow = jnp.take(col_blk, yc * caw + xc, axis=0)   # [R, 16]
            v00 = crow[:, 0:4]
            v10 = crow[:, 4:8]
            v01 = crow[:, 8:12]
            v11 = crow[:, 12:16]
            linear_val = ((v00 * (1 - ax) + v10 * ax) * (1 - ay)
                          + (v01 * (1 - ax) + v11 * ax) * ay)
    else:
        def gather(px, py):
            px = jnp.clip(px, 0, w - 1) + x0
            py = jnp.clip(py, 0, h - 1) + y0
            if atlas == 0:
                return col_flat[py * caw + px]
            if atlas == 1:
                sc = sc_flat[py * saw + px]
                return jnp.broadcast_to(sc[..., None], sc.shape + (4,))
            # mixed batch: a map id of one kind indexes the other atlas
            # too, so clamp both linear indexes before the (masked) reads
            c = col_flat[jnp.minimum(py * caw + px, col_flat.shape[0] - 1)]
            sc = sc_flat[jnp.minimum(py * saw + px, sc_flat.shape[0] - 1)]
            s4 = jnp.broadcast_to(sc[..., None], sc.shape + (4,))
            return jnp.where((which == 0)[..., None], c, s4)

        v00 = gather(x_lo, y_lo)
        v10 = gather(x_lo + 1, y_lo)
        v01 = gather(x_lo, y_lo + 1)
        v11 = gather(x_lo + 1, y_lo + 1)
        linear_val = ((v00 * (1 - ax) + v10 * ax) * (1 - ay)
                      + (v01 * (1 - ax) + v11 * ax) * ay)
    # point sample == the corner selected by rounding the fractional parts
    # (exact: floor(f) = floor(f - 0.5) + [frac >= 0.5], incl. the clip)
    sx = ax >= 0.5
    sy = ay >= 0.5
    point_val = jnp.where(sy, jnp.where(sx, v11, v01),
                          jnp.where(sx, v10, v00))

    out = jnp.where((filt == FILTER_POINT)[..., None], point_val, linear_val)
    return jnp.where(is_border[..., None], 0.0, out)


def fetch_scene(scene, map_id, uv, atlas=None):
    """Convenience wrapper over a DeviceScene. When the scene carries the
    static 2x2 block-index tables and the atlas kind is known statically,
    the bilinear fetch collapses to ONE row gather (built in-jit from the
    live — trainable — atlas, so gradients still flow into texels)."""
    col_blk = sc_blk = None
    if atlas == 0 and getattr(scene, "col_blk_idx", None) is not None:
        col_blk = jnp.take(scene.color_atlas.reshape(-1, 4),
                           scene.col_blk_idx.reshape(-1),
                           axis=0).reshape(-1, 16)
    elif atlas == 1 and getattr(scene, "sc_blk_idx", None) is not None:
        sc_blk = jnp.take(scene.scalar_atlas.reshape(-1),
                          scene.sc_blk_idx.reshape(-1),
                          axis=0).reshape(-1, 4)
    return fetch(scene.color_atlas, scene.scalar_atlas, scene.map_rect,
                 scene.map_flags, scene.map_uv, map_id, uv, atlas=atlas,
                 col_blk=col_blk, sc_blk=sc_blk)
