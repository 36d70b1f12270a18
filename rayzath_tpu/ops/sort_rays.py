"""Ray-coherence sorting before traversal.

After a bounce the wavefront is incoherent: neighbouring rays start far
apart and point in different directions, so a block of rays walks very
different parts of the BVH. Sorting restores coherence; the traversal results
are scattered back through the inverse permutation, so callers see row-major
ray order throughout. Whether sorting pays on the GPU's per-ray walk has not
been measured.

``sort_perm`` orders rays by a 32-bit coherence key:

    [31:26] coarse origin cell    (2 bits/axis, batch-normalized bounds)
    [25:23] direction octant      (3 bits)
    [22:15] direction bits        (4+4 bits of the two minor |d| ratios)
    [14:0]  fine origin Morton    (5 bits/axis)

The ORDER of the fields is the design: bounce origins are already coherent
in pixel order, so a fine-Morton-major key changes little; a
coarse-region-major key whose cells hold several blocks, SPLIT BY DIRECTION
inside each cell, gives blocks a sign-definite direction box. Octant-major
fails the other way: blocks collect one octant from all over the image and
the origin box spans the scene. Origins are normalized by the batch's own
min/max — no scene bounds needed, and shadow rays (origins on visible
surfaces) bin just as well as bounce rays. For camera rays (all origins
equal) the key degrades to direction bits, which still groups blocks into
narrow cones. Sorting is a standard XLA sort (no data-dependent shapes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _spread3(x):
    """Interleave 7-bit ints with two zero bits (Morton): 0b1111111 ->
    0b1001001001001001001."""
    x = x.astype(jnp.uint32)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def _quant(v, lo, hi, levels):
    span = jnp.maximum(hi - lo, 1e-20)
    q = (v - lo) / span * levels
    return jnp.clip(q, 0.0, levels - 1.0).astype(jnp.int32)


def coherence_keys(origin, direction):
    """uint32 coherence key per ray (see module docstring)."""
    lo = jnp.min(origin, axis=0)
    hi = jnp.max(origin, axis=0)
    qc = _quant(origin, lo, hi, 4.0).astype(jnp.uint32)     # [R,3] 2-bit
    coarse = qc[:, 0] | (qc[:, 1] << 2) | (qc[:, 2] << 4)   # 6 bits
    qf = _quant(origin, lo, hi, 32.0)                       # [R,3] 5-bit
    fine = (_spread3(qf[:, 0]) | (_spread3(qf[:, 1]) << 1)
            | (_spread3(qf[:, 2]) << 2)) & jnp.uint32(0x7FFF)  # 15 bits
    # 4 bits each from the two minor |direction| axes (scale-free in [0,1])
    ad = jnp.abs(direction)
    mx = jnp.max(ad, axis=1, keepdims=True)
    r = ad / jnp.maximum(mx, 1e-20)                         # dominant axis -> 1
    axis = jnp.argmax(ad, axis=1)
    # the two non-dominant ratios (dominant excluded by masking it to -1)
    r0 = jnp.where(jnp.arange(3)[None, :] == axis[:, None], -1.0, r)
    top2 = jax.lax.top_k(r0, 2)[0]                          # [R,2] in [0,1]
    db = (_quant(top2[:, 0], 0.0, 1.0, 16.0).astype(jnp.uint32) << 4) | \
        _quant(top2[:, 1], 0.0, 1.0, 16.0).astype(jnp.uint32)
    octant = ((direction[:, 0] < 0).astype(jnp.uint32)
              | ((direction[:, 1] < 0).astype(jnp.uint32) << 1)
              | ((direction[:, 2] < 0).astype(jnp.uint32) << 2))
    return (coarse << 26) | (octant << 23) | (db << 15) | fine


def sort_perm(origin, direction):
    """(perm, inv): ``x[perm]`` is coherence-ordered; ``y[inv]`` undoes it."""
    keys = coherence_keys(origin, direction)
    perm = jnp.argsort(keys)
    r = perm.shape[0]
    inv = jnp.zeros(r, jnp.int32).at[perm].set(
        jnp.arange(r, dtype=jnp.int32), unique_indices=True,
        indices_are_sorted=False)
    return perm, inv


def sort_payload(origin, direction, extras):
    """Coherence-sort rays carrying every per-ray column THROUGH the radix
    sort instead of gathering after an argsort.

    ``lax.sort`` with payload operands moves the data WITH the keys in one
    sort, instead of the argsort + row-gather + scatter of
    :func:`sort_perm`.

    Returns (o_s, d_s, extras_s, idx_s) where ``idx_s`` is the original row
    index of each sorted row; undo with :func:`unsort_payload`.
    """
    r = origin.shape[0]
    keys = coherence_keys(jax.lax.stop_gradient(origin),
                          jax.lax.stop_gradient(direction))
    cols = ([origin[:, k] for k in range(3)]
            + [direction[:, k] for k in range(3)])
    widths = []
    for e in extras:
        if e.ndim == 1:
            cols.append(e)
            widths.append(1)
        else:
            cols.extend(e[:, k] for k in range(e.shape[1]))
            widths.append(e.shape[1])
    cols.append(jnp.arange(r, dtype=jnp.int32))
    out = jax.lax.sort((keys, *cols), num_keys=1)
    o_s = jnp.stack(out[1:4], axis=1)
    d_s = jnp.stack(out[4:7], axis=1)
    extras_s = []
    p = 7
    for w in widths:
        if w == 1:
            extras_s.append(out[p])
        else:
            extras_s.append(jnp.stack(out[p:p + w], axis=1))
        p += w
    return o_s, d_s, tuple(extras_s), out[-1]


def unsort_payload(idx_s, outs):
    """Scatter traversal results back to original ray order by sorting on
    the carried original-row index (a second radix pass — no XLA scatter)."""
    cols = []
    widths = []
    for e in outs:
        if e.ndim == 1:
            cols.append(e)
            widths.append(1)
        else:
            cols.extend(e[:, k] for k in range(e.shape[1]))
            widths.append(e.shape[1])
    back = jax.lax.sort((idx_s, *cols), num_keys=1)
    result = []
    p = 1
    for w in widths:
        if w == 1:
            result.append(back[p])
        else:
            result.append(jnp.stack(back[p:p + w], axis=1))
        p += w
    return tuple(result)
