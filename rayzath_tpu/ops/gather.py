"""Row gathers of [R] indices into small tables.

Tables of at most ``ONE_HOT_MAX`` rows are gathered as a one-hot matmul
([R,N] @ [N,K]); larger ones with a dynamic gather. The threshold keeps the
one-hot matrix within a reasonable memory footprint for large R. Whether the
one-hot form pays on the GPU has not been measured.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

ONE_HOT_MAX = 128


def gather_rows(table: jnp.ndarray, idx: jnp.ndarray, one_hot_max: int = ONE_HOT_MAX):
    """table [N, ...], idx [R] int32 (pre-clipped) -> [R, ...].

    Uses a one-hot matmul when N <= one_hot_max, else a dynamic gather.
    XLA CSEs the one-hot across multiple gathers with the same indices.
    """
    n = table.shape[0]
    if n > one_hot_max:
        return table[idx]
    # one bf16 product: the one-hot factor is bf16-exact, and the f32 table
    # values ride through as three bf16 limbs stacked along the contraction
    # axis (full 24-bit mantissa), accumulated in f32 — exact at DEFAULT
    oh = jax.nn.one_hot(idx, n, dtype=jnp.bfloat16)  # [R, N]
    flat = table.reshape(n, -1).astype(jnp.float32)
    h = flat.astype(jnp.bfloat16)
    r1 = flat - h.astype(jnp.float32)
    m = r1.astype(jnp.bfloat16)
    lo = (r1 - m.astype(jnp.float32)).astype(jnp.bfloat16)
    out = jax.lax.dot_general(
        jnp.concatenate([oh, oh, oh], axis=1),
        jnp.concatenate([h, m, lo], axis=0),
        (((1,), (0,)), ((), ())), precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32)
    if not jnp.issubdtype(table.dtype, jnp.floating):
        out = jnp.rint(out).astype(table.dtype)
    return out.reshape((idx.shape[0],) + table.shape[1:])
