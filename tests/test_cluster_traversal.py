"""Parity tests: the BVH walk's entry points vs the dense brute-force oracle.

``ops.traverse.closest`` / ``shadow`` are what the integrator calls (on the
CPU they run the walk's Pallas kernels through the interpreter): closest-hit
and transmission shadow results must match the all-pairs reference (same
t-window semantics), plus a finite-difference check through the shadow
custom_vjp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayzath_tpu.ops import traverse
from rayzath_tpu.ops.intersect import (brute_force_closest, brute_force_shadow)


def make_soup(n, seed=0, spread=4.0, size=0.35):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-size, size, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-size, size, (n, 3)).astype(np.float32)
    return v0, e1, e2


def make_rays(r, seed=1, spread=6.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def bvh_soup(v0, e1, e2):
    """Triangles permuted into leaf order + the walk's tables, as device
    arrays: (v0, e1, e2, (aabb_links, node_begin, node_count))."""
    order, links, begin, count = traverse.bvh_tables(v0, e1, e2)
    tris = tuple(jnp.asarray(a[order]) for a in (v0, e1, e2))
    return tris + ((jnp.asarray(links), jnp.asarray(begin),
                    jnp.asarray(count)),)


@pytest.mark.parametrize("n_tri", [40, 700])
def test_closest_parity(n_tri):
    v0, e1, e2, tables = bvh_soup(*make_soup(n_tri))
    o, d = make_rays(512)
    near = jnp.zeros(512)
    far = jnp.full(512, 1e30)
    t, tid = traverse.closest(o, d, near, far, *tables, v0, e1, e2)
    t_ref, tid_ref, _, _, _ = brute_force_closest(
        o, d, near, far, v0, e1, e2, chunk=min(512, n_tri))
    hit = np.asarray(tid_ref) >= 0
    assert (np.asarray(tid) >= 0).tolist() == hit.tolist()
    assert np.allclose(np.asarray(t)[hit], np.asarray(t_ref)[hit],
                       rtol=2e-4, atol=2e-5)
    # ids may differ only on exact-t ties; then both ts agree
    same = np.asarray(tid) == np.asarray(tid_ref)
    assert (same | ~hit).mean() > 0.98


def test_closest_near_far_window():
    v0, e1, e2, tables = bvh_soup(*make_soup(300, seed=3))
    o, d = make_rays(256, seed=4)
    rng = np.random.default_rng(5)
    near = jnp.asarray(rng.uniform(0.0, 2.0, 256).astype(np.float32))
    far = jnp.asarray(rng.uniform(3.0, 9.0, 256).astype(np.float32))
    t, tid = traverse.closest(o, d, near, far, *tables, v0, e1, e2)
    t_ref, tid_ref, _, _, _ = brute_force_closest(
        o, d, near, far, v0, e1, e2, chunk=300)
    hit = np.asarray(tid_ref) >= 0
    assert (np.asarray(tid) >= 0).tolist() == hit.tolist()
    assert np.allclose(np.asarray(t)[hit], np.asarray(t_ref)[hit],
                       rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n_tri", [40, 700])
def test_shadow_parity(n_tri):
    v0, e1, e2, tables = bvh_soup(*make_soup(n_tri, seed=7))
    rng = np.random.default_rng(8)
    op_rgb = jnp.asarray(rng.uniform(0.3, 1.0, (n_tri, 3)).astype(np.float32))
    op_a = jnp.asarray(rng.uniform(0.4, 1.0, n_tri).astype(np.float32))
    o, d = make_rays(256, seed=9)
    dist = jnp.full(256, 8.0)
    rgb, a = traverse.shadow(o, d, dist, *tables, v0, e1, e2, op_rgb, op_a)
    rgb_ref, a_ref = brute_force_shadow(
        o, d, dist, v0, e1, e2, op_rgb, op_a, chunk=min(512, n_tri))
    # the walk's alpha<1e-4 early-out can stop accumulating where the
    # reference product is already ~0 — compare where alpha is live
    live = np.asarray(a_ref) >= 1e-3
    assert np.allclose(np.asarray(a)[live], np.asarray(a_ref)[live],
                       rtol=1e-4, atol=1e-5)
    assert np.allclose(np.asarray(rgb)[live], np.asarray(rgb_ref)[live],
                       rtol=1e-4, atol=1e-5)


def test_shadow_gradient_fd():
    n_tri = 60
    v0, e1, e2, tables = bvh_soup(*make_soup(n_tri, seed=11, spread=1.5,
                                             size=0.6))
    rng = np.random.default_rng(12)
    op_a0 = rng.uniform(0.5, 0.9, n_tri).astype(np.float32)
    op_rgb = jnp.asarray(rng.uniform(0.3, 1.0, (n_tri, 3)).astype(np.float32))
    o, d = make_rays(64, seed=13, spread=2.5)
    dist = jnp.full(64, 6.0)

    def loss(op_a):
        rgb, a = traverse.shadow(o, d, dist, *tables, v0, e1, e2, op_rgb,
                                 op_a)
        return jnp.sum(a) + jnp.sum(rgb)

    g = jax.grad(loss)(jnp.asarray(op_a0))
    # finite differences on the three largest-gradient triangles
    top = np.argsort(-np.abs(np.asarray(g)))[:3]
    assert float(jnp.abs(g).max()) > 0
    eps = 1e-3
    for k in top:
        ap = op_a0.copy(); ap[k] += eps
        am = op_a0.copy(); am[k] -= eps
        fd = (float(loss(jnp.asarray(ap))) - float(loss(jnp.asarray(am)))) / (2 * eps)
        assert np.isclose(float(g[k]), fd, rtol=5e-2, atol=1e-3), (k, float(g[k]), fd)


def test_payload_sorted_traversal_matches_unsorted():
    """The payload-carrying radix sort (ops/sort_rays.sort_payload) must be a
    pure reordering: traversal results after sort + unsort equal the
    unsorted call exactly."""
    from rayzath_tpu.ops.sort_rays import sort_payload, unsort_payload
    v0, e1, e2, tables = bvh_soup(*make_soup(500, seed=31))
    o, d = make_rays(2048, seed=32)
    near = jnp.zeros(2048)
    far = jnp.full(2048, 1e30)
    t0, tid0 = traverse.closest(o, d, near, far, *tables, v0, e1, e2)
    o_s, d_s, (n_s, f_s), idx = sort_payload(o, d, (near, far))
    t1_s, tid1_s = traverse.closest(o_s, d_s, n_s, f_s, *tables, v0, e1, e2)
    t1, tid1 = unsort_payload(idx, (t1_s, tid1_s))
    np.testing.assert_array_equal(np.asarray(tid1), np.asarray(tid0))
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t0), rtol=1e-6)


def test_empty_and_single_cluster():
    # one triangle: one leaf, some rays guaranteed to miss
    v0 = np.array([[0.0, 0.0, 2.0]], np.float32)
    e1 = np.array([[1.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[0.0, 1.0, 0.0]], np.float32)
    v0, e1, e2, tables = bvh_soup(v0, e1, e2)
    o = jnp.asarray([[0.2, 0.2, 0.0], [5.0, 5.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], jnp.float32)
    t, tid = traverse.closest(o, d, jnp.zeros(2), jnp.full(2, 100.0),
                              *tables, v0, e1, e2)
    assert int(tid[0]) == 0 and abs(float(t[0]) - 2.0) < 1e-5
    assert int(tid[1]) == -1
