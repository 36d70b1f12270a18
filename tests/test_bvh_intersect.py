import numpy as np
import jax.numpy as jnp

from rayzath_tpu.ops.bvh import (build_bvh, compute_skip_links, triangle_aabbs,
                                 validate_bvh)
from rayzath_tpu.ops.intersect import brute_force_closest, brute_force_shadow, refine_hit
from rayzath_tpu.ops import traverse
from rayzath_tpu.ops.traverse import build_aabb_links
from rayzath_tpu.models.mesh import generate_uv_sphere, generate_cube


def random_tris(n, seed=0, scale=10.0):
    rng = np.random.default_rng(seed)
    v0 = (rng.random((n, 3)) - 0.5) * scale
    e1 = (rng.random((n, 3)) - 0.5) * 2.0
    e2 = (rng.random((n, 3)) - 0.5) * 2.0
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def random_rays(n, seed=1, scale=12.0):
    rng = np.random.default_rng(seed)
    o = (rng.random((n, 3)) - 0.5) * scale
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_bvh_build_valid():
    v0, e1, e2 = random_tris(500)
    pmin, pmax = triangle_aabbs(v0, v0 + e1, v0 + e2)
    bvh = build_bvh(pmin, pmax, leaf_size=8)
    validate_bvh(bvh, pmin, pmax)
    # inner nodes have adjacent children
    inner = bvh.node_count == 0
    assert (bvh.node_begin[inner] + 1 < bvh.n_nodes + 1).all()


def test_traversal_matches_brute_force():
    v0, e1, e2 = random_tris(300)
    pmin, pmax = triangle_aabbs(v0, v0 + e1, v0 + e2)
    bvh = build_bvh(pmin, pmax, leaf_size=8)
    o = bvh.order
    v0, e1, e2 = v0[o], e1[o], e2[o]

    ro, rd = random_rays(256)
    near = np.zeros(256, np.float32)
    far = np.full(256, 3e38, np.float32)

    t_b, id_b, b1_b, b2_b, ext_b = brute_force_closest(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), chunk=64)
    first8, skip8 = compute_skip_links(bvh.node_begin, bvh.node_count,
                                       bvh.node_axis)
    links = build_aabb_links(bvh.node_min, bvh.node_max, bvh.node_count,
                             first8, skip8)
    t_t, id_t = traverse.closest(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far),
        jnp.asarray(links),
        jnp.asarray(bvh.node_begin), jnp.asarray(bvh.node_count),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))

    miss_b = np.asarray(id_b) < 0
    miss_t = np.asarray(id_t) < 0
    np.testing.assert_array_equal(miss_b, miss_t)
    m = ~miss_b
    np.testing.assert_allclose(np.asarray(t_t)[m], np.asarray(t_b)[m], rtol=1e-4, atol=1e-5)
    # same triangle except exact t-ties
    same = np.asarray(id_t)[m] == np.asarray(id_b)[m]
    assert same.mean() > 0.99


def test_shadow_matches_brute_force():
    v0, e1, e2 = random_tris(200, seed=3)
    pmin, pmax = triangle_aabbs(v0, v0 + e1, v0 + e2)
    bvh = build_bvh(pmin, pmax, leaf_size=8)
    o = bvh.order
    v0, e1, e2 = v0[o], e1[o], e2[o]
    rng = np.random.default_rng(5)
    orgb = rng.random((200, 3)).astype(np.float32) * 0.5 + 0.5
    oa = rng.random(200).astype(np.float32)

    ro, rd = random_rays(128, seed=7)
    dist = np.full(128, 20.0, np.float32)

    rgb_b, a_b = brute_force_shadow(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(dist),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(orgb), jnp.asarray(oa), chunk=64)
    first8, skip8 = compute_skip_links(bvh.node_begin, bvh.node_count,
                                       bvh.node_axis)
    links = build_aabb_links(bvh.node_min, bvh.node_max, bvh.node_count,
                             first8, skip8)
    rgb_t, a_t = traverse.shadow(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(dist),
        jnp.asarray(links),
        jnp.asarray(bvh.node_begin), jnp.asarray(bvh.node_count),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        jnp.asarray(orgb), jnp.asarray(oa))

    # early-out rays may stop once alpha < 1e-4; compare where brute alpha >= 1e-4
    keep = np.asarray(a_b) >= 1e-4
    np.testing.assert_allclose(np.asarray(a_t)[keep], np.asarray(a_b)[keep], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(rgb_t)[keep], np.asarray(rgb_b)[keep], rtol=1e-4, atol=1e-5)


def test_refine_hit_matches_and_differentiable():
    import jax
    mesh = generate_uv_sphere(12)
    v0 = mesh.vertices[mesh.tri_v[:, 0]]
    v1 = mesh.vertices[mesh.tri_v[:, 1]]
    v2 = mesh.vertices[mesh.tri_v[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    ro = np.tile([[0, 0, -5]], (64, 1)).astype(np.float32)
    ang = np.linspace(-0.15, 0.15, 64)
    rd = np.stack([np.sin(ang), np.zeros(64), np.cos(ang)], 1).astype(np.float32)
    near = np.zeros(64, np.float32)
    far = np.full(64, 3e38, np.float32)
    t, tid, b1, b2, ext = brute_force_closest(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(near), jnp.asarray(far),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), chunk=64)
    assert (np.asarray(tid) >= 0).all()
    t2, b1r, b2r, det = refine_hit(jnp.asarray(ro), jnp.asarray(rd), tid,
                                   jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    np.testing.assert_allclose(np.asarray(t2), np.asarray(t), rtol=1e-4, atol=1e-5)

    # gradient of mean hit distance wrt ray origin is well-defined
    def loss(o):
        tt, _, _, _ = refine_hit(o, jnp.asarray(rd), tid,
                                 jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
        return jnp.mean(tt)
    g = jax.grad(loss)(jnp.asarray(ro))
    assert np.isfinite(np.asarray(g)).all()
    # moving all origins along +z by eps reduces mean t by ~eps
    assert np.asarray(g)[:, 2].sum() < -0.9


def test_cube_inside_outside():
    mesh = generate_cube()
    v0 = mesh.vertices[mesh.tri_v[:, 0]]
    e1 = mesh.vertices[mesh.tri_v[:, 1]] - v0
    e2 = mesh.vertices[mesh.tri_v[:, 2]] - v0
    # ray from inside hits a backface (external=False)
    ro = np.zeros((1, 3), np.float32)
    rd = np.array([[0, 0, 1]], np.float32)
    t, tid, b1, b2, ext = brute_force_closest(
        jnp.asarray(ro), jnp.asarray(rd), jnp.zeros(1), jnp.full(1, 3e38),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), chunk=16)
    assert np.asarray(tid)[0] >= 0
    assert np.isclose(np.asarray(t)[0], 0.5, atol=1e-5)
    assert not bool(np.asarray(ext)[0])


def test_size_partition_separates_oversized_primitives():
    """Too-large-object partition (reference bvh_tree_node.hpp:127-148):
    a huge ground plane mixed into a dense ball must land in its own leaf
    instead of inflating every leaf AABB it gets grouped into."""
    import numpy as np
    from rayzath_tpu.ops.bvh import build_bvh, triangle_aabbs

    rng = np.random.default_rng(5)
    # dense ball of small triangles around the origin
    n = 600
    c = rng.normal(size=(n, 3)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    v0 = c
    e1 = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32)
    # two huge ground-plane triangles spanning 100x the ball
    pv0 = np.array([[-100, -1.2, -100], [100, -1.2, 100]], np.float32)
    pe1 = np.array([[200, 0, 0], [-200, 0, 0]], np.float32)
    pe2 = np.array([[0, 0, 200], [0, 0, -200]], np.float32)
    v0 = np.concatenate([v0, pv0])
    e1 = np.concatenate([e1, pe1])
    e2 = np.concatenate([e2, pe2])
    pmin, pmax = triangle_aabbs(v0, v0 + e1, v0 + e2)
    bvh = build_bvh(pmin, pmax, leaf_size=8)

    leaf = bvh.node_count > 0
    plane_ids = {n, n + 1}
    for nid in np.nonzero(leaf)[0]:
        b, cnt = bvh.node_begin[nid], bvh.node_count[nid]
        prims = set(bvh.order[b:b + cnt].tolist())
        if prims & plane_ids:
            # the plane triangles share a leaf only with each other
            assert prims <= plane_ids, f"plane mixed into leaf {prims}"
        else:
            # ball leaves keep tight boxes (nowhere near plane scale)
            ext = bvh.node_max[nid] - bvh.node_min[nid]
            assert float(ext.max()) < 3.0
