"""The per-ray walk's Pallas kernels (ops/traverse_gpu.py), run through the
Pallas interpreter on the CPU, against the dense brute-force oracle.

Ray counts are deliberately not multiples of the kernel's block, so the
padding of the last block is exercised too.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from rayzath_tpu.ops import traverse
from rayzath_tpu.ops.intersect import brute_force_closest, brute_force_shadow
from rayzath_tpu.ops.traverse_gpu import BLOCK, gpu_closest, gpu_shadow

from test_cluster_traversal import bvh_soup, make_rays, make_soup


def _closest(o, d, near, far, soup):
    v0, e1, e2, tables = soup
    return gpu_closest(o, d, near, far, *tables, v0, e1, e2, interpret=True)


def _check_closest(o, d, near, far, soup):
    v0, e1, e2, _ = soup
    t, tid = _closest(o, d, near, far, soup)
    t_ref, tid_ref, _, _, _ = brute_force_closest(
        o, d, near, far, v0, e1, e2, chunk=min(512, v0.shape[0]))
    hit = np.asarray(tid_ref) >= 0
    assert (np.asarray(tid) >= 0).tolist() == hit.tolist()
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(t_ref)[hit],
                               rtol=2e-4, atol=2e-5)
    same = np.asarray(tid) == np.asarray(tid_ref)
    assert (same | ~hit).mean() > 0.98
    return hit


@pytest.mark.parametrize("n_tri", [64, 900])
def test_kernel_closest_matches_brute_force(n_tri):
    r = 3 * BLOCK - 37
    o, d = make_rays(r, seed=61)
    soup = bvh_soup(*make_soup(n_tri, seed=60, size=0.6))
    hit = _check_closest(o, d, jnp.zeros(r), jnp.full(r, 1e30), soup)
    assert hit.any()


@pytest.mark.parametrize("n_tri", [64, 900])
def test_kernel_shadow_matches_brute_force(n_tri):
    r = 2 * BLOCK + 5
    v0, e1, e2, tables = bvh_soup(*make_soup(n_tri, seed=70, size=0.6))
    rng = np.random.default_rng(71)
    op_rgb = jnp.asarray(rng.uniform(0.3, 1.0, (n_tri, 3)).astype(np.float32))
    op_a = jnp.asarray(rng.uniform(0.4, 1.0, n_tri).astype(np.float32))
    o, d = make_rays(r, seed=72)
    dist = jnp.full(r, 7.0)
    rgb, a = gpu_shadow(o, d, dist, *tables, v0, e1, e2, op_rgb, op_a,
                        interpret=True)
    rgb_ref, a_ref = brute_force_shadow(o, d, dist, v0, e1, e2, op_rgb, op_a,
                                        chunk=min(512, n_tri))
    assert (np.asarray(a_ref) < 1.0).any()
    live = np.asarray(a_ref) >= 1e-3
    np.testing.assert_allclose(np.asarray(a)[live], np.asarray(a_ref)[live],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(rgb)[live],
                               np.asarray(rgb_ref)[live], rtol=1e-4, atol=1e-5)


def test_kernel_near_far_window():
    r = 200
    o, d = make_rays(r, seed=81)
    rng = np.random.default_rng(82)
    near = jnp.asarray(rng.uniform(0.0, 2.0, r).astype(np.float32))
    far = jnp.asarray(rng.uniform(3.0, 9.0, r).astype(np.float32))
    _check_closest(o, d, near, far, bvh_soup(*make_soup(400, seed=80,
                                                        size=0.6)))


def test_kernel_empty_scene():
    z = np.zeros((0, 3), np.float32)
    v0, e1, e2, tables = bvh_soup(z, z, z)
    # the walk never reads a triangle; the tables still need one row
    pad = jnp.zeros((1, 3), jnp.float32)
    o, d = make_rays(130, seed=91)
    t, tid = gpu_closest(o, d, jnp.zeros(130), jnp.full(130, 1e30), *tables,
                         pad, pad, pad, interpret=True)
    assert (np.asarray(tid) == -1).all()
    rgb, a = gpu_shadow(o, d, jnp.full(130, 1e30), *tables, pad, pad, pad,
                        pad, jnp.zeros(1), interpret=True)
    assert (np.asarray(a) == 1.0).all() and (np.asarray(rgb) == 1.0).all()


def test_kernel_walks_leaves_past_the_leaf_size():
    """Triangles spanning their node's box in every axis are split off into
    leaves that may hold more than ``leaf_size`` triangles (ops/bvh.py's
    too-large partition); the kernel loops over each leaf's full count."""
    n = 24
    ang = np.linspace(0.0, np.pi, n, endpoint=False)
    # a fan of large triangles through one axis: every one spans the box
    v0 = np.zeros((n, 3), np.float32)
    e1 = np.stack([4 * np.cos(ang), 4 * np.sin(ang), np.full(n, 4.0)],
                  1).astype(np.float32)
    e2 = np.stack([-4 * np.cos(ang), -4 * np.sin(ang), np.full(n, 4.0)],
                  1).astype(np.float32) * 0.999
    e1 = e1 - 2.0
    order, links, begin, count = traverse.bvh_tables(v0, e1, e2)
    assert count.max() > 8
    o, d = make_rays(256, seed=93, spread=3.0)
    hit = _check_closest(o, d, jnp.zeros(256), jnp.full(256, 1e30),
                         bvh_soup(v0, e1, e2))
    assert hit.any()
