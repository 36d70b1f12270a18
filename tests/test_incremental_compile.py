"""Incremental scene compile: a materials-only edit must not rebuild the BVH
tables, must keep every device shape stable (so the jit cache holds), and must re-flatten in a small fraction of the full
compile time. Reference analog: StateRegister-guarded partial re-mirroring
(updatable.hpp:10-54, cuda_object_container.cuh:42-150)."""
import time

import numpy as np

import rayzath_tpu as rz
from rayzath_tpu.models.device_scene import compile_world, _bucket


def test_bucket_shapes():
    assert _bucket(0) == 8 and _bucket(8) == 8 and _bucket(9) == 12
    assert _bucket(17) == 24 and _bucket(25) == 32 and _bucket(100) == 128
    assert _bucket(96) == 96 and _bucket(97) == 128


def test_material_edit_reuses_geometry_blocks():
    w = rz.scenes.mesh_heavy(64, 64, resolution=96)
    cache = {}
    t0 = time.perf_counter()
    a = compile_world(w, cache=cache)
    full = time.perf_counter() - t0

    w.materials[0].roughness = 0.9         # materials-only edit
    t0 = time.perf_counter()
    b = compile_world(w, cache=cache)
    incr = time.perf_counter() - t0

    # geometry block reused WHOLESALE: identical array objects, not copies
    assert b.tri_pw is a.tri_pw
    assert b.aabb_links is a.aabb_links
    assert b.node_begin is a.node_begin
    # the material table did change
    assert float(b.mat_roughness[2]) != float(a.mat_roughness[2]) or \
        float(b.mat_roughness[np.argmax(np.asarray(b.mat_roughness)
                                        != np.asarray(a.mat_roughness))]) \
        != float(a.mat_roughness[0])
    # and the re-flatten is much cheaper than the full build
    assert incr < max(0.25 * full, 0.15), (full, incr)


def test_small_geometry_edit_keeps_shapes():
    """Adding one small object must not shift the padded shapes (jit-cache
    stability): bucketed padding absorbs it."""
    w = rz.scenes.teapot_like(32, 32)
    a = compile_world(w)
    mesh = w.generate_mesh("cube")
    w.create_instance(name="pebble", mesh=mesh,
                      materials=[w.materials[0]])
    b = compile_world(w)
    assert b.tri_v0.shape == a.tri_v0.shape
    assert b.aabb_links.shape == a.aabb_links.shape
    assert b.node_begin.shape == a.node_begin.shape
