"""Tests that need the card (marker ``gpu``): they skip on the CPU and run
with ``RZ_TEST_PLATFORM=gpu python -m pytest -m gpu`` on a GPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayzath_tpu as rz
from rayzath_tpu.ops.intersect import brute_force_closest, brute_force_shadow
from rayzath_tpu.ops.traverse_gpu import gpu_closest, gpu_shadow

from test_cluster_traversal import bvh_soup, make_rays, make_soup

pytestmark = pytest.mark.gpu


def test_compiled_closest_matches_brute_force(gpu):
    v0, e1, e2, tables = bvh_soup(*make_soup(3000, seed=5, size=0.5))
    o, d = make_rays(4096, seed=6)
    near, far = jnp.zeros(4096), jnp.full(4096, 3e38)
    t, tid = gpu_closest(o, d, near, far, *tables, v0, e1, e2)
    t_ref, tid_ref, _, _, _ = brute_force_closest(o, d, near, far, v0, e1,
                                                  e2)
    hit = np.asarray(tid_ref) >= 0
    assert hit.sum() > 100
    assert ((np.asarray(tid) >= 0) == hit).mean() > 0.999
    same = np.asarray(tid) == np.asarray(tid_ref)
    assert same.mean() > 0.999
    np.testing.assert_allclose(np.asarray(t)[hit & same],
                               np.asarray(t_ref)[hit & same], rtol=1e-5)


def test_compiled_shadow_matches_brute_force(gpu):
    n = 3000
    v0, e1, e2, tables = bvh_soup(*make_soup(n, seed=7, size=0.5))
    rng = np.random.default_rng(8)
    op_rgb = jnp.asarray(rng.uniform(0.3, 1.0, (n, 3)).astype(np.float32))
    op_a = jnp.asarray(rng.uniform(0.4, 1.0, n).astype(np.float32))
    o, d = make_rays(4096, seed=9)
    dist = jnp.full(4096, 8.0)
    rgb, a = gpu_shadow(o, d, dist, *tables, v0, e1, e2, op_rgb, op_a)
    rgb_ref, a_ref = brute_force_shadow(o, d, dist, v0, e1, e2, op_rgb, op_a)
    live = np.asarray(a_ref) >= 1e-3
    close = np.isclose(np.asarray(a), np.asarray(a_ref), rtol=1e-4, atol=1e-5)
    assert close[live].mean() > 0.999


def test_render_runs_compiled_kernels_on_the_gpu(gpu):
    from rayzath_tpu.engine.engine import pick_device
    from rayzath_tpu.engine.integrator import render_steps
    from rayzath_tpu.engine.state import init_state
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    assert pick_device() == gpu
    w = rz.scenes.teapot_like(64, 64)
    scene, cam = compile_world(w), compile_camera(w.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4, rpp=2))
    args = (scene, cam, cfg, init_state(64, 64), jax.random.key(0), 2)
    hlo = render_steps.lower(*args).as_text()
    assert "triton" in hlo          # the walk is a compiled Triton kernel
    st = render_steps(*args)
    acc = np.asarray(st.accum)
    assert np.isfinite(acc).all() and acc[..., 3].sum() > 0
    assert list(st.accum.devices()) == [gpu]


def test_engine_renders_on_the_gpu(gpu):
    eng = rz.Engine(rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=2)))
    eng.world = rz.scenes.cornell_box(32, 32)
    eng.render_world()
    cv = next(iter(eng.renderer.views.values()))
    assert list(cv.state.accum.devices()) == [gpu]
    assert np.isfinite(np.asarray(cv.state.accum)).all()
