"""Instanced worlds: every instance's mesh is expanded into the world-space
triangle soup (one flattened BVH; the reference walks a TLAS over instances
and a BLAS per mesh, cuda_bvh.cuh:114-171 + cuda_instance.cuh:167-264).
Gradients, picking and per-instance edits must work on the expansion.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayzath_tpu as rz
from rayzath_tpu.models.device_scene import compile_world, compile_camera
from rayzath_tpu.engine.state import init_state


@pytest.fixture(scope="module")
def instanced():
    """textured_room: three instances share one sphere mesh."""
    w = rz.scenes.textured_room(48, 32)
    return w, compile_world(w)


def test_instanced_world_compiles_to_expanded_soup(instanced):
    w, soup = instanced
    live = [i for i in w.instances if i.mesh is not None]
    balls = [i for i in live if i.name.startswith("ball")]
    assert len(balls) >= 2 and len({id(i.mesh) for i in balls}) == 1
    # one copy of the shared mesh per instance
    assert soup.n_triangles == sum(i.mesh.triangle_count for i in live)
    # every instance's triangles carry its own instance id
    inst = np.asarray(soup.tri_inst)[:soup.n_triangles]
    for gi, i in enumerate(w.instances):
        if i in balls:
            assert (inst == gi).sum() == i.mesh.triangle_count


def test_two_level_gradients_flow(instanced):
    w, soup = instanced
    from rayzath_tpu.parallel.train import image_loss
    cam = compile_camera(w.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=1))
    state = init_state(48, 32)
    key = jax.random.key(7)
    target = jnp.full((32, 48, 3), 0.1)
    params = {k: getattr(soup, k) for k in ("mat_color", "mat_roughness")}

    def loss_fn(p):
        return image_loss(soup.replace(**p), cam, cfg, state, key, target, 1)[0]

    grads = jax.grad(loss_fn)(params)
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), f"non-finite grad {k}"
    assert float(jnp.abs(grads["mat_color"]).max()) > 0


def test_picking_resolves_instances(instanced):
    w, soup = instanced
    r = rz.Renderer(w, rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=4)))
    r.render(rpp=4)  # depth buffer fills on the first camera segment (pass 2)
    cam = w.cameras[0]
    found = set()
    for x in range(4, 48, 8):
        for y in range(4, 32, 8):
            inst, mat = r.pick(cam, x, y)
            if inst >= 0:
                found.add(inst)
    assert len(found) >= 2, f"picking saw only {found}"
    assert all(0 <= i < len(w.instances) for i in found)


def test_moving_one_instance_only_moves_it():
    """Editing one instance's transform moves exactly that instance's
    triangles in the soup; every other instance keeps its geometry."""
    w = rz.scenes.textured_room(48, 32)
    a = compile_world(w)
    from rayzath_tpu.utils.hostmath import Transform
    gi, ball = next((k, i) for k, i in enumerate(w.instances)
                    if i.name == "ball 1")
    ball.transform = Transform(position=(0.5, 0.9, -0.5),
                               scale=ball.transform.scale)
    b = compile_world(w)
    assert a.n_triangles == b.n_triangles

    def per_instance(scene):
        inst = np.asarray(scene.tri_inst)[:scene.n_triangles]
        v0 = np.asarray(scene.tri_v0)[:scene.n_triangles]
        return {i: np.sort(v0[inst == i], axis=0) for i in np.unique(inst)}

    pa, pb = per_instance(a), per_instance(b)
    assert pa.keys() == pb.keys()
    for i in pa:
        if i == gi:
            assert not np.allclose(pa[i], pb[i])
        else:
            np.testing.assert_array_equal(pa[i], pb[i])
