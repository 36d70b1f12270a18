"""Renderer features: autofocus, multi-device sharded rendering equivalence."""
import numpy as np
import jax

import rayzath_tpu as rz
from rayzath_tpu.models.device_scene import compile_world, compile_camera
from rayzath_tpu.engine.state import init_state
from rayzath_tpu.engine.integrator import render_steps
from rayzath_tpu.parallel import make_mesh, sharded_render_steps


def test_autofocus_sets_focal_distance_from_depth():
    w = rz.scenes.cornell_box(32, 32)
    r = rz.Renderer(w)
    r.render(rpp=2)
    cam = w.cameras[0]
    old_version = cam.version
    depth = r.depth(cam)[16, 16]  # read before focus: focus dirties the view
    assert depth > 0
    fd = r.focus(cam, 16, 16)
    assert np.isclose(fd, depth, rtol=1e-5)
    assert cam.focal_distance == fd
    assert cam.focal_point == (16, 16)
    assert cam.version > old_version  # focus dirties the camera


def test_sharded_render_matches_single_device():
    n = len(jax.devices())
    assert n >= 2, "conftest forces an 8-device CPU mesh"
    W = H = 16
    world = rz.scenes.cornell_box(W, H)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4, rpp=4))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(7)

    single = render_steps(scene, cam, cfg, init_state(W, H), key, 4)
    mesh = make_mesh(jax.devices())
    sharded = sharded_render_steps(scene, cam, cfg, init_state(W, H), key, 4,
                                   mesh)
    np.testing.assert_allclose(np.asarray(sharded.accum),
                               np.asarray(single.accum), rtol=2e-4, atol=1e-4)
    # the accumulation image really is row-sharded across the mesh
    shard_shapes = {s.data.shape for s in sharded.accum.addressable_shards}
    assert shard_shapes == {(H // n, W, 4)}


def test_scaling_harness_runs():
    from rayzath_tpu.parallel.scaling import measure_scaling, format_report
    res = measure_scaling(n_devices_list=[1, 2], rpp=2, size=16, max_depth=2,
                          repeats=1)
    assert [r["n"] for r in res] == [1, 2]
    assert all(r["rays_per_s"] > 0 for r in res)
    assert res[0]["efficiency"] == 1.0
    report = format_report(res)
    assert "efficiency" in report and "Mrays/s" in report


def test_render_steps_donates_state():
    """The hot-path entry donates the input state (no double-buffered HBM);
    the preserve twin keeps it alive for repeated loss probes."""
    import jax
    from rayzath_tpu.engine.integrator import render_steps_preserve
    w = rz.scenes.cornell_box(16, 16)
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=1))
    key = jax.random.key(0)

    st_in = init_state(16, 16)
    out = render_steps_preserve(scene, cam, cfg, st_in, key, 1)
    assert not st_in.accum.is_deleted()
    out2 = render_steps(scene, cam, cfg, st_in, key, 1)
    assert st_in.accum.is_deleted(), "donating entry left the input alive"
    np.testing.assert_allclose(np.asarray(out.accum), np.asarray(out2.accum))


def test_sharded_two_level_keeps_pallas_kernels():
    """Sharded instanced render matches single device: shard_map runs the
    full integrator, BVH-walk kernels included, per device on an instanced
    world expanded to the soup — identical to a single-device render thanks
    to the row-keyed RNG."""
    n = len(jax.devices())
    W = H = 16
    world = rz.scenes.textured_room(W, H)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=2))
    scene = compile_world(world)
    assert scene.n_instances > 1
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(11)

    single = render_steps(scene, cam, cfg, init_state(W, H), key, 2)
    mesh = make_mesh(jax.devices())
    sharded = sharded_render_steps(scene, cam, cfg, init_state(W, H), key, 2,
                                   mesh)
    np.testing.assert_allclose(np.asarray(sharded.accum),
                               np.asarray(single.accum), rtol=2e-4, atol=1e-4)
    shard_shapes = {s.data.shape for s in sharded.accum.addressable_shards}
    assert shard_shapes == {(H // n, W, 4)}


def test_sharded_training_step_matches_single_device():
    """training_step over a mesh runs the integrator (walk kernels included)
    per device under shard_map and sums loss and gradients over the rows:
    same loss and same updated parameters as one device."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rayzath_tpu.parallel import replicate_scene, shard_state, training_step
    W = H = 16
    world = rz.scenes.cornell_box(W, H)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=2))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(3)
    target = jax.numpy.full((H, W, 3), 0.1)
    lr = jax.numpy.float32(0.1)
    s1, _, l1 = training_step(scene, cam, cfg, init_state(W, H), key, target,
                              lr, 2)
    mesh = make_mesh(jax.devices())
    s8, st8, l8 = training_step(
        replicate_scene(scene, mesh), replicate_scene(cam, mesh), cfg,
        shard_state(init_state(W, H), mesh), key,
        jax.device_put(target, NamedSharding(mesh, P("rays"))), lr, 2,
        mesh=mesh)
    assert abs(float(l8) - float(l1)) <= 1e-5 * abs(float(l1))
    np.testing.assert_allclose(np.asarray(s8.mat_color),
                               np.asarray(s1.mat_color), rtol=1e-5, atol=1e-7)
    shard_shapes = {s.data.shape for s in st8.accum.addressable_shards}
    assert shard_shapes == {(H // len(jax.devices()), W, 4)}
