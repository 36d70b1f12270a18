"""Differentiability checks (BASELINE metric 2): jax.grad through the
wavefront integrator vs central finite differences, on tiny scenes.

The RNG is counter-based (fold_in of the pass index), so the same key renders
bit-identical paths — which makes finite differences well-defined except at
discrete decision boundaries (hit ids, BSDF branch lotteries); the scenes and
the parameters perturbed here keep those decisions stable.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayzath_tpu as rz
from rayzath_tpu.models.device_scene import compile_world, compile_camera
from rayzath_tpu.engine.state import init_state
from rayzath_tpu.engine.integrator import render_steps_preserve
from rayzath_tpu.parallel.train import image_loss, training_step, DIFF_PARAMS


def tiny_world(emission=8.0):
    w = rz.World()
    white = w.create_material("white", color=(0.7, 0.6, 0.5, 1.0))
    lamp = w.create_material("lamp", color=(1.0, 0.9, 0.8, 1.0), emission=emission)
    plane = w.generate_mesh("plane", sides=4, width=4.0, height=4.0)
    w.create_instance(name="floor", mesh=plane, materials=[white])
    cube = w.generate_mesh("cube")
    from rayzath_tpu.utils.hostmath import Transform
    w.create_instance(name="glow", mesh=cube, materials=[lamp],
                      transform=Transform(position=(0, 1.2, 0)))
    cam = w.create_camera("cam", position=(0, 1.0, -3.0), resolution=(12, 12),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.5, 0))
    return w


def setup(n_steps=6, max_depth=3):
    w = tiny_world()
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=max_depth, rpp=n_steps))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    state = init_state(12, 12)
    key = jax.random.key(7)
    return scene, cam, cfg, state, key, n_steps


def render_mean_image(scene, cam, cfg, state, key, n):
    st = render_steps_preserve(scene, cam, cfg, state, key, n)
    spp = jnp.maximum(st.accum[..., 3:4], 1.0)
    return st.accum[..., :3] / spp


@pytest.mark.parametrize("param,idx", [
    ("mat_emission", 3),     # the lamp material's emission
    ("mat_color", (2, 0)),   # the white material's red channel
])
def test_grad_matches_finite_difference(param, idx):
    scene, cam, cfg, state, key, n = setup()
    target = jnp.zeros((12, 12, 3))

    def loss_of(value):
        arr = getattr(scene, param)
        s = scene.replace(**{param: arr.at[idx].set(value)})
        return image_loss(s, cam, cfg, state, key, target, n)[0]

    base = float(getattr(scene, param)[idx])
    g = jax.grad(loss_of)(jnp.float32(base))
    eps = 1e-2 if param == "mat_emission" else 1e-3
    fd = (loss_of(base + eps) - loss_of(base - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    assert float(g) != 0.0, "gradient unexpectedly zero"
    assert float(g) == pytest.approx(float(fd), rel=0.05), (
        f"analytic {float(g)} vs finite-diff {float(fd)}")


def test_grad_nonzero_and_finite_for_all_diff_params():
    scene, cam, cfg, state, key, n = setup()
    target = jnp.full((12, 12, 3), 0.1)
    params = {k: getattr(scene, k) for k in DIFF_PARAMS}

    def loss_fn(p):
        return image_loss(scene.replace(**p), cam, cfg, state, key, target, n)[0]

    grads = jax.grad(loss_fn)(params)
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), f"non-finite grad for {k}"
    # materials that light/shade the visible scene must receive signal
    assert float(jnp.abs(grads["mat_emission"]).max()) > 0
    assert float(jnp.abs(grads["mat_color"]).max()) > 0


def test_training_step_descends():
    scene, cam, cfg, state, key, n = setup()
    # target: the same scene with dimmer lamp -> training should reduce emission
    dim = scene.replace(mat_emission=scene.mat_emission.at[3].set(2.0))
    target = render_mean_image(dim, cam, cfg, state, key, n)

    s = scene
    losses = []
    for i in range(8):
        s, _, loss = training_step(s, cam, cfg, state, key, target,
                                   jnp.float32(0.5), n)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, f"no descent: {losses}"
    # emission moved toward the dim target
    assert float(s.mat_emission[3]) < float(scene.mat_emission[3])


def lit_world():
    """Spot + direct light scene with a glossy floor and a blocker (shadow
    rays cross real geometry)."""
    return rz.scenes.lit_blocker(16, 16)


@pytest.mark.parametrize("param,idx,eps", [
    ("spot_emission", 0, 1e-2),
    ("dir_emission", 0, 1e-2),
    ("mat_roughness", 2, 1e-3),   # floor material
    ("mat_metalness", 2, 1e-3),
])
def test_grad_fd_lights_and_surface_params(param, idx, eps):
    """FD validation for the remaining DIFF_PARAMS classes (VERDICT item 6):
    light emissions and surface roughness/metalness."""
    w = lit_world()
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=4))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    state = init_state(16, 16)
    key = jax.random.key(3)
    target = jnp.zeros((16, 16, 3))

    def loss_of(value):
        arr = getattr(scene, param)
        s = scene.replace(**{param: arr.at[idx].set(value)})
        return image_loss(s, cam, cfg, state, key, target, 4)[0]

    base = float(getattr(scene, param)[idx])
    g = jax.grad(loss_of)(jnp.float32(base))
    fd = (loss_of(base + eps) - loss_of(base - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    assert float(g) != 0.0, f"{param} gradient unexpectedly zero"
    assert float(g) == pytest.approx(float(fd), rel=0.07), (
        f"{param}: analytic {float(g)} vs fd {float(fd)}")


def test_grad_fd_atlas_texel():
    """FD validation for a color-atlas texel (textures train through the
    bilinear fetch)."""
    w = rz.scenes.textured_room(16, 12)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=2))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    state = init_state(16, 12)
    key = jax.random.key(9)
    target = jnp.zeros((12, 16, 3))

    def loss_of_atlas(atlas):
        return image_loss(scene.replace(color_atlas=atlas), cam, cfg, state,
                          key, target, 2)[0]

    g = jax.grad(loss_of_atlas)(scene.color_atlas)
    g_np = np.asarray(g)
    assert np.isfinite(g_np).all()
    assert np.abs(g_np).max() > 0
    # FD on the single largest-gradient texel channel
    iy, ix, ic = np.unravel_index(np.argmax(np.abs(g_np)), g_np.shape)
    eps = 1e-2
    up = scene.color_atlas.at[iy, ix, ic].add(eps)
    dn = scene.color_atlas.at[iy, ix, ic].add(-eps)
    fd = (loss_of_atlas(up) - loss_of_atlas(dn)) / (2 * eps)
    assert float(g[iy, ix, ic]) == pytest.approx(float(fd), rel=0.05)


def test_grad_fd_through_cluster_shadow_at_64px():
    """FD check that crosses the shadow walk's custom_vjp at 64^2 image
    scale: the blocker's alpha drives shadow transmission, so dL/d(alpha)
    flows through ops.traverse.shadow's dense replay backward."""
    w = lit_world()
    for c in w.cameras:
        c.resolution = (64, 64)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=2)).with_(
        brute_force_threshold=0)    # every scene walks the BVH
    scene = compile_world(w)
    assert scene.n_triangles > cfg.brute_force_threshold
    cam = compile_camera(w.cameras[0])
    state = init_state(64, 64)
    key = jax.random.key(4)
    target = jnp.zeros((64, 64, 3))
    bi = 3  # blocker material index (world, default, floor, blocker)
    assert abs(float(scene.mat_color[bi, 3]) - 0.55) < 1e-6

    def loss_of(alpha):
        s = scene.replace(mat_color=scene.mat_color.at[bi, 3].set(alpha))
        return image_loss(s, cam, cfg, state, key, target, 2)[0]

    base = 0.55
    g = jax.grad(loss_of)(jnp.float32(base))
    eps = 2e-3
    fd = (loss_of(base + eps) - loss_of(base - eps)) / (2 * eps)
    assert np.isfinite(float(g)) and float(g) != 0.0
    assert float(g) == pytest.approx(float(fd), rel=0.05), (
        f"alpha: analytic {float(g)} vs fd {float(fd)}")


def test_grad_fd_ior():
    """FD validation for mat_ior (VERDICT item 6). The ior reaches radiance
    smoothly through the fresnel -> reflectance -> BRDF/NEE weights (the
    straight-through TIR relaxation supplies the boundary gradient); the
    branch lotteries it also shifts are discrete, so both sides average over
    keys and the comparison is Monte Carlo vs Monte Carlo."""
    w = rz.scenes.multi_light(16, 12)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=4))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    state = init_state(16, 12)
    target = jnp.zeros((12, 16, 3))
    idx = int(np.argwhere(np.asarray(scene.mat_ior) > 1.2)[0, 0])
    base = float(scene.mat_ior[idx])

    def loss_of(v, key):
        s = scene.replace(mat_ior=scene.mat_ior.at[idx].set(v))
        return image_loss(s, cam, cfg, state, key, target, 4)[0]

    lg = jax.jit(jax.value_and_grad(loss_of))
    lj = jax.jit(loss_of)
    keys = [jax.random.key(50 + i) for i in range(8)]
    g = float(np.mean([float(lg(jnp.float32(base), k)[1]) for k in keys]))
    eps = 0.05
    fd = float(np.mean([(float(lj(jnp.float32(base + eps), k))
                         - float(lj(jnp.float32(base - eps), k))) / (2 * eps)
                        for k in keys]))
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.3), f"ior: analytic {g} vs fd {fd}"


def foggy_world():
    """Camera inside a scattering WORLD medium over an emissive floor: every
    camera ray free-flights against the medium, so the scatter-vs-survive
    event probability drives the image directly."""
    w = rz.World()
    w.material.scattering = 0.8        # the sky/world medium is the fog
    w.material.emission = 0.4
    glow = w.create_material("glow", color=(1.0, 1.0, 1.0, 1.0), emission=5.0)
    plane = w.generate_mesh("plane", sides=4, width=6.0, height=6.0)
    w.create_instance(name="floor", mesh=plane, materials=[glow])
    cam = w.create_camera("cam", position=(0, 1.2, -2.0), resolution=(8, 8),
                          aperture=0.01, exposure_time=1.0)
    cam.look_at((0, 0.0, 0.5))
    return w


def test_grad_fd_scattering_score_function():
    """FD validation for mat_scattering (VERDICT item 6). The scatter event
    is DISCRETE, so the score-function surrogate's gradient equals the
    derivative of the EXPECTED radiance (a linear functional of the path
    outcomes); both sides are Monte-Carlo averaged over many keys. (For a
    NONLINEAR objective at low spp — e.g. per-pixel squared error over 4
    passes — E[g(S)] and g(E[S]) genuinely differ and no pathwise/score
    estimator of either matches finite differences of the other; the
    mismatch decays as samples accumulate.)"""
    w = foggy_world()
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=4, rpp=4))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    state = init_state(8, 8)
    idx = 0  # WORLD_MATERIAL_ID: the world medium is the fog
    assert float(scene.mat_scattering[idx]) == pytest.approx(0.8)

    def radiance(v, key):
        s = scene.replace(mat_scattering=scene.mat_scattering.at[idx].set(v))
        st = render_steps_preserve(s, cam, cfg, state, key, 4)
        return jnp.mean(st.accum[..., :3])

    lg = jax.jit(jax.value_and_grad(radiance))
    lj = jax.jit(radiance)
    keys = [jax.random.key(1000 + i) for i in range(32)]
    g = float(np.mean([float(lg(jnp.float32(0.8), k)[1]) for k in keys]))
    eps = 0.15
    fd = float(np.mean([(float(lj(jnp.float32(0.8 + eps), k))
                         - float(lj(jnp.float32(0.8 - eps), k))) / (2 * eps)
                        for k in keys]))
    assert np.isfinite(g) and g != 0.0
    assert g == pytest.approx(fd, rel=0.15), (
        f"scattering: score-function {g} vs multi-key fd {fd}")
