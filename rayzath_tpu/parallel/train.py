"""Differentiable (inverse-rendering) training step.

The new-capability analog of "training" for a renderer (SURVEY.md §7.1): render
with the current scene parameters, compare against a target image, and descend
on material properties / texture atlases. Gradients flow through the wavefront
integrator (discrete hit ids are stop-gradient; hit coordinates are re-derived
differentiably — engine/integrator.py). Given a device mesh, the step runs
under ``shard_map`` like parallel.mesh's render: each device renders its
block of image rows (the BVH walk's kernels included) with the scene
replicated, and the loss and parameter gradients are summed over the 'rays'
axis.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax.sharding import PartitionSpec as P

from ..engine.integrator import _render_steps_impl, render_steps_preserve
from ..engine.state import RenderState

# Scene leaves that receive gradients — every entry is finite-difference
# validated in tests/test_gradients.py (material color/emission directly;
# roughness/metalness/spot/direct emission via test_grad_fd_lights_and_
# surface_params; atlas texels via test_grad_fd_atlas_texel; shadow-opacity
# alpha through the shadow walk's custom_vjp at 64^2 via
# test_grad_fd_through_cluster_shadow_at_64px).
#
# ``mat_ior`` and ``mat_scattering`` carry dedicated estimators for their
# discrete decision boundaries (tests/test_gradients.py validates both):
# * ior: the total-internal-reflection branch switches discontinuously; the
#   fresnel value is straight-through with a sigmoid-relaxed TIR indicator
#   supplying the gradient (ops/vec.py fresnel_specular_ratio; anneal
#   ops.vec.TIR_TAU toward 0 over a training run).
# * scattering: the free-flight scatter-vs-survive DECISION is handled by a
#   score-function likelihood-ratio surrogate on the throughput (forward
#   value exactly 1; engine/integrator.py bounce_step) — the pathwise
#   gradient alone is blind to event-probability changes.
DIFF_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "mat_emission",
               "mat_ior", "mat_scattering",
               "color_atlas", "scalar_atlas", "spot_emission", "dir_emission")


def image_loss(scene, cam, cfg, state: RenderState, key, target, n_steps: int):
    """MSE between the mean accumulated radiance and a target HDR image."""
    # preserve the caller's state: losses are probed repeatedly from the same
    # initial state (finite differences, line searches); donation would free it
    st = render_steps_preserve(scene, cam, cfg, state, key, n_steps)
    spp = jnp.maximum(st.accum[..., 3:4], 1.0)
    img = st.accum[..., :3] / spp
    return jnp.mean(jnp.square(img - target)), st


@partial(jax.jit, static_argnames=("cfg", "n_steps", "mesh"))
def training_step(scene, cam, cfg, state: RenderState, key, target,
                  lr, n_steps: int, mesh=None):
    """One SGD step on the differentiable scene parameters.

    Returns (updated scene, post-render state, scalar loss). ``state`` should
    be a fresh init_state each step (paths restart) unless continuing a
    progressive estimate on purpose. With ``mesh`` (1-D, axis 'rays'), state
    and target are split into row blocks over its devices (height divisible
    by the device count).
    """
    params = {k: getattr(scene, k) for k in DIFF_PARAMS}
    if mesh is None:
        def loss_fn(p):
            return image_loss(scene.replace(**p), cam, cfg, state, key,
                              target, n_steps)

        (loss, st), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    else:
        loss, st, grads = _sharded_loss_and_grads(scene, cam, cfg, state, key,
                                                  target, n_steps, mesh,
                                                  params)
    new_params = {k: _project(k, params[k] - lr * grads[k]) for k in params}
    return scene.replace(**new_params), st, loss


def _sharded_loss_and_grads(scene, cam, cfg, state, key, target, n_steps,
                            mesh, params):
    from .mesh import RAYS_AXIS, _state_pspecs
    n_pix = state.height * state.width * 3
    h_local = state.height // mesh.devices.size
    state_spec = _state_pspecs(state)
    rep = jax.tree.map(lambda _: P(), (scene, cam, params))

    def local(scene, cam, params, st, key, target):
        # rows [row0, row0 + h_local): the row-keyed RNG makes them the
        # same rays as in a single-device step
        row0 = jax.lax.axis_index(RAYS_AXIS) * h_local
        st = st.replace(height=h_local)

        def loss_fn(p):
            out = _render_steps_impl(scene.replace(**p), cam, cfg, st, key,
                                     n_steps, row0=row0)
            img = out.accum[..., :3] / jnp.maximum(out.accum[..., 3:4], 1.0)
            return jnp.sum(jnp.square(img - target)) / n_pix, out

        (part, out), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        total = jax.lax.psum((part, g), RAYS_AXIS)
        return total[0], out.replace(height=state.height), total[1]

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(rep[0], rep[1], rep[2], state_spec, P(), P(RAYS_AXIS)),
        out_specs=(P(), state_spec, rep[2]), check_vma=False,
    )(scene, cam, params, state, key, target)


_UNIT_PARAMS = ("mat_color", "mat_metalness", "mat_roughness", "color_atlas")


def _project(name: str, value):
    """Projected SGD: keep parameters in their physical ranges (a step that
    leaves them — negative emission, roughness outside [0,1] — produces
    non-physical radiance and can diverge to NaN)."""
    if name in _UNIT_PARAMS:
        return jnp.clip(value, 0.0, 1.0)
    if name == "mat_ior":
        # refractive indices below 1 are non-physical for these media
        return jnp.maximum(value, 1.0)
    return jnp.maximum(value, 0.0)
