"""Wavefront path-tracing integrator (JAX, differentiable).

Wavefront redesign of the reference CUDA megakernel
(RayZath/cuda_render_kernel.cu:7-355): instead of one persistent thread per
pixel, the whole wavefront of R = W*H rays advances ONE bounce per
``bounce_step`` over SoA buffers; terminated paths regenerate camera rays
in place, so every step is fully occupied regardless of depth divergence
(the reference's own regeneration-in-place strategy, cuda_render_kernel.cu:50-65).

Behavioral spec kept bit-compatible with the CUDA path (the "GPU semantics" of
SURVEY.md §2.4): Beer's-law absorption (cuda_render_kernel.cu:162-176),
exponential scattering media (cuda_material.cuh:141-159), the uber-material
BSDF with its custom NDF + attenuation (cuda_material.cuh:162-301), NEE with
MIS power weights for spot + direct lights (cuda_render_kernel.cu:239-355),
sky-sphere environment (cuda_world.cuh:121-126).

RNG is stateless and counter-based: uniforms for (pass, bounce) come from
``fold_in(key, pass * MAX + bounce)``, which makes forward and gradient-replay
passes bit-identical — the property path-replay backprop requires (the
reference's chaotic per-frame-seeded RNG, cuda_render_parts.cuh:858-883, is
deliberately NOT reproduced).

Differentiation strategy: discrete hit ids from traversal are constants
(stop_gradient); (t, b1, b2) are re-derived differentiably from the ids via
``refine_hit``. The bounce loop is a ``lax.scan`` with optional rematerialization,
so ``jax.grad`` flows to material parameters, textures, and light emission.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.device_scene import DeviceScene, DeviceCamera, WORLD_MATERIAL_ID
from ..ops import camera as cam_ops
from ..ops import texture as tex_ops
from ..ops.gather import gather_rows
from ..ops.intersect import (project_closest, project_shadow, refine_hit,
                             refine_tri)
from ..ops.sort_rays import sort_payload, unsort_payload
from ..ops import traverse
from ..ops.vec import (dot, normalize, lerp, reflect, halfway,
                       cosine_sample_hemisphere, sample_sphere, sample_hemisphere,
                       sample_disk, fresnel_specular_ratio, cross)
from .config import RenderConfig
from .state import RenderState, BIG, PATH_LIMIT

NO_MAP = -1


# ---------------------------------------------------------------------------
# material fetch
# ---------------------------------------------------------------------------

class MatProps(NamedTuple):
    color_rgb: jnp.ndarray   # [R,3] color * texture rgb ("opacity color" rgb)
    alpha_op: jnp.ndarray    # [R] (1 - alpha) * (1 - tex alpha): 0 = opaque
    metalness: jnp.ndarray   # [R]
    roughness: jnp.ndarray   # [R]
    emission: jnp.ndarray    # [R]
    ior: jnp.ndarray         # [R]
    scattering: jnp.ndarray  # [R]
    normal_map: jnp.ndarray  # [R] i32 map id (-1 none)


def mat_pack(scene: DeviceScene) -> jnp.ndarray:
    """[M,14] packed material rows, built in-jit from the editable/trainable
    SoA leaves (gradients and live edits flow through the concat): color 0:4,
    metalness 4, roughness 5, emission 6, ior 7, scattering 8, maps 9:14.
    One [R]-row gather of this table replaces seven separate gathers."""
    return jnp.concatenate([
        scene.mat_color,
        scene.mat_metalness[:, None], scene.mat_roughness[:, None],
        scene.mat_emission[:, None], scene.mat_ior[:, None],
        scene.mat_scattering[:, None],
        scene.mat_maps.astype(jnp.float32)], axis=1)


def material_fetch(scene: DeviceScene, mp, mat_id, texcrd) -> MatProps:
    """Fetch material properties at a surface point (reference
    Material::color/emission/metalness/roughness with maps,
    cuda_material.cuh:70-123). ``mp`` is the scene's mat_pack table."""
    mid = jnp.clip(mat_id, 0, scene.n_materials - 1)
    row = gather_rows(mp, mid)
    rgb = row[:, 0:3]
    alpha_op = 1.0 - row[:, 3]
    metal = row[:, 4]
    rough = row[:, 5]
    emis = row[:, 6]
    maps = jnp.rint(row[:, 9:14]).astype(jnp.int32)
    if scene.has_maps:
        tex_id, nrm_id, met_id, rgh_id, emi_id = (maps[:, k] for k in range(5))
        used = scene.map_kinds_used  # static: skip whole fetch per kind
        if used[0]:
            tex = tex_ops.fetch_scene(scene, tex_id, texcrd, atlas=0)
            has_t = (tex_id >= 0)[:, None]
            rgb = jnp.where(has_t, rgb * tex[:, :3], rgb)
            alpha_op = jnp.where(tex_id >= 0,
                                 alpha_op * (1.0 - tex[:, 3]), alpha_op)
        if used[2]:
            met_v = tex_ops.fetch_scene(scene, met_id, texcrd, atlas=1)[:, 0]
            metal = jnp.where(met_id >= 0, met_v, metal)
        if used[3]:
            rgh_v = tex_ops.fetch_scene(scene, rgh_id, texcrd, atlas=1)[:, 0]
            rough = jnp.where(rgh_id >= 0, rgh_v, rough)
        if used[4]:
            emi_v = tex_ops.fetch_scene(scene, emi_id, texcrd, atlas=1)[:, 0]
            emis = jnp.where(emi_id >= 0, emis * emi_v, emis)
        normal_map = nrm_id if used[1] else jnp.full_like(mid, NO_MAP)
    else:
        normal_map = jnp.full_like(mid, NO_MAP)
    return MatProps(rgb, alpha_op, metal, rough, emis,
                    row[:, 7], row[:, 8], normal_map)


# ---------------------------------------------------------------------------
# intersection dispatch (brute force for small scenes, BVH otherwise)
# ---------------------------------------------------------------------------

TILE = 32  # image tile side


def _tileable(hw, r: int) -> bool:
    return (hw is not None and hw[0] % TILE == 0 and hw[1] % TILE == 0
            and hw[0] * hw[1] == r)


def _tile(x, hw):
    """Permute row-major rays into 32x32 image tiles (reshape/transpose only —
    no gathers). Consecutive rays then cover a narrow frustum instead of
    whole image rows, so neighbouring rays walk similar subtrees."""
    h, w = hw
    t = TILE
    rest = x.shape[1:]
    x = x.reshape((h // t, t, w // t, t) + rest)
    return x.transpose((0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))).reshape(
        (h * w,) + rest)


def _untile(x, hw):
    h, w = hw
    t = TILE
    rest = x.shape[1:]
    x = x.reshape((h // t, w // t, t, t) + rest)
    return x.transpose((0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))).reshape(
        (h * w,) + rest)


def _sort_traversal(cfg: RenderConfig, scene: DeviceScene) -> bool:
    """Effective ray-sort decision. None = auto: sort with the payload radix
    sort (ops/sort_rays.sort_payload) when the BVH has enough leaves that an
    incoherent bounce wavefront would spread over many of them — about the
    scale of 2k triangles. Small scenes rely on 32x32 image tiling only."""
    if cfg.ray_sort is not None:
        return cfg.ray_sort
    return scene.n_leaves >= 256


def _run_coherent(cfg: RenderConfig, hw, o, d, extras, run, sort=False):
    """Run a traversal on a coherence-maximized ray order.

    ``run(o, d, *extras) -> tuple of per-ray arrays``. With ``sort``: order
    rays by the Morton-major spatial-directional key (ops/sort_rays.py) and
    scatter results back, so neighbouring rays walk similar subtrees even
    for incoherent bounce wavefronts. Otherwise: 32x32 image tiling, which
    helps the primary-dominated passes for free."""
    if sort:
        o_s, d_s, extras_s, idx_s = sort_payload(o, d, extras)
        outs = run(o_s, d_s, *extras_s)
        return unsort_payload(idx_s, outs)
    if _tileable(hw, o.shape[0]):
        outs = run(_tile(o, hw), _tile(d, hw), *[_tile(e, hw) for e in extras])
        return tuple(_untile(x, hw) for x in outs)
    return run(o, d, *extras)


def closest_hit(scene: DeviceScene, cfg: RenderConfig, o, d, near, far,
                hw=None):
    """Returns (t, tri_id, b1, b2, external, tp); ids are stop-gradient,
    (t,b1,b2) re-derived differentiably (path-replay). ``tp`` is the hit's
    packed attribute row ([R,32], see DeviceScene.tri_pack) — gathered once
    here so callers never re-gather per-attribute."""
    if scene.n_triangles <= cfg.brute_force_threshold:
        t, tid = project_closest(o, d, near, far, scene.tri_pw, scene.tri_pc,
                                 chunk=min(cfg.chunk, scene.tri_v0.shape[0]))
    else:
        t, tid = _run_coherent(
            cfg, hw, o, d, (near, far),
            lambda o, d, near, far: traverse.closest(
                o, d, near, far, scene.aabb_links, scene.node_begin,
                scene.node_count, scene.tri_v0, scene.tri_e1, scene.tri_e2),
            sort=_sort_traversal(cfg, scene))
    tid = jax.lax.stop_gradient(tid)
    tp = gather_rows(scene.tri_pack, jnp.maximum(tid, 0))
    t_r, b1_r, b2_r, det = refine_tri(o, d, tp[:, 0:3], tp[:, 3:6],
                                      tp[:, 6:9])
    ext = jax.lax.stop_gradient(det > 0.0)
    hit_mask = tid >= 0
    t = jnp.where(hit_mask, t_r, jax.lax.stop_gradient(t))
    b1 = jnp.where(hit_mask, b1_r, 0.0)
    b2 = jnp.where(hit_mask, b2_r, 0.0)
    return t, tid, b1, b2, ext, tp


def texture_shadow_factor(scene: DeviceScene, o, d, dist, chunk: int = 512):
    """Texture part of the transmission-filtered shadow mask.

    The reference fetches the material's TEXTURE at every shadow-ray hit
    (cuda_instance.cuh:92-164; per-hit factor = opacityColor(texcrd) =
    (base_rgb * tex_rgb, (1-alpha) * (1-tex_alpha)), cuda_material.cuh:86-95).
    That product factorizes: the traversal kernels already accumulate the
    constant material part over ALL hits; this dense pass over the small
    "cutout" set (triangles whose material has a texture AND alpha < 1 —
    precomputed at scene compile) multiplies in the texture part
    (tex_rgb, 1 - tex_alpha) at each hit's interpolated texcrd. Fully
    differentiable — gradients flow into the color atlas (trainable cutouts).

    Deviation noted: the reference's alpha<1e-4 early-out stops its product
    mid-walk; here both factors always complete. The results differ only
    where the mask is already ~0 (the light term vanishes either way)."""
    c_total = scene.cut_pw.shape[1] // 3
    c = min(chunk, c_total)
    n_chunks = -(-c_total // c)
    cp = n_chunks * c
    # pad tables to a chunk multiple with never-hit frames (w = 0,
    # c = (-1, -1, 1): b1 = -1 invalidates padded slots for every ray)
    pw = jnp.pad(scene.cut_pw.reshape(3, 3, c_total),
                 ((0, 0), (0, 0), (0, cp - c_total)))
    pc = jnp.pad(scene.cut_pc.reshape(3, c_total), ((0, 0), (0, cp - c_total)))
    pc = pc.at[0, c_total:].set(-1.0).at[1, c_total:].set(-1.0)
    pc = pc.at[2, c_total:].set(1.0)
    ct0 = jnp.pad(scene.cut_t0, ((0, cp - c_total), (0, 0)))
    ct1 = jnp.pad(scene.cut_t1, ((0, cp - c_total), (0, 0)))
    ct2 = jnp.pad(scene.cut_t2, ((0, cp - c_total), (0, 0)))
    cmap = jnp.pad(scene.cut_map, (0, cp - c_total))

    def block(i0, rgb, a):
        w = jax.lax.dynamic_slice_in_dim(pw, i0, c, 2).reshape(3, 3 * c)
        cc = jax.lax.dynamic_slice_in_dim(pc, i0, c, 1).reshape(3 * c)
        hi = jax.lax.Precision.HIGHEST
        ol = jnp.matmul(o, w, precision=hi) + cc            # [R, 3c]
        dl = jnp.matmul(d, w, precision=hi)
        ox_, oy_, oz_ = ol[:, :c], ol[:, c:2 * c], ol[:, 2 * c:]
        dx_, dy_, dz_ = dl[:, :c], dl[:, c:2 * c], dl[:, 2 * c:]
        dz_ = dz_ + jnp.where(jnp.abs(dz_) < 1e-7, 1e-7, 0.0)
        t = -oz_ / dz_
        b1 = ox_ + t * dx_
        b2 = oy_ + t * dy_
        valid = ((b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
                 & (t > 0.0) & (t < dist[:, None]))          # [R, c]
        t0 = jax.lax.dynamic_slice_in_dim(ct0, i0, c, 0)
        t1 = jax.lax.dynamic_slice_in_dim(ct1, i0, c, 0)
        t2 = jax.lax.dynamic_slice_in_dim(ct2, i0, c, 0)
        uv = (t0[None] + b1[..., None] * (t1 - t0)[None]
              + b2[..., None] * (t2 - t0)[None])             # [R, c, 2]
        mid = jnp.broadcast_to(
            jax.lax.dynamic_slice_in_dim(cmap, i0, c, 0)[None], valid.shape)
        tex = tex_ops.fetch_scene(scene, mid.reshape(-1),
                                  uv.reshape(-1, 2),
                                  atlas=0).reshape(valid.shape + (4,))
        fac_rgb = jnp.where(valid[..., None], tex[..., :3], 1.0)
        fac_a = jnp.where(valid, 1.0 - tex[..., 3], 1.0)
        return rgb * jnp.prod(fac_rgb, axis=1), a * jnp.prod(fac_a, axis=1)

    rgb = jnp.ones((o.shape[0], 3), jnp.float32)
    a = jnp.ones(o.shape[0], jnp.float32)
    if n_chunks == 1:
        return block(0, rgb, a)

    def body(carry, i):
        return block(i * c, *carry), None

    (rgb, a), _ = jax.lax.scan(body, (rgb, a), jnp.arange(n_chunks))
    return rgb, a


def shadow_test(scene: DeviceScene, cfg: RenderConfig, o, d, dist, hw=None):
    """Transmission-filtered visibility (reference World::anyIntersection).

    The traversal kernels accumulate constant material opacity over all hits;
    :func:`texture_shadow_factor` multiplies in the texture term for the
    cutout set (texture-alpha-filtered shadows, cuda_instance.cuh:92-164)."""
    if scene.n_cutout:
        base_rgb, base_a = _shadow_core(scene, cfg, o, d, dist, hw)
        tex_rgb, tex_a = texture_shadow_factor(scene, o, d, dist)
        return base_rgb * tex_rgb, base_a * tex_a
    return _shadow_core(scene, cfg, o, d, dist, hw)


def _shadow_core(scene: DeviceScene, cfg: RenderConfig, o, d, dist, hw=None):
    op_rgb = scene.mat_color[scene.tri_mat][:, :3]
    op_a = 1.0 - scene.mat_color[scene.tri_mat][:, 3]
    if scene.n_triangles <= cfg.brute_force_threshold:
        return project_shadow(o, d, dist, scene.tri_pw, scene.tri_pc,
                              op_rgb, op_a,
                              chunk=min(cfg.chunk, scene.tri_v0.shape[0]))
    return _run_coherent(
        cfg, hw, o, d, (dist,),
        lambda o, d, dist: traverse.shadow(
            o, d, dist, scene.aabb_links, scene.node_begin, scene.node_count,
            scene.tri_v0, scene.tri_e1, scene.tri_e2, op_rgb, op_a),
        sort=_sort_traversal(cfg, scene))


# ---------------------------------------------------------------------------
# BSDF (reference cuda_material.cuh:162-301)
# ---------------------------------------------------------------------------

def brdf_eval(d_in, mapped_normal, surface_scattering, roughness, alpha_op,
              reflectance, vpl):
    """The reference BRDF (cuda_material.cuh:162-182). ``vpl`` must be unit."""
    is_scatter = surface_scattering > 0.0
    n_dot_o = dot(mapped_normal, vpl)
    n_dot_i = dot(mapped_normal, -d_in)
    vh = halfway(d_in, vpl)
    # clip: both vectors are unit only to rsqrt accuracy, and an
    # approximate rsqrt can push |n_dot_h| past 1.00005 — then b crosses
    # zero for roughness 0 (mirrors) and ndf becomes inf, which turns the
    # MIS weight vs_pdf/(vs_pdf + l_pdf) into NaN
    n_dot_h = jnp.clip(dot(mapped_normal, vh), -1.0, 1.0)
    b = n_dot_h * n_dot_h * (roughness - 1.0) + 1.0001
    ndf = (roughness + 1e-5) / (b * b)

    def att(c):
        # clamp to >= 0 so the denominator can't cross zero for backfacing
        # directions: the result is masked below, but an inf/NaN in the
        # unselected branch still poisons gradients (0 * inf = NaN in the
        # where() backward pass). Denominator floored at 1e-7 (not 1e-20):
        # backward squares these factors, and 1e-20 floors produce ~1e40
        # intermediates that overflow to inf in f32 gradients.
        c = jnp.maximum(c, 0.0)
        return c / (c * (1.0 - roughness) + roughness + 1e-7)

    attenuation = att(n_dot_i) * att(n_dot_o)
    diffuse = n_dot_o * (alpha_op == 0.0)
    specular = ndf * attenuation / jnp.maximum(n_dot_i * n_dot_o, 1e-7)
    val = lerp(diffuse, specular * n_dot_o, reflectance)
    val = jnp.where((n_dot_o <= 0.0) | (n_dot_i <= 0.0), 0.0, val)
    return jnp.where(is_scatter, 1.0, val)


def sample_direction(d_in, normal, mapped_normal, mat: MatProps,
                     surf_scattering, fresnel, reflectance, refr_ratio, refr_b,
                     u_r1, u_r2, u_lottery):
    """Importance-sample the next direction (reference
    Material::sampleDirection, cuda_material.cuh:203-301).

    Returns (next_dir, tint_factor, refracted, nudge_normal_sign).
    """
    def flip_above(v, n):
        c = dot1(n, v)
        return jnp.where(c < 0.0, v - 2.0 * c * n, v)

    def dot1(a, b):
        return jnp.sum(a * b, axis=-1, keepdims=True)

    # 1) scattering medium event or transmissive surface in a scattering material
    scatter_dir = sample_sphere(u_r1, u_r2, d_in)

    # 2) transmission (refract or fresnel-reflect)
    refr_dir = d_in * refr_ratio[:, None] + mapped_normal * refr_b[:, None]
    refl_m = flip_above(reflect(d_in, mapped_normal), normal)
    take_refr = fresnel < u_lottery
    trans_dir = jnp.where(take_refr[:, None], refr_dir, refl_m)
    trans_tint = jnp.where(take_refr, 1.0, mat.metalness)

    # 3) diffuse
    diff_dir = flip_above(cosine_sample_hemisphere(u_r1, u_r2, mapped_normal), normal)

    # 4) glossy
    vh = sample_hemisphere(u_r1, 1.0 - jnp.power(u_r2 + 1e-5, mat.roughness),
                           mapped_normal)
    gloss_dir = flip_above(reflect(d_in, vh), normal)

    is_trans = mat.alpha_op > 0.0
    is_scat = is_trans & (surf_scattering > 0.0)
    is_diffuse = ~is_trans & (u_lottery > reflectance)

    next_dir = jnp.where(is_scat[:, None], scatter_dir,
                jnp.where(is_trans[:, None], trans_dir,
                 jnp.where(is_diffuse[:, None], diff_dir, gloss_dir)))
    tint = jnp.where(is_scat, mat.metalness,
            jnp.where(is_trans, trans_tint,
             jnp.where(is_diffuse, 1.0, mat.metalness)))
    refracted = is_trans & ~is_scat & take_refr
    return normalize(next_dir), tint, refracted


# ---------------------------------------------------------------------------
# next-event estimation (reference cuda_render_kernel.cu:239-355)
# ---------------------------------------------------------------------------

def _nee_spot(scene, cfg, point, next_dir, d_in, mapped_normal, surf_scattering,
              roughness, alpha_op, reflectance, brdf_color, vs_pdf,
              medium_scattering, u, hw=None):
    n_lights = scene.n_spot_lights
    n_samples = cfg.light_sampling.spot_light
    total = jnp.zeros_like(point)
    for s in range(n_samples):
        us = u[:, 3 * s:3 * s + 3]
        li = jnp.minimum((us[:, 0] * n_lights).astype(jnp.int32), n_lights - 1)
        lpos = gather_rows(scene.spot_pos, li)
        ldir = gather_rows(scene.spot_dir, li)
        lcol = gather_rows(scene.spot_color, li)
        lsize = gather_rows(scene.spot_size, li)
        lemit = gather_rows(scene.spot_emission, li)
        lcos = gather_rows(scene.spot_cos_angle, li)

        # sampleDirection (cuda_spot_light.cuh:56-80)
        v_pl0 = lpos - point
        d_pl0 = jnp.sqrt(jnp.maximum(dot(v_pl0, v_pl0), 1e-20))
        vop_dot = dot(v_pl0, next_dir)
        # sqrt args floored at 1e-20, not 0: d/dx sqrt(x) is infinite at 0,
        # and rays pointing straight at the light center hit exactly 0 —
        # the inf then poisons every gradient through this sample (NaN)
        d_pq = jnp.sqrt(jnp.maximum(d_pl0 * d_pl0 - vop_dot * vop_dot, 1e-20))
        would_hit = (d_pq < lsize) & (vop_dot > 0.0)
        d_oq = jnp.sqrt(jnp.maximum(d_pl0 * d_pl0 - d_pq * d_pq, 1e-20))
        vpl_hit = next_dir * jnp.maximum(d_oq, 1e-4)[:, None]
        vpl_disk = sample_disk(us[:, 1], us[:, 2], v_pl0 / d_pl0[:, None], lsize) + v_pl0
        vpl = jnp.where(would_hit[:, None], vpl_hit, vpl_disk)
        se = jnp.where(would_hit, lemit, 0.0)

        d_pl = jnp.sqrt(jnp.maximum(dot(vpl, vpl), 1e-20))
        vpl_n = vpl / d_pl[:, None]
        brdf = brdf_eval(d_in, mapped_normal, surf_scattering, roughness,
                         alpha_op, reflectance, vpl_n)
        solid_angle = (lsize * lsize * jnp.pi) / ((d_pl + 1.0) * (d_pl + 1.0))
        sctr = jnp.exp(-d_pl * medium_scattering)
        beam = (lcos < dot(-vpl_n, ldir)).astype(jnp.float32)

        l_pdf = 1.0 / jnp.maximum(solid_angle, 1e-20)
        vsw = vs_pdf / (vs_pdf + l_pdf)
        lw = 1.0 - vsw
        le = lemit * solid_angle * brdf
        radiance = (le * lw + se * vsw) * sctr * beam
        radiance = jnp.where(radiance < 1e-4, 0.0, radiance)
        radiance = jnp.where(brdf < 1e-4, 0.0, radiance)

        v_rgb, v_a = shadow_test(scene, cfg, point, vpl_n, d_pl, hw=hw)
        total = total + lcol * brdf_color * (radiance * v_a)[:, None] * v_rgb
    pdf = n_samples / float(n_lights)
    return total / pdf


def _nee_direct(scene, cfg, point, next_dir, d_in, mapped_normal, surf_scattering,
                roughness, alpha_op, reflectance, brdf_color, vs_pdf, u, hw=None):
    n_lights = scene.n_direct_lights
    n_samples = cfg.light_sampling.direct_light
    total = jnp.zeros_like(point)
    for s in range(n_samples):
        us = u[:, 3 * s:3 * s + 3]
        li = jnp.minimum((us[:, 0] * n_lights).astype(jnp.int32), n_lights - 1)
        ldir = gather_rows(scene.dir_dir, li)
        lcol = gather_rows(scene.dir_color, li)
        lemit = gather_rows(scene.dir_emission, li)
        lcos = gather_rows(scene.dir_cos, li)

        # sampleDirection (cuda_direct_light.cuh:50-67)
        would_hit = dot(next_dir, -ldir) > lcos
        cone = sample_sphere(us[:, 1], us[:, 2] * 0.5 * (1.0 - lcos), -ldir)
        vpl = jnp.where(would_hit[:, None], next_dir, cone)
        se = jnp.where(would_hit, lemit, 0.0)

        vpl_n = normalize(vpl)
        brdf = brdf_eval(d_in, mapped_normal, surf_scattering, roughness,
                         alpha_op, reflectance, vpl_n)
        solid_angle = 2.0 * jnp.pi * (1.0 - lcos)
        l_pdf = 1.0 / jnp.maximum(solid_angle, 1e-20)
        vsw = vs_pdf / (vs_pdf + l_pdf)
        lw = 1.0 - vsw
        le = lemit * solid_angle * brdf
        radiance = le * lw + se * vsw
        radiance = jnp.where(radiance < 1e-4, 0.0, radiance)

        v_rgb, v_a = shadow_test(scene, cfg, point, vpl_n, jnp.full_like(se, BIG),
                                 hw=hw)
        total = total + lcol * brdf_color * (radiance * v_a)[:, None] * v_rgb
    pdf = n_samples / float(n_lights)
    return total / pdf


# ---------------------------------------------------------------------------
# one wavefront bounce
# ---------------------------------------------------------------------------

def n_streams(cfg: RenderConfig, scene: DeviceScene) -> int:
    ns = 8
    if scene.n_spot_lights:
        ns += 3 * cfg.light_sampling.spot_light
    if scene.n_direct_lights:
        ns += 3 * cfg.light_sampling.direct_light
    return ns


def pass_uniforms(key, row0, height: int, width: int, ns: int):
    """Uniform streams for image rows [row0, row0 + height) at one pass.

    Keyed per GLOBAL image row (fold_in(key, global_row)), so the streams are
    a pure function of (key, row) independent of how the wavefront is sharded:
    a shard_map shard that owns rows [row0, row0+h) draws bit-identical
    uniforms to the same rows of a single-device render. This is the sharded
    analog of the counter-based RNG contract (module docstring)."""
    rows = jnp.arange(height) + row0
    row_keys = jax.vmap(lambda r: jax.random.fold_in(key, r))(rows)
    u = jax.vmap(lambda k: jax.random.uniform(k, (width, ns), jnp.float32))(
        row_keys)
    return u.reshape(height * width, ns)


def bounce_step(scene: DeviceScene, cam: DeviceCamera, cfg: RenderConfig,
                state: RenderState, key, row0=0) -> RenderState:
    """Advance every pixel's path by one bounce (reference
    renderCumulativePass, cuda_render_kernel.cu:67-121).

    ``row0``: global image row of this wavefront's first row (non-zero only
    under the shard_map multi-chip path, parallel/mesh.py)."""
    H, W = state.height, state.width
    R = H * W
    u = pass_uniforms(key, row0, H, W, n_streams(cfg, scene))

    o, d = state.origin, state.direction
    depth0 = state.path_depth
    # camera segments refresh their clip range (cuda_render_kernel.cu:95)
    near = jnp.where(depth0 == 0, cam.near_far[0], state.near)
    far = jnp.where(depth0 == 0, cam.near_far[1], state.far)

    mp = mat_pack(scene)
    med = jnp.clip(state.medium, 0, scene.n_materials - 1)
    med_row = gather_rows(mp, med)
    med_color = med_row[:, 0:4]
    med_ior = med_row[:, 7]
    med_scatter = med_row[:, 8]

    # --- volumetric free flight (cuda_material.cuh:141-159) ---
    # the sampled distance uses a DETACHED sigma: the event's dependence on
    # sigma is handled by the score-function surrogate below, and mixing a
    # reparameterized distance with it would double count
    sigma = jnp.maximum(med_scatter, 1e-20)
    scat_dist = -jnp.log(u[:, 0] + 1e-4) / jax.lax.stop_gradient(sigma)
    has_scatter = med_scatter > 1e-4
    far_eff = jnp.where(has_scatter, jnp.minimum(far, scat_dist), far)

    # --- closest intersection (tp = the hit's packed attribute row) ---
    t, tri_id, b1, b2, external, tp = closest_hit(
        scene, cfg, o, d, near, far_eff, hw=(H, W))
    hit_obj = tri_id >= 0
    scatter_evt = has_scatter & ~hit_obj & (scat_dist < far)
    any_hit = hit_obj | scatter_evt
    t_final = jnp.where(hit_obj, t, jnp.where(scatter_evt, scat_dist, far_eff))

    # --- scatter-event score-function surrogate ---
    # the event DECISION (scatter at s vs survive to the surface) is a
    # discrete function of sigma that the pathwise gradient cannot see
    # (parallel/train.py's exclusion note). Multiply the throughput by the
    # event's likelihood ratio p_sigma(outcome)/stop_grad(p_sigma(outcome)):
    # forward value exactly 1, backward injects d log p/d sigma into every
    # downstream contribution — the REINFORCE estimator for the free-flight
    # event (scatter pdf sigma*exp(-sigma*s); survival exp(-sigma*t_hit)).
    t_sg = jax.lax.stop_gradient(t_final)
    logp = jnp.where(scatter_evt, jnp.log(sigma) - sigma * t_sg,
                     jnp.where(has_scatter, -sigma * t_sg, 0.0))
    event_ratio = jnp.exp(logp - jax.lax.stop_gradient(logp))
    # per-path cumulative score: the SAMPLE-COUNT channel is also an
    # event-dependent outcome (a path's termination pass shifts with the
    # free-flight decisions), so its increments carry the same likelihood
    # ratio — without this the score estimator is ~2x biased whenever the
    # loss divides by the per-pixel sample count
    score = state.score + logp
    count_ratio = jnp.exp(score - jax.lax.stop_gradient(score))

    e1, e2 = tp[:, 3:6], tp[:, 6:9]
    n0_w, n1_w, n2_w = tp[:, 9:12], tp[:, 12:15], tp[:, 15:18]
    tri_mat_hit = jnp.rint(tp[:, 24]).astype(jnp.int32)

    surf_mat = jnp.where(hit_obj, tri_mat_hit,
                         jnp.where(scatter_evt, med, WORLD_MATERIAL_ID))
    behind_mat = jnp.where(hit_obj & external, surf_mat,
                           jnp.where(scatter_evt, med,
                                     jnp.full_like(surf_mat, WORLD_MATERIAL_ID)))

    # --- surface frame ---
    b0 = 1.0 - b1 - b2
    tt0, tt1, tt2 = tp[:, 18:20], tp[:, 20:22], tp[:, 22:24]
    texcrd_hit = tt0 * b0[:, None] + tt1 * b1[:, None] + tt2 * b2[:, None]
    texcrd = jnp.where(hit_obj[:, None], texcrd_hit,
                       jnp.where(scatter_evt[:, None], 0.0, cam_ops.sky_texcrd(d)))
    ext_f = jnp.where(external, 1.0, -1.0)[:, None]
    flat_n = normalize(cross(e1, e2)) * ext_f
    vtx_n = normalize(n0_w * b0[:, None] + n1_w * b1[:, None]
                      + n2_w * b2[:, None])

    mat = material_fetch(scene, mp, surf_mat, texcrd)

    # normal mapping (reference Triangle::mapNormal, cuda_render_parts.cuh:1095-1116)
    mapped = vtx_n
    if scene.has_maps:
        has_nm = mat.normal_map >= 0
        nm_rgb = tex_ops.fetch_scene(scene, mat.normal_map, texcrd, atlas=0)[:, :3]
        duv1 = tt1 - tt0
        duv2 = tt2 - tt0
        f = 1.0 / jnp.where(jnp.abs(duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]) < 1e-12,
                            1e-12, duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1])
        tangent = normalize((e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * f[:, None])
        tangent = normalize(tangent - mapped * dot(tangent, mapped)[:, None])
        bitangent = cross(tangent, mapped)
        mn = nm_rgb * 2.0 - 1.0
        perturbed = normalize(mapped * mn[:, 2:3] + tangent * mn[:, 0:1]
                              + bitangent * mn[:, 1:2])
        mapped = jnp.where(has_nm[:, None], perturbed, mapped)
    mapped = mapped * ext_f

    normal = jnp.where(hit_obj[:, None], flat_n, d)
    mapped_normal = jnp.where(hit_obj[:, None], mapped, d)

    # --- Beer's law (cuda_render_kernel.cu:162-176) ---
    # base floored at 1e-6, not 0: d/dx x^t is infinite at x = 0 for t < 1,
    # and a fully-opaque medium (alpha = 1) would poison every gradient;
    # 1e-6^t is numerically 0 for any scene-scale distance
    med_alpha_op = 1.0 - med_color[:, 3]
    throughput = (state.throughput * med_color[:, :3]
                  * (event_ratio
                     * jnp.power(jnp.maximum(med_alpha_op, 1e-6),
                                 t_final))[:, None])

    # --- emissive contribution ---
    contrib = jnp.where((mat.emission > 0.0)[:, None],
                        throughput * mat.color_rgb * mat.emission[:, None], 0.0)

    new_depth = jnp.where(any_hit, depth0 + 1, PATH_LIMIT)

    # --- fresnel / reflectance ---
    n2 = gather_rows(mp, jnp.clip(behind_mat, 0,
                                  scene.n_materials - 1))[:, 7]
    fresnel, refr_ratio, refr_b = fresnel_specular_ratio(mapped_normal, d, med_ior, n2)
    reflectance = lerp(fresnel, 1.0, mat.metalness)

    surf_scattering = mat.scattering
    next_dir, tint, refracted = sample_direction(
        d, normal, mapped_normal, mat, surf_scattering, fresnel, reflectance,
        refr_ratio, refr_b, u[:, 1], u[:, 2], u[:, 3])

    # hit point with normal nudge (cuda_render_kernel.cu:214-216);
    # the nudge normal flips when refracting (cuda_material.cuh:272)
    nudge_n = jnp.where(refracted[:, None], -normal, normal)
    point = o + d * t_final[:, None] + nudge_n * (1e-4 * t_final)[:, None]

    # --- NEE (only for surviving surface interactions) ---
    # miss rays carry point ~ o + d * BIG: the spot-light distance math then
    # overflows f32 (inf - inf = NaN) and, although the contribution is
    # masked by any_hit, the NaN still poisons gradients through the
    # where() backward pass — so NEE sees a safe origin for masked lanes
    if scene.n_spot_lights or scene.n_direct_lights:
        point_nee = jnp.where(any_hit[:, None], point, 0.0)
        vs_pdf = brdf_eval(d, mapped_normal, surf_scattering, mat.roughness,
                           mat.alpha_op, reflectance, next_dir)
        brdf_color = lerp(mat.color_rgb, jnp.ones_like(mat.color_rgb),
                          reflectance[:, None])
        direct = jnp.zeros_like(point)
        off = 8
        if scene.n_spot_lights:
            ns = 3 * cfg.light_sampling.spot_light
            direct = direct + _nee_spot(
                scene, cfg, point_nee, next_dir, d, mapped_normal, surf_scattering,
                mat.roughness, mat.alpha_op, reflectance, brdf_color, vs_pdf,
                med_scatter, u[:, off:off + ns], hw=(H, W))
            off += ns
        if scene.n_direct_lights:
            ns = 3 * cfg.light_sampling.direct_light
            direct = direct + _nee_direct(
                scene, cfg, point_nee, next_dir, d, mapped_normal, surf_scattering,
                mat.roughness, mat.alpha_op, reflectance, brdf_color, vs_pdf,
                u[:, off:off + ns], hw=(H, W))
        metallic_tint = lerp(jnp.ones_like(mat.color_rgb), mat.color_rgb,
                             mat.metalness[:, None])
        contrib = contrib + jnp.where(any_hit[:, None],
                                      direct * throughput * metallic_tint, 0.0)

    # --- throughput tint (cuda_render_kernel.cu:235) ---
    throughput_next = lerp(throughput, throughput * mat.color_rgb, tint[:, None])

    # --- accumulate ---
    path_continues = new_depth < cfg.tracing.max_depth
    terminated = ~path_continues
    accum = state.accum.at[:, :, :3].add(contrib.reshape(H, W, 3))
    accum = accum.at[:, :, 3].add(
        jnp.where(terminated, count_ratio, 0.0).reshape(H, W))

    # depth/space buffers on camera segments (renderFirstPass,
    # cuda_render_kernel.cu:39-43)
    cam_seg = (depth0 == 0).reshape(H, W)
    depth_buf = jnp.where(cam_seg, t_final.reshape(H, W), state.depth_buf)
    space_buf = jnp.where(cam_seg[..., None],
                          (o + d * t_final[:, None]).reshape(H, W, 3),
                          state.space_buf)

    # --- continue or regenerate (cuda_render_kernel.cu:107-120) ---
    new_medium = jnp.where(refracted, behind_mat, med)
    pix = cam_ops.pixel_grid(W, H, row0)
    cam_o, cam_d = cam_ops.generate_rays(cam, pix, u[:, 4:8])

    tm = terminated[:, None]
    origin = jnp.where(tm, cam_o, point)
    direction = jnp.where(tm, cam_d, next_dir)
    throughput_out = jnp.where(tm, 1.0, throughput_next)
    medium = jnp.where(terminated, WORLD_MATERIAL_ID, new_medium)
    depth_out = jnp.where(terminated, 0, new_depth)
    near_out = jnp.where(terminated, cam.near_far[0], 0.0)
    far_out = jnp.where(terminated, cam.near_far[1], BIG)
    score_out = jnp.where(terminated, 0.0, score)

    return state.replace(
        accum=accum, depth_buf=depth_buf, space_buf=space_buf,
        origin=origin, direction=direction, throughput=throughput_out,
        medium=medium, path_depth=depth_out, near=near_out, far=far_out,
        score=score_out, pass_idx=state.pass_idx + 1)


# ---------------------------------------------------------------------------
# multi-bounce render step
# ---------------------------------------------------------------------------

def _render_steps_impl(scene: DeviceScene, cam: DeviceCamera, cfg: RenderConfig,
                       state: RenderState, key, n_steps: int,
                       remat: bool = False, row0=0) -> RenderState:
    step = bounce_step
    if remat:
        step = jax.checkpoint(bounce_step, static_argnums=(2,))

    def body(st, i):
        k = jax.random.fold_in(key, st.pass_idx)
        return step(scene, cam, cfg, st, k, row0), None

    state, _ = jax.lax.scan(body, state, jnp.arange(n_steps))
    return state


#: Run ``n_steps`` cumulative bounce passes under one jit (the analog of the
#: reference render cycle, cuda_engine_renderer.cu:125-186).
#:
#: The input ``state`` is DONATED (the reference double-buffers its
#: progressive buffers, cuda_engine_core.cu:109-127; donation is the XLA way
#: to update them in place): the accum/path buffers are rewritten in their own
#: HBM, so a render cycle does not double the state footprint. Callers must
#: not reuse the input state after the call — assign the result over it. Use
#: :data:`render_steps_preserve` when the same initial state must be rendered
#: from repeatedly (loss probes, finite differences).
render_steps = partial(jax.jit, static_argnames=("cfg", "n_steps", "remat"),
                       donate_argnames=("state",))(_render_steps_impl)

#: Non-donating twin of :data:`render_steps` — the input state stays alive.
render_steps_preserve = partial(
    jax.jit, static_argnames=("cfg", "n_steps", "remat"))(_render_steps_impl)


def ray_cast(scene: DeviceScene, cam: DeviceCamera, cfg: RenderConfig,
             state: RenderState, pixel_x: int, pixel_y: int):
    """Object picking (reference rayCast kernel, cuda_render_kernel.cu:130-144):
    re-trace the pixel's primary ray in a depth window around the stored depth.
    Returns (instance_idx, material_idx) as int32 arrays (-1 = none)."""
    px = jnp.asarray([[float(pixel_x), float(pixel_y)]], jnp.float32)
    o, d = cam_ops.simple_ray(cam, px)
    depth = state.depth_buf[pixel_y, pixel_x]
    near = depth * 0.99 * jnp.ones(1)
    far = depth * 1.01 * jnp.ones(1)
    t, tid, b1, b2, ext, _tp = closest_hit(scene, cfg, o, d, near, far)
    hit = tid[0] >= 0
    tri = jnp.maximum(tid[0], 0)
    inst = jnp.where(hit, scene.tri_inst[tri], -1)
    mat = jnp.where(hit, scene.tri_mat[tri], -1)
    return inst, mat
