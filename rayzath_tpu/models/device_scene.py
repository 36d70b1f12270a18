"""World -> device scene compilation (SoA JAX arrays).

This replaces the reference's per-object device mirror
(RayZath/cuda_world.cu:28-121, cuda_object_container.cuh:42-150). Instead of
pointer-linked device objects chunk-copied through pinned memory, the whole scene
is flattened host-side (NumPy) into static-shape SoA arrays and uploaded as one
pytree whenever the world's content version changes.

Design decisions (vs the reference's two-level pointer BVH):

* **World-space triangle soup.** Each instance's mesh is pre-transformed into
  world space (positions by TRS, normals by inverse-transpose — the semantics of
  reference ``Transformation::transformL2G``) and concatenated into one global
  triangle array carrying a *global* material id (instance material slots
  resolved at compile time, reference cuda_instance.cuh:234) and an instance id
  (for picking). This turns the reference's TLAS-over-instances +
  BLAS-per-mesh traversal (cuda_bvh.cuh:114-171 + cuda_instance.cuh:35-91) into
  ONE flattened BVH traversal with zero per-ray transforms and no material
  indirection. Instanced worlds are expanded into the soup as well.
* **Texture atlases.** All color maps (textures + normal maps) are shelf-packed
  into one RGBA atlas; scalar maps (metalness/roughness/emission) into a scalar
  atlas. Per-map UV transform/filter/address-mode live in small tables, so one
  vectorized fetch kernel serves every map (reference TextureBuffer fetch,
  render_parts.hpp:209-221).
* **Materials as a table.** Index 0 is the world ("sky") material, index 1 the
  default surface material, then user materials — so a ray's current medium is
  just an int32 (the reference keeps raw ``Material*`` in the ray,
  cuda_render_parts.cuh:924-947).
"""
from __future__ import annotations

import warnings
from typing import Any, Optional

import numpy as np
import jax.numpy as jnp

from ..ops.traverse import bvh_tables
from ..ops.intersect import triangle_frames
from ..utils import pytree as struct
from ..utils.hostmath import normalize as nrm
from .material import Material
from .texture import TextureMap
from .world import World

WORLD_MATERIAL_ID = 0
DEFAULT_MATERIAL_ID = 1
NO_MAP = -1


@struct.dataclass
class DeviceScene:
    # geometry (world space), padded to n_tri_pad
    tri_v0: jnp.ndarray      # [F,3]
    tri_e1: jnp.ndarray      # [F,3]
    tri_e2: jnp.ndarray      # [F,3]
    tri_n0: jnp.ndarray      # [F,3] per-vertex world normals (flat fallback baked)
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_t0: jnp.ndarray      # [F,2]
    tri_t1: jnp.ndarray
    tri_t2: jnp.ndarray
    tri_mat: jnp.ndarray     # [F] i32 global material id
    tri_inst: jnp.ndarray    # [F] i32 instance id (picking)
    tri_pw: jnp.ndarray      # [3,3F] projection frames (ops/intersect.py)
    tri_pc: jnp.ndarray      # [3F] projection offsets

    # flattened BVH over world-space triangles, as the stackless traversal
    # tables of ops/traverse.py: aabb_links [8, 8N] (per-octant AABB + skip
    # links) plus leaf ranges for the in-jit leaf-block table
    aabb_links: jnp.ndarray   # [8, 8N] f32
    node_begin: jnp.ndarray   # [N] i32
    node_count: jnp.ndarray   # [N] i32 (0 = inner)

    # materials SoA (0=world/sky, 1=default)
    mat_color: jnp.ndarray       # [M,4] rgba (alpha: 1=opaque)
    mat_metalness: jnp.ndarray   # [M]
    mat_roughness: jnp.ndarray   # [M]
    mat_emission: jnp.ndarray    # [M]
    mat_ior: jnp.ndarray         # [M]
    mat_scattering: jnp.ndarray  # [M]
    mat_maps: jnp.ndarray        # [M,5] i32: texture, normal, metalness, roughness, emission (-1 none)

    # texture atlases + per-map tables
    color_atlas: jnp.ndarray   # [Hc,Wc,4]
    scalar_atlas: jnp.ndarray  # [Hs,Ws]
    map_rect: jnp.ndarray      # [K,4] i32: y0,x0,h,w
    map_flags: jnp.ndarray     # [K,3] i32: filter, address, atlas(0=color,1=scalar)
    map_uv: jnp.ndarray        # [K,5] f32: scale_x, scale_y, rotation, trans_x, trans_y

    # lights
    spot_pos: jnp.ndarray        # [S,3]
    spot_dir: jnp.ndarray        # [S,3]
    spot_color: jnp.ndarray      # [S,3]
    spot_size: jnp.ndarray       # [S]
    spot_emission: jnp.ndarray   # [S]
    spot_cos_angle: jnp.ndarray  # [S]
    dir_dir: jnp.ndarray         # [D,3]
    dir_color: jnp.ndarray       # [D,3]
    dir_emission: jnp.ndarray    # [D]
    dir_cos: jnp.ndarray         # [D]

    # texture-alpha shadow filtering (reference cuda_instance.cuh:92-164 /
    # cuda_material.cuh:86-95: per-hit shadow factor = opacityColor *
    # textureOpacity — multiplicative, so the traversal kernels contribute the
    # constant material part and this dense "cutout" set (triangles whose
    # material has a color texture AND alpha < 1) contributes the texture
    # part; see integrator.texture_shadow_factor). World space.
    # static 2x2 bilinear block-index tables (ops/texture.block_indices):
    # one row gather replaces the 4 corner gathers of a bilinear fetch
    col_blk_idx: Any = None    # [Hc*Wc, 4] i32
    sc_blk_idx: Any = None     # [Hs*Ws, 4] i32

    cut_pw: Any = None        # [3,3C] projection frames
    cut_pc: Any = None        # [3C]
    cut_v0: Any = None        # [C,3] raw geometry (oracle's independent MT)
    cut_e1: Any = None
    cut_e2: Any = None
    cut_t0: Any = None        # [C,2] texcrds
    cut_t1: Any = None
    cut_t2: Any = None
    cut_map: Any = None       # [C] i32 texture map id

    # all per-hit shading attributes in ONE row, so resolving a hit costs a
    # single [R]-row gather instead of ~12.
    # cols: v0 0:3 | e1 3:6 | e2 6:9 | n0 9:12 | n1 12:15 | n2 15:18 |
    #       t0 18:20 | t1 20:22 | t2 22:24 | mat 24 | inst 25
    tri_pack: Any = None      # [F,32] f32

    # static metadata (not traced)
    n_triangles: int = struct.field(pytree_node=False, default=0)
    n_materials: int = struct.field(pytree_node=False, default=2)
    n_spot_lights: int = struct.field(pytree_node=False, default=0)
    n_direct_lights: int = struct.field(pytree_node=False, default=0)
    n_instances: int = struct.field(pytree_node=False, default=0)
    has_maps: bool = struct.field(pytree_node=False, default=False)
    # which of (texture, normal, metalness, roughness, emission) any material
    # actually references — static, so material_fetch skips whole atlas
    # fetches for absent kinds (each costs an [R]-row gather per bounce)
    map_kinds_used: tuple = struct.field(pytree_node=False,
                                         default=(False,) * 5)
    n_cutout: int = struct.field(pytree_node=False, default=0)
    # BVH leaf count: drives the ray-sort heuristic (integrator), not shapes
    n_leaves: int = struct.field(pytree_node=False, default=0)


@struct.dataclass
class DeviceCamera:
    position: jnp.ndarray    # [3]
    rot: jnp.ndarray         # [3,3] columns = axes
    fov: jnp.ndarray         # scalar
    near_far: jnp.ndarray    # [2]
    focal_distance: jnp.ndarray
    aperture: jnp.ndarray
    exposure_time: jnp.ndarray
    width: int = struct.field(pytree_node=False, default=1280)
    height: int = struct.field(pytree_node=False, default=720)


def compile_camera(cam) -> DeviceCamera:
    return DeviceCamera(
        position=jnp.asarray(cam.position, jnp.float32),
        rot=jnp.asarray(cam.coord_system(), jnp.float32),
        fov=jnp.float32(cam.fov),
        near_far=jnp.asarray(cam.near_far, jnp.float32),
        focal_distance=jnp.float32(cam.focal_distance),
        aperture=jnp.float32(cam.aperture),
        exposure_time=jnp.float32(cam.exposure_time),
        width=cam.width,
        height=cam.height,
    )


# ---------------------------------------------------------------------------
# atlas packing
# ---------------------------------------------------------------------------

def _pack_shelf(maps: list[TextureMap], channels: int):
    """Shelf-pack maps into one atlas. Returns (atlas HxWxC, rects [K,4])."""
    if not maps:
        atlas = np.zeros((8, 8, channels), np.float32)
        return atlas, np.zeros((0, 4), np.int32)
    max_w = max(max(m.width for m in maps), 8)
    atlas_w = 1 << int(np.ceil(np.log2(max_w)))
    rows: list[dict] = []
    rects = []
    y_cursor = 0
    for m in sorted(range(len(maps)), key=lambda i: -maps[i].height):
        tex = maps[m]
        placed = False
        for row in rows:
            if row["x"] + tex.width <= atlas_w and tex.height <= row["h"]:
                rects.append((m, row["y"], row["x"], tex.height, tex.width))
                row["x"] += tex.width
                placed = True
                break
        if not placed:
            rows.append({"y": y_cursor, "x": tex.width, "h": tex.height})
            rects.append((m, y_cursor, 0, tex.height, tex.width))
            y_cursor += tex.height
    atlas_h = max(y_cursor, 8)
    atlas = np.zeros((atlas_h, atlas_w, channels), np.float32)
    out = np.zeros((len(maps), 4), np.int32)
    for m, y0, x0, h, w in rects:
        data = maps[m].data
        atlas[y0:y0 + h, x0:x0 + w, :] = data[:, :, :channels]
        out[m] = (y0, x0, h, w)
    return atlas, out


# ---------------------------------------------------------------------------
# world compilation
# ---------------------------------------------------------------------------

def _pack_tri_rows(v0, e1, e2, n0, n1, n2, t0, t1, t2, mat_or_slot, inst):
    """[F,32] packed per-triangle shading row (DeviceScene.tri_pack):
    v0 0:3 | e1 3:6 | e2 6:9 | n0 9:12 | n1 12:15 | n2 15:18 | t0 18:20 |
    t1 20:22 | t2 22:24 | mat-or-slot 24 | inst 25 | pad 26:32. One gather
    of this row resolves a hit's whole shading frame."""
    f = len(v0)
    return np.concatenate([
        v0, e1, e2, n0, n1, n2, t0, t1, t2,
        np.asarray(mat_or_slot, np.float32).reshape(f, 1),
        np.asarray(inst, np.float32).reshape(f, 1),
        np.zeros((f, 6), np.float32)], axis=1).astype(np.float32)


def _pad_rows(a: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    if len(a) >= n:
        return a[:n]
    pad = np.full((n - len(a),) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], axis=0)


def _bucket(n: int, lo: int = 8) -> int:
    """Smallest 2^k or 1.5 * 2^k >= n (>= lo): 8, 16, 24, 32, 48, 64, 96...

    Padded array sizes quantize to these buckets so an edit that adds or
    removes a few triangles/clusters keeps every device shape — and with it
    the whole jit cache — stable (reference analog: the CUDA mirror reuses
    its allocations, cuda_object_container.cuh:42-150; here the shapes ARE
    the allocation)."""
    import math
    if n <= lo:
        return lo
    k = 2 ** int(math.floor(math.log2(n)))
    for c in (k, k * 3 // 2, k * 2):
        if c >= n:
            return c
    return k * 2


def _chain_key(inst):
    ks = []
    g = inst.group
    while g is not None:
        ks.append((id(g), getattr(g, "version", 0)))
        g = g.parent
    return tuple(ks)


def _geometry_key(world: World, leaf_size: int):
    """Cache key covering everything the flattened world-space geometry
    depends on: instance identity/version (includes transform + material
    slot edits), mesh identity/version, and the group chain versions."""
    parts = []
    for inst in world.instances:
        m = inst.mesh
        parts.append((id(inst), getattr(inst, "version", 0), id(m),
                      getattr(m, "version", 0) if m is not None else -1,
                      m.triangle_count if m is not None else 0,
                      _chain_key(inst)))
    return ("soup_geo", leaf_size, tuple(parts))


def _resolve_mat(mat_index: dict, mat, inst_name: str) -> int:
    """Material slot -> global id, warning on dangling references (a material
    never added to — or already destroyed from — the world renders with the
    default material, reference Observer-invalidation semantics)."""
    mid = mat_index.get(id(mat))
    if mid is None:
        warnings.warn(
            f"instance {inst_name!r} references material "
            f"{getattr(mat, 'name', '?')!r} that is not in the world; "
            "substituting the default material", RuntimeWarning)
        return DEFAULT_MATERIAL_ID
    return mid


def compile_world(world: World, leaf_size: int = 8,
                  cache: Optional[dict] = None) -> DeviceScene:
    """Flatten the host world into a DeviceScene (see module docstring).

    Every world compiles to the world-space triangle soup with one flattened
    BVH; instanced meshes are expanded (one copy per instance).

    ``cache``: optional dict (owned by the caller, e.g. the Renderer) that
    memoizes the expensive version-keyed sub-builds — the world-space
    geometry+BVH block and the texture atlases — so a materials-or-lights-only edit re-flattens
    nothing but the cheap binding tables (reference incremental re-mirror,
    updatable.hpp:10-54 + cuda_object_container.cuh:42-150)."""
    # ---- material table ----
    materials: list[Material] = [world.material, world.default_material] + list(world.materials)
    mat_index = {id(m): i for i, m in enumerate(materials)}

    # ---- map table (global ids across kinds; color maps then scalar maps) ----
    color_maps: list[TextureMap] = list(world.textures) + list(world.normal_maps)
    scalar_maps: list[TextureMap] = (list(world.metalness_maps) + list(world.roughness_maps)
                                     + list(world.emission_maps))
    all_maps = color_maps + scalar_maps
    map_id = {id(m): i for i, m in enumerate(all_maps)}

    akey = ("atlas", tuple((id(m), getattr(m, "version", 0))
                           for m in all_maps))
    if cache is not None and akey in cache:
        color_atlas, color_rects, scalar_atlas, scalar_rects = \
            cache[akey]["v"]
    else:
        color_atlas, color_rects = _pack_shelf(color_maps, 4)
        scalar_atlas3, scalar_rects = _pack_shelf(scalar_maps, 1)
        scalar_atlas = scalar_atlas3[:, :, 0]
        if cache is not None:
            for stale in [k2 for k2 in cache
                          if isinstance(k2, tuple) and k2[0] == "atlas"]:
                del cache[stale]
            cache[akey] = {"v": (color_atlas, color_rects, scalar_atlas,
                                 scalar_rects), "refs": list(all_maps)}
    k = len(all_maps)
    map_rect = np.zeros((max(k, 1), 4), np.int32)
    map_flags = np.zeros((max(k, 1), 3), np.int32)
    map_uv = np.zeros((max(k, 1), 5), np.float32)
    map_uv[:, 0:2] = 1.0
    for i, m in enumerate(all_maps):
        in_color = i < len(color_maps)
        rect = color_rects[i] if in_color else scalar_rects[i - len(color_maps)]
        map_rect[i] = rect
        map_flags[i] = (m.filter_mode, m.address_mode, 0 if in_color else 1)
        map_uv[i] = (m.scale[0], m.scale[1], m.rotation, m.translation[0], m.translation[1])

    def map_ref(m: Optional[TextureMap]) -> int:
        return NO_MAP if m is None else map_id[id(m)]

    n_mat = len(materials)
    mat_color = np.stack([m.color for m in materials]).astype(np.float32)
    mat_metalness = np.array([m.metalness for m in materials], np.float32)
    mat_roughness = np.array([m.roughness for m in materials], np.float32)
    mat_emission = np.array([m.emission for m in materials], np.float32)
    mat_ior = np.array([m.ior for m in materials], np.float32)
    mat_scattering = np.array([m.scattering for m in materials], np.float32)
    mat_maps = np.array(
        [[map_ref(m.texture), map_ref(m.normal_map), map_ref(m.metalness_map),
          map_ref(m.roughness_map), map_ref(m.emission_map)] for m in materials],
        np.int32,
    )

    map_kinds_used = tuple(bool((mat_maps[:, k] >= 0).any()) for k in range(5))

    # ---- world-space triangle soup (geometry block cached by version) ----
    geo = _soup_geometry(world, leaf_size, cache)
    n_tri = geo["n_tri"]
    n_tri_pad = geo["n_tri_pad"]

    # material binding (cheap, rebuilt every compile so edits/training are
    # never stale): instance slot tables -> per-triangle global material ids
    n_inst_total = len(world.instances)
    slot_tables = np.full((max(n_inst_total, 1), 64), DEFAULT_MATERIAL_ID,
                          np.int32)
    for inst_id, inst in enumerate(world.instances):
        for s, mat in enumerate(inst.materials[:64]):
            if mat is not None:
                slot_tables[inst_id, s] = _resolve_mat(mat_index, mat,
                                                       inst.name)
    inst_rows = geo["inst_rows"]
    tri_mat = np.where(
        inst_rows >= 0,
        slot_tables[np.clip(inst_rows, 0, None), geo["slot_rows"]],
        DEFAULT_MATERIAL_ID).astype(np.int32)
    tri_pack = _pack_tri_rows(geo["tri_v0"], geo["tri_e1"], geo["tri_e2"],
                              geo["tri_n0"], geo["tri_n1"], geo["tri_n2"],
                              geo["tri_t0"], geo["tri_t1"], geo["tri_t2"],
                              tri_mat, inst_rows)
    cut_fields = _cutout_from_soup(geo, tri_mat, mat_color, mat_maps)
    n_cutout = cut_fields.pop("n_cutout")

    return DeviceScene(
        **cut_fields, n_cutout=n_cutout,
        tri_v0=jnp.asarray(geo["tri_v0"]), tri_e1=jnp.asarray(geo["tri_e1"]),
        tri_e2=jnp.asarray(geo["tri_e2"]),
        tri_n0=jnp.asarray(geo["tri_n0"]), tri_n1=jnp.asarray(geo["tri_n1"]),
        tri_n2=jnp.asarray(geo["tri_n2"]),
        tri_t0=jnp.asarray(geo["tri_t0"]), tri_t1=jnp.asarray(geo["tri_t1"]),
        tri_t2=jnp.asarray(geo["tri_t2"]),
        tri_mat=jnp.asarray(tri_mat), tri_inst=jnp.asarray(inst_rows),
        tri_pw=geo["tri_pw"], tri_pc=geo["tri_pc"],
        tri_pack=jnp.asarray(tri_pack),
        aabb_links=geo["aabb_links"],
        node_begin=geo["node_begin"], node_count=geo["node_count"],
        mat_color=jnp.asarray(mat_color), mat_metalness=jnp.asarray(mat_metalness),
        mat_roughness=jnp.asarray(mat_roughness), mat_emission=jnp.asarray(mat_emission),
        mat_ior=jnp.asarray(mat_ior), mat_scattering=jnp.asarray(mat_scattering),
        mat_maps=jnp.asarray(mat_maps),
        **_atlas_fields(color_atlas, scalar_atlas, map_rect, map_flags, map_uv),
        **_light_fields(world),
        n_triangles=n_tri, n_materials=n_mat,
        n_spot_lights=len(world.spot_lights),
        n_direct_lights=len(world.direct_lights),
        n_instances=len(world.instances),
        has_maps=k > 0, map_kinds_used=map_kinds_used,
        n_leaves=geo["n_leaves"],
    )


def _soup_geometry(world: World, leaf_size: int, cache: Optional[dict]):
    """Flatten instances into the world-space soup, build the BVH, pad to
    bucketed shapes. Material-INDEPENDENT (slots are kept
    mesh-local), so any materials-only edit reuses this block wholesale via
    ``cache`` — the reference analog of StateRegister-guarded re-mirroring
    (updatable.hpp:10-54): untouched geometry is neither re-transformed nor
    re-BVH-built."""
    key = _geometry_key(world, leaf_size)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit

    v0s, e1s, e2s = [], [], []
    n0s, n1s, n2s = [], [], []
    t0s, t1s, t2s = [], [], []
    slots, insts = [], []
    refs = []
    for inst_id, inst in enumerate(world.instances):
        mesh = inst.mesh
        if mesh is None or mesh.triangle_count == 0:
            continue
        refs.append((inst, mesh))
        tr = inst.effective_transform()
        wv = tr.points_l2g(mesh.vertices).astype(np.float32)
        v0 = wv[mesh.tri_v[:, 0]]
        v1 = wv[mesh.tri_v[:, 1]]
        v2 = wv[mesh.tri_v[:, 2]]
        flat = nrm(np.cross(v1 - v0, v2 - v0)).astype(np.float32)
        if len(mesh.normals):
            wn = tr.normals_l2g(mesh.normals).astype(np.float32)
            def vtx_normal(col):
                idx = mesh.tri_n[:, col]
                ok = idx >= 0
                out = flat.copy()
                out[ok] = wn[idx[ok]]
                return out
            n0, n1, n2 = vtx_normal(0), vtx_normal(1), vtx_normal(2)
        else:
            n0 = n1 = n2 = flat
        if len(mesh.texcrds):
            def vtx_uv(col):
                idx = mesh.tri_t[:, col]
                ok = idx >= 0
                out = np.zeros((len(idx), 2), np.float32)
                out[ok] = mesh.texcrds[idx[ok]]
                return out
            t0, t1, t2 = vtx_uv(0), vtx_uv(1), vtx_uv(2)
        else:
            t0 = t1 = t2 = np.zeros((len(v0), 2), np.float32)
        v0s.append(v0); e1s.append(v1 - v0); e2s.append(v2 - v0)
        n0s.append(n0); n1s.append(n1); n2s.append(n2)
        t0s.append(t0); t1s.append(t1); t2s.append(t2)
        slots.append(np.clip(mesh.tri_mat, 0, 63).astype(np.int32))
        insts.append(np.full(len(v0), inst_id, np.int32))

    if v0s:
        tri_v0 = np.concatenate(v0s); tri_e1 = np.concatenate(e1s); tri_e2 = np.concatenate(e2s)
        tri_n0 = np.concatenate(n0s); tri_n1 = np.concatenate(n1s); tri_n2 = np.concatenate(n2s)
        tri_t0 = np.concatenate(t0s); tri_t1 = np.concatenate(t1s); tri_t2 = np.concatenate(t2s)
        slot_rows = np.concatenate(slots); inst_rows = np.concatenate(insts)
    else:
        tri_v0 = tri_e1 = tri_e2 = np.zeros((0, 3), np.float32)
        tri_n0 = tri_n1 = tri_n2 = np.zeros((0, 3), np.float32)
        tri_t0 = tri_t1 = tri_t2 = np.zeros((0, 2), np.float32)
        slot_rows = np.zeros(0, np.int32); inst_rows = np.zeros(0, np.int32)

    n_tri = len(tri_v0)

    # ---- BVH over world-space triangles + reorder into leaf order ----
    o, aabb_links, node_begin, node_count = bvh_tables(
        tri_v0, tri_e1, tri_e2, leaf_size, bucket=_bucket)
    tri_v0, tri_e1, tri_e2 = tri_v0[o], tri_e1[o], tri_e2[o]
    tri_n0, tri_n1, tri_n2 = tri_n0[o], tri_n1[o], tri_n2[o]
    tri_t0, tri_t1, tri_t2 = tri_t0[o], tri_t1[o], tri_t2[o]
    slot_rows, inst_rows = slot_rows[o], inst_rows[o]

    # pad to a bucketed size so small geometry edits keep shapes (and the
    # jit cache) stable; the padded tail never hits (v0 far, zero edges)
    n_tri_pad = _bucket(n_tri)
    tri_v0 = _pad_rows(tri_v0, n_tri_pad, 1e30)
    tri_e1 = _pad_rows(tri_e1, n_tri_pad, 0.0)
    tri_e2 = _pad_rows(tri_e2, n_tri_pad, 0.0)
    tri_n0 = _pad_rows(tri_n0, n_tri_pad, 0.0)
    tri_n1 = _pad_rows(tri_n1, n_tri_pad, 0.0)
    tri_n2 = _pad_rows(tri_n2, n_tri_pad, 0.0)
    tri_t0 = _pad_rows(tri_t0, n_tri_pad, 0.0)
    tri_t1 = _pad_rows(tri_t1, n_tri_pad, 0.0)
    tri_t2 = _pad_rows(tri_t2, n_tri_pad, 0.0)
    slot_rows = _pad_rows(slot_rows, n_tri_pad, 0)
    inst_rows = _pad_rows(inst_rows, n_tri_pad, -1)
    tri_pw, tri_pc = triangle_frames(tri_v0, tri_e1, tri_e2)

    value = dict(
        n_tri=n_tri, n_tri_pad=n_tri_pad,
        tri_v0=tri_v0, tri_e1=tri_e1, tri_e2=tri_e2,
        tri_n0=tri_n0, tri_n1=tri_n1, tri_n2=tri_n2,
        tri_t0=tri_t0, tri_t1=tri_t1, tri_t2=tri_t2,
        slot_rows=slot_rows, inst_rows=inst_rows,
        tri_pw=jnp.asarray(tri_pw), tri_pc=jnp.asarray(tri_pc),
        aabb_links=jnp.asarray(aabb_links),
        node_begin=jnp.asarray(node_begin),
        node_count=jnp.asarray(node_count),
        n_leaves=int((node_count > 0).sum()),
        refs=refs,  # pin object identity: id() reuse cannot false-hit
    )
    if cache is not None:
        for stale in [k2 for k2 in cache
                      if isinstance(k2, tuple) and k2[0] == "soup_geo"]:
            del cache[stale]
        cache[key] = value
    return value


def _cutout_from_soup(geo: dict, tri_mat: np.ndarray, mat_color, mat_maps):
    """Texture-alpha shadow cutout set, derived from the (cached) flattened
    soup instead of re-transforming instances: a triangle is a cutout when
    its resolved material has a color texture AND base alpha < 1 (reference
    cuda_material.cuh:86-95 semantics: when alpha = 1 the constant part
    already blocks the ray, so only transparent textured materials need the
    texture term)."""
    n_tri = geo["n_tri"]
    tm = tri_mat[:n_tri]
    sel = (mat_maps[tm, 0] >= 0) & (mat_color[tm, 3] < 1.0 - 1e-6)
    if not sel.any():
        return dict(n_cutout=0)
    v0 = geo["tri_v0"][:n_tri][sel]
    e1 = geo["tri_e1"][:n_tri][sel]
    e2 = geo["tri_e2"][:n_tri][sel]
    pw, pc = triangle_frames(v0, e1, e2)
    return dict(
        cut_pw=jnp.asarray(pw), cut_pc=jnp.asarray(pc),
        cut_v0=jnp.asarray(v0), cut_e1=jnp.asarray(e1),
        cut_e2=jnp.asarray(e2),
        cut_t0=jnp.asarray(geo["tri_t0"][:n_tri][sel]),
        cut_t1=jnp.asarray(geo["tri_t1"][:n_tri][sel]),
        cut_t2=jnp.asarray(geo["tri_t2"][:n_tri][sel]),
        cut_map=jnp.asarray(mat_maps[tm[sel], 0].astype(np.int32)),
        n_cutout=int(sel.sum()))


def _atlas_fields(color_atlas, scalar_atlas, map_rect, map_flags, map_uv):
    from ..ops.texture import block_indices
    kinds = map_flags[:, 2]
    col_rects = map_rect[kinds == 0] if len(map_rect) else map_rect
    sc_rects = map_rect[kinds == 1] if len(map_rect) else map_rect
    return dict(
        color_atlas=jnp.asarray(color_atlas), scalar_atlas=jnp.asarray(scalar_atlas),
        map_rect=jnp.asarray(map_rect), map_flags=jnp.asarray(map_flags),
        map_uv=jnp.asarray(map_uv),
        col_blk_idx=jnp.asarray(block_indices(
            col_rects, color_atlas.shape[0], color_atlas.shape[1])),
        sc_blk_idx=jnp.asarray(block_indices(
            sc_rects, scalar_atlas.shape[0], scalar_atlas.shape[1])))


def _light_fields(world: World) -> dict:
    """Light SoA tables (padded to >=1 so shapes stay static; counts gate
    usage)."""
    sl = list(world.spot_lights)
    dl = list(world.direct_lights)
    spot_pos = np.stack([l.position for l in sl]) if sl else np.zeros((1, 3), np.float32)
    spot_dir = np.stack([l.direction for l in sl]) if sl else np.tile([[0, -1, 0]], (1, 1)).astype(np.float32)
    spot_color = np.stack([l.color for l in sl]) if sl else np.ones((1, 3), np.float32)
    spot_size = np.array([l.size for l in sl], np.float32) if sl else np.zeros(1, np.float32)
    spot_emission = np.array([l.emission for l in sl], np.float32) if sl else np.zeros(1, np.float32)
    spot_cos = np.array([l.cos_beam_angle for l in sl], np.float32) if sl else np.ones(1, np.float32)
    dir_dir = np.stack([l.direction for l in dl]) if dl else np.tile([[0, -1, 0]], (1, 1)).astype(np.float32)
    dir_color = np.stack([l.color for l in dl]) if dl else np.ones((1, 3), np.float32)
    dir_emission = np.array([l.emission for l in dl], np.float32) if dl else np.zeros(1, np.float32)
    dir_cos = np.array([l.cos_angular_size for l in dl], np.float32) if dl else np.ones(1, np.float32)
    return dict(
        spot_pos=jnp.asarray(spot_pos), spot_dir=jnp.asarray(spot_dir),
        spot_color=jnp.asarray(spot_color), spot_size=jnp.asarray(spot_size),
        spot_emission=jnp.asarray(spot_emission), spot_cos_angle=jnp.asarray(spot_cos),
        dir_dir=jnp.asarray(dir_dir), dir_color=jnp.asarray(dir_color),
        dir_emission=jnp.asarray(dir_emission), dir_cos=jnp.asarray(dir_cos))
