"""Native (C++) runtime components, loaded via ctypes.

The reference keeps its host runtime — BVH builds (bvh_tree_node.hpp,
component_container.hpp) and the scene loaders (loader.cpp) — in C++; this
package is this renderer's native equivalent. Components:

* ``bvh_build``  — flattened-BVH builder (src/bvh.cpp), identical output
  layout/heuristics as the NumPy fallback in ops/bvh.py.
* ``obj_parse``  — OBJ parser (src/obj.cpp), same semantics as io/obj.py's
  ``parse_obj``.

The shared library is compiled on first use with g++ (cached next to the
sources); every consumer falls back to the pure-NumPy implementation when the
toolchain or the library is unavailable, so the framework never hard-depends
on the native layer. Set ``RZ_NATIVE=0`` to force the fallbacks.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_SO = os.path.join(_DIR, "librayzath_native.so")
_SOURCES = ("bvh.cpp", "obj.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _needs_build() -> bool:
    if not os.path.exists(_SO):
        return True
    so_mtime = os.path.getmtime(_SO)
    return any(
        os.path.getmtime(os.path.join(_SRC, s)) > so_mtime for s in _SOURCES)


def _build() -> bool:
    srcs = [os.path.join(_SRC, s) for s in _SOURCES]
    cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", _SO, *srcs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _bind(lib: ctypes.CDLL) -> None:
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.rz_bvh_build.restype = ctypes.c_int
    lib.rz_bvh_build.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.rz_bvh_skip_links.restype = ctypes.c_int
    lib.rz_bvh_skip_links.argtypes = [i32p, i32p, i32p, ctypes.c_int, i32p, i32p]
    lib.rz_obj_parse.restype = ctypes.c_void_p
    lib.rz_obj_parse.argtypes = [ctypes.c_char_p]
    lib.rz_obj_free.argtypes = [ctypes.c_void_p]
    lib.rz_obj_mesh_count.restype = ctypes.c_int
    lib.rz_obj_mesh_count.argtypes = [ctypes.c_void_p]
    lib.rz_obj_mesh_name.restype = ctypes.c_char_p
    lib.rz_obj_mesh_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rz_obj_mesh_counts.argtypes = [ctypes.c_void_p, ctypes.c_int, i32p]
    lib.rz_obj_mesh_data.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     f32p, f32p, f32p, i32p, i32p, i32p, i32p]
    lib.rz_obj_mesh_slot_name.restype = ctypes.c_char_p
    lib.rz_obj_mesh_slot_name.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.rz_obj_mtllib_count.restype = ctypes.c_int
    lib.rz_obj_mtllib_count.argtypes = [ctypes.c_void_p]
    lib.rz_obj_mtllib.restype = ctypes.c_char_p
    lib.rz_obj_mtllib.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rz_obj_log_count.restype = ctypes.c_int
    lib.rz_obj_log_count.argtypes = [ctypes.c_void_p]
    lib.rz_obj_log_entry.restype = ctypes.c_char_p
    lib.rz_obj_log_entry.argtypes = [ctypes.c_void_p, ctypes.c_int, i32p]


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried or os.environ.get("RZ_NATIVE", "1") == "0":
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _needs_build() and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
            _bind(lib)
        except OSError:
            return None
        _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# BVH build
# ---------------------------------------------------------------------------

def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bvh_build(prim_min: np.ndarray, prim_max: np.ndarray,
              leaf_size: int, max_depth: int):
    """Native flattened-BVH build. Returns the FlatBVH field tuple
    (node_min, node_max, node_begin, node_count, node_axis, order) or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(prim_min)
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    max_nodes = max(2 * n - 1, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_begin = np.empty(max_nodes, np.int32)
    node_count = np.empty(max_nodes, np.int32)
    node_axis = np.empty(max_nodes, np.int32)
    order = np.empty(max(n, 1), np.int32)
    n_nodes = lib.rz_bvh_build(
        _f32p(pmin), _f32p(pmax), n, leaf_size, max_depth,
        _f32p(node_min), _f32p(node_max), _i32p(node_begin), _i32p(node_count),
        _i32p(node_axis), _i32p(order))
    if n_nodes < 0:
        return None
    return (node_min[:n_nodes].copy(), node_max[:n_nodes].copy(),
            node_begin[:n_nodes].copy(), node_count[:n_nodes].copy(),
            node_axis[:n_nodes].copy(), order[:n].copy())


def bvh_skip_links(node_begin: np.ndarray, node_count: np.ndarray,
                   node_axis: np.ndarray):
    """Native per-octant traversal tables; (first8 [8,N], skip8 [8,N]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(node_begin)
    begin = np.ascontiguousarray(node_begin, np.int32)
    count = np.ascontiguousarray(node_count, np.int32)
    axis = np.ascontiguousarray(node_axis, np.int32)
    first8 = np.empty((8, max(n, 1)), np.int32)
    skip8 = np.empty((8, max(n, 1)), np.int32)
    if lib.rz_bvh_skip_links(_i32p(begin), _i32p(count), _i32p(axis), n,
                             _i32p(first8), _i32p(skip8)) != 0:
        return None
    return first8[:, :n], skip8[:, :n]


# ---------------------------------------------------------------------------
# OBJ parse
# ---------------------------------------------------------------------------

class NativeMesh:
    """Raw per-mesh arrays from the native OBJ parser."""

    def __init__(self, name: str, vertices, texcrds, normals,
                 tri_v, tri_t, tri_n, tri_m, slot_names: List[str]):
        self.name = name
        self.vertices = vertices
        self.texcrds = texcrds
        self.normals = normals
        self.tri_v = tri_v
        self.tri_t = tri_t
        self.tri_n = tri_n
        self.tri_m = tri_m
        self.slot_names = slot_names


def obj_parse(path: str) -> Optional[Tuple[List[NativeMesh], List[str],
                                           List[Tuple[int, str]]]]:
    """Native OBJ parse. Returns (meshes, mtllibs, log[(level, text)]) or None
    when the native library is unavailable or the file can't be opened."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.rz_obj_parse(os.fsencode(path))
    if not h:
        return None
    try:
        meshes: List[NativeMesh] = []
        for i in range(lib.rz_obj_mesh_count(h)):
            counts = np.zeros(5, np.int32)
            lib.rz_obj_mesh_counts(h, i, _i32p(counts))
            nv, nt, nn, nf, ns = (int(c) for c in counts)
            v = np.empty((nv, 3), np.float32)
            t = np.empty((nt, 2), np.float32)
            nrm = np.empty((nn, 3), np.float32)
            tv = np.empty((nf, 3), np.int32)
            tt = np.empty((nf, 3), np.int32)
            tn = np.empty((nf, 3), np.int32)
            tm = np.empty(nf, np.int32)
            lib.rz_obj_mesh_data(h, i, _f32p(v), _f32p(t), _f32p(nrm),
                                 _i32p(tv), _i32p(tt), _i32p(tn), _i32p(tm))
            slot_names = [lib.rz_obj_mesh_slot_name(h, i, s).decode("utf-8")
                          for s in range(ns)]
            meshes.append(NativeMesh(
                lib.rz_obj_mesh_name(h, i).decode("utf-8", "replace"),
                v, t, nrm, tv, tt, tn, tm, slot_names))
        mtllibs = [lib.rz_obj_mtllib(h, i).decode("utf-8", "replace")
                   for i in range(lib.rz_obj_mtllib_count(h))]
        log = []
        for i in range(lib.rz_obj_log_count(h)):
            level = np.zeros(1, np.int32)
            text = lib.rz_obj_log_entry(h, i, _i32p(level))
            log.append((int(level[0]), text.decode("utf-8", "replace")))
        return meshes, mtllibs, log
    finally:
        lib.rz_obj_free(h)
