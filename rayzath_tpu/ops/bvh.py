"""Host BVH build over triangles (NumPy), flattened to SoA arrays for the device.

Build heuristics follow the reference triangle BVH
(RayZath/component_container.hpp:145-364 and bvh_tree_node.hpp:117-215):

* split point = mean of primitive centroids,
* split axis  = axis of maximum centroid variance,
* leaf size  <= ``leaf_size`` (reference: 8 triangles / 4 instances),
* max depth  <= 31.

Flattened layout follows the reference device tree (cuda_bvh_tree_node.cuh:8-54 and
the DFS flatten in cuda_bvh.cuh:30-111): one node array where an inner node stores
the index of its FIRST child (both children adjacent) plus its split axis, and a
leaf stores a [begin, count) range into the reordered primitive array. ``count == 0``
marks an inner node. The BVH walk (ops/traverse.py) consumes these arrays
directly; primitives are reordered into leaf order so leaf ranges are contiguous.

A C++ builder with identical output lives in rayzath_tpu/native (compiled on
first use; ``build_bvh`` prefers it). This NumPy implementation is the
always-available fallback and the test oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import native

MAX_DEPTH = 31


@dataclass
class FlatBVH:
    node_min: np.ndarray    # [N,3] f32
    node_max: np.ndarray    # [N,3] f32
    node_begin: np.ndarray  # [N] i32: leaf -> first primitive; inner -> first child
    node_count: np.ndarray  # [N] i32: 0 = inner node, >0 = leaf primitive count
    node_axis: np.ndarray   # [N] i32: split axis of inner node (0/1/2)
    order: np.ndarray       # [P] i32: primitive permutation (new -> old index)

    @property
    def n_nodes(self) -> int:
        return len(self.node_begin)


def build_bvh(prim_min: np.ndarray, prim_max: np.ndarray,
              leaf_size: int = 8, max_depth: int = MAX_DEPTH) -> FlatBVH:
    """Build a flattened binary BVH over primitives given per-primitive AABBs.

    Uses the native C++ builder when available, else the NumPy fallback."""
    out = native.bvh_build(np.asarray(prim_min, np.float32),
                           np.asarray(prim_max, np.float32),
                           leaf_size, max_depth)
    if out is not None:
        bvh = FlatBVH(*out)
        if len(prim_min) == 0:
            bvh.order = np.zeros(0, np.int32)
        return bvh
    return build_bvh_numpy(prim_min, prim_max, leaf_size, max_depth)


def build_bvh_numpy(prim_min: np.ndarray, prim_max: np.ndarray,
                    leaf_size: int = 8, max_depth: int = MAX_DEPTH) -> FlatBVH:
    """Pure-NumPy reference implementation of :func:`build_bvh`."""
    n = len(prim_min)
    prim_min = np.asarray(prim_min, np.float32)
    prim_max = np.asarray(prim_max, np.float32)
    if n == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(z.copy(), z.copy(),
                       np.zeros(1, np.int32), np.zeros(1, np.int32),
                       np.zeros(1, np.int32), np.zeros(0, np.int32))
    centroids = (prim_min + prim_max) * 0.5

    # node records appended in DFS order with children adjacent
    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    node_begin: list[int] = []
    node_count: list[int] = []
    node_axis: list[int] = []
    order: list[np.ndarray] = []
    out_count = 0  # primitives emitted so far

    def alloc_node() -> int:
        node_min.append(np.zeros(3, np.float32))
        node_max.append(np.zeros(3, np.float32))
        node_begin.append(0)
        node_count.append(0)
        node_axis.append(0)
        return len(node_begin) - 1

    def emit_leaf(node_id: int, idx: np.ndarray) -> None:
        nonlocal out_count
        node_begin[node_id] = out_count
        node_count[node_id] = len(idx)
        order.append(idx)
        out_count += len(idx)

    def build(node_id: int, idx: np.ndarray, depth: int) -> None:
        node_min[node_id] = prim_min[idx].min(0)
        node_max[node_id] = prim_max[idx].max(0)
        if len(idx) <= leaf_size or depth >= max_depth:
            emit_leaf(node_id, idx)
            return

        # too-large-object partition (reference Size partition type,
        # bvh_tree_node.hpp:127-148 / component_container.hpp:272-295):
        # primitives spanning the node box in every axis are separated into
        # their own child so they stop inflating every split's AABB.
        # Deviation: an axis the node is flat in (node size ~ 0) counts as
        # satisfied — the reference's strict compare would otherwise declare
        # every triangle of a flat coplanar patch "too large" and emit one
        # giant leaf.
        node_sz = node_max[node_id] - node_min[node_id]
        eps = 1e-12 + 1e-6 * float(node_sz.max())
        psize = prim_max[idx] - prim_min[idx]
        small = ((psize < node_sz[None, :])
                 | (node_sz[None, :] <= eps)).all(axis=1)
        n_small = int(small.sum())
        if n_small == 0:
            # only too-large primitives: sub-partition is ineffective
            emit_leaf(node_id, idx)
            return
        if n_small < len(idx):
            left_id = alloc_node()
            right_id = alloc_node()
            assert right_id == left_id + 1
            node_begin[node_id] = left_id
            node_count[node_id] = 0
            node_axis[node_id] = 0
            build(left_id, idx[small], depth + 1)
            build(right_id, idx[~small], depth + 1)
            return

        c = centroids[idx]
        var = c.var(axis=0)
        axis = int(np.argmax(var))
        split = float(c[:, axis].mean())
        left_mask = c[:, axis] < split
        n_left = int(left_mask.sum())
        if n_left == 0 or n_left == len(idx):
            # degenerate (all centroids equal along axis): median split
            half = len(idx) // 2
            ordering = np.argsort(c[:, axis], kind="stable")
            left_idx, right_idx = idx[ordering[:half]], idx[ordering[half:]]
        else:
            left_idx, right_idx = idx[left_mask], idx[~left_mask]
        left_id = alloc_node()
        right_id = alloc_node()
        assert right_id == left_id + 1
        node_begin[node_id] = left_id
        node_count[node_id] = 0
        node_axis[node_id] = axis
        build(left_id, left_idx, depth + 1)
        build(right_id, right_idx, depth + 1)

    root = alloc_node()
    build(root, np.arange(n, dtype=np.int32), 0)

    return FlatBVH(
        node_min=np.asarray(node_min, np.float32),
        node_max=np.asarray(node_max, np.float32),
        node_begin=np.asarray(node_begin, np.int32),
        node_count=np.asarray(node_count, np.int32),
        node_axis=np.asarray(node_axis, np.int32),
        order=np.concatenate(order).astype(np.int32) if order else np.zeros(0, np.int32),
    )


def compute_skip_links(node_begin: np.ndarray, node_count: np.ndarray,
                       node_axis: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-octant stackless traversal tables.

    For each of the 8 ray-direction octants, emit ``first[o, node]`` (the child
    visited first = the near child for that octant, from the node's split axis)
    and ``skip[o, node]`` (the next node in that octant's front-to-back DFS
    order once this node's subtree is done; ``N`` = traversal finished).

    This turns the reference's per-thread index-stack walk
    (cuda_bvh.cuh:129-170, including its direction-sign child ordering) into a
    scatter-free iteration: per step a ray holds ONE node index and either
    descends (``first``) or skips (``skip``) — one node index of state per ray.
    """
    out = native.bvh_skip_links(node_begin, node_count, node_axis)
    if out is not None:
        return out
    n = len(node_begin)
    inner = node_count == 0
    first8 = np.zeros((8, n), np.int32)
    skip8 = np.zeros((8, n), np.int32)
    for o in range(8):
        bits = np.asarray([(o >> a) & 1 for a in range(3)], np.int32)
        flip = bits[node_axis]
        near = node_begin + flip
        far = node_begin + 1 - flip
        first = np.where(inner, near, n).astype(np.int32)
        skip = np.full(n, n, np.int32)
        # parents precede children in allocation order, so one forward sweep
        # propagates "next after my subtree" top-down
        for node in range(n):
            if inner[node]:
                skip[near[node]] = far[node]
                skip[far[node]] = skip[node]
        first8[o] = first
        skip8[o] = skip
    return first8, skip8


def triangle_aabbs(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Per-triangle AABBs from vertex positions [F,3]."""
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    return pmin.astype(np.float32), pmax.astype(np.float32)


def validate_bvh(bvh: FlatBVH, prim_min: np.ndarray, prim_max: np.ndarray) -> None:
    """Sanity checks: every primitive in exactly one leaf; leaf AABBs contain prims."""
    n = len(prim_min)
    seen = np.zeros(n, bool)
    seen[bvh.order] = True
    assert seen.all(), "BVH leaf ranges must cover every primitive exactly once"
    assert len(bvh.order) == n
    leaf = bvh.node_count > 0
    for nid in np.nonzero(leaf)[0]:
        b, c = bvh.node_begin[nid], bvh.node_count[nid]
        prims = bvh.order[b:b + c]
        assert (prim_min[prims] >= bvh.node_min[nid] - 1e-4).all()
        assert (prim_max[prims] <= bvh.node_max[nid] + 1e-4).all()
