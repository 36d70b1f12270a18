"""Render configuration.

Mirrors the reference ``RenderConfig`` (RayZath/engine_parts.hpp:76-128):
``Tracing{max_depth=16, rpp=8}`` and ``LightSampling{spot=1, direct=1}``.
These are static (compile-time) values for the jitted integrator.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class Tracing:
    max_depth: int = 16
    rpp: int = 8  # bounce-steps (cumulative passes) per render cycle


@dataclass(frozen=True)
class LightSampling:
    spot_light: int = 1
    direct_light: int = 1


@dataclass(frozen=True)
class RenderConfig:
    tracing: Tracing = Tracing()
    light_sampling: LightSampling = LightSampling()
    # knobs not in the reference:
    # Scenes with <= this many triangles take the dense XLA projection test
    # (ops/intersect.project_closest) instead of the BVH walk. Default 0:
    # every scene walks the BVH.
    brute_force_threshold: int = 0
    bvh_leaf_size: int = 8
    chunk: int = 512                   # brute-force triangle tile size
    # Sort rays by the Morton-major spatial-directional coherence key
    # before traversal (ops/sort_rays.py). None = auto (integrator
    # _sort_traversal: scenes past ~2k triangles); True/False forces it.
    ray_sort: Optional[bool] = None

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)
