"""Multi-chip scaling measurement (BASELINE metric 3: >= 80% rays/s scaling
efficiency at N >= 2).

``measure_scaling`` renders the same progressive workload with the wavefront
sharded over 1, 2, ..., N devices of a 1-D ray mesh (scene replicated — the
sharding design of parallel/mesh.py) and reports rays/s + efficiency relative
to linear scaling from the 1-device run. On the GPUs of one host this measures
scaling over their interconnect; under ``--xla_force_host_platform_device_count`` it validates the
harness and the sharded program (virtual CPU devices share the same cores, so
efficiency numbers there are not meaningful).

Cross-HOST scaling is measured by parallel/distributed.py: run
``python -m rayzath_tpu.parallel.distributed --bench`` on every host of the
cluster (its module docstring documents the recipe); the multi-process code
path itself is CI-tested by tests/test_multihost.py with two real OS
processes on CPU.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import jax
import numpy as np

from ..engine.config import RenderConfig, Tracing
from ..engine.state import init_state
from ..models.device_scene import compile_world, compile_camera
from .mesh import make_mesh, sharded_render_steps


def measure_scaling(scene_fn: Optional[Callable] = None,
                    n_devices_list: Optional[Sequence[int]] = None,
                    rpp: int = 64, size: int = 256, max_depth: int = 8,
                    repeats: int = 3) -> List[dict]:
    """Returns one dict per device count: {n, rays_per_s, efficiency}."""
    if scene_fn is None:
        from .. import scenes
        scene_fn = scenes.cornell_box
    devs = jax.devices()
    if n_devices_list is None:
        n_devices_list = sorted({n for n in (1, 2, 4, 8, len(devs))
                                 if n <= len(devs)})
    world = scene_fn(size, size)
    cfg = RenderConfig(tracing=Tracing(max_depth=max_depth, rpp=rpp))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(0)

    results: List[dict] = []
    base = None
    for n in n_devices_list:
        assert size % n == 0, f"image height {size} not divisible by {n}"
        mesh = make_mesh(devs[:n])
        state = sharded_render_steps(scene, cam, cfg, init_state(size, size),
                                     key, rpp, mesh)   # compile + warm
        np.asarray(state.accum[0, 0])
        t0 = time.perf_counter()
        for _ in range(repeats):
            state = sharded_render_steps(scene, cam, cfg,
                                         init_state(size, size), key, rpp,
                                         mesh)
        np.asarray(state.accum[0, 0])
        dt = (time.perf_counter() - t0) / repeats
        rps = rpp * size * size / dt
        if base is None:
            base = rps
        results.append({
            "n": n,
            "rays_per_s": rps,
            "efficiency": rps / (base * n / n_devices_list[0]),
        })
    return results


def format_report(results: List[dict]) -> str:
    lines = ["devices | Mrays/s | scaling efficiency"]
    for r in results:
        lines.append(f"{r['n']:7d} | {r['rays_per_s'] / 1e6:7.2f} | "
                     f"{r['efficiency'] * 100.0:5.1f}%")
    return "\n".join(lines)
