"""Multi-host (multi-process) runtime: rendering over several hosts' devices.

The reference is single-node single-GPU (``cudaSetDevice(0)``,
RayZath/cuda_engine_parts.cu:151); SURVEY §2.7 names the
equivalent to build: ``jax.distributed.initialize()`` per host, a device
mesh over all hosts' chips, per-host ownership of image-row bands, scene
replicated, with the network between hosts crossed only for init,
checkpointing, and result gather. This module provides exactly that on top of parallel/mesh.py's
row-sharded integrator:

* :func:`init_distributed` — one call per process before any jax op; no-op
  for single-process runs so the same program works everywhere.
* :func:`global_mesh` — 1-D 'rays' mesh over every chip of every host
  (process-major order, so contiguous row bands land on one host's chips
  and no render-time traffic crosses hosts).
* :func:`init_state_distributed` — builds the sharded RenderState without
  materializing the full image on any single host (each process fills only
  its local row band via ``jax.make_array_from_callback``).
* :func:`render_steps_distributed` — the multi-host render step; per-bounce
  work is embarrassingly parallel (scene replicated), so the only
  communication is the caller's result fetch.
* :func:`gather_image` — allgather of the accumulation buffer across hosts
  (the one deliberate crossing between hosts), returning the full [H, W, 4] array in
  every process.

Process-count-invariance contract: the row-keyed RNG
(integrator.pass_uniforms) makes every row's samples a pure function of
(key, global_row), so an N-host render is bit-identical to a single-host
render of the same state. tests/test_multihost.py proves this with two real
OS processes on the CPU backend (the "fake cluster" the reference never
had, SURVEY §4).

Measurement recipe (BASELINE metric 3, >= 80% rays/s at N >= 2 hosts): on a
real cluster, run ``python -m rayzath_tpu.parallel.distributed --bench``
on every host with the coordinator address, process count and id given; it initializes, renders the headline
config over the global mesh, and process 0 prints rays/s. Efficiency =
rays/s(N hosts) / (N x rays/s(1 host)); per-bounce work has no cross-chip
collective, so the expected loss is only result-fetch amortization.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np

from ..engine.state import RenderState, init_state, BIG
from .mesh import (RAYS_AXIS, make_mesh, sharded_render_steps)

_initialized = False


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Initialize the multi-process JAX runtime (idempotent).

    With no arguments, reads the standard JAX env/cluster auto-detection
    where the platform provides it; explicit arguments support clusters and
    the CPU fake-cluster tests. Returns the process index. Single-process
    runs (no coordinator, no env) skip initialization entirely.
    """
    global _initialized
    if _initialized:
        return jax.process_index()
    addr = coordinator_address or os.environ.get("RZ_COORDINATOR")
    n = num_processes if num_processes is not None else (
        int(os.environ["RZ_NUM_PROCESSES"])
        if "RZ_NUM_PROCESSES" in os.environ else None)
    pid = process_id if process_id is not None else (
        int(os.environ["RZ_PROCESS_ID"])
        if "RZ_PROCESS_ID" in os.environ else None)
    if addr is None and n is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return 0  # single process
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=n, process_id=pid)
    _initialized = True
    return jax.process_index()


def global_mesh():
    """1-D 'rays' mesh over every device of every process (process-major:
    jax.devices() orders by process, so contiguous row bands are host-local
    and rendering never crosses hosts)."""
    return make_mesh(jax.devices())


def host_row_band(height: int, mesh=None) -> tuple[int, int]:
    """[row0, row1) of the image owned by THIS process under the 1-D row
    sharding (for host-side IO that wants to touch only local rows)."""
    mesh = mesh or global_mesh()
    n_dev = mesh.devices.size
    assert height % n_dev == 0
    rows_per_dev = height // n_dev
    local = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    idx = sorted(list(mesh.devices.flat).index(d) for d in local)
    return idx[0] * rows_per_dev, (idx[-1] + 1) * rows_per_dev


def init_state_distributed(width: int, height: int, mesh=None) -> RenderState:
    """A row-sharded RenderState built without any host holding the full
    image: each process materializes only its local shard rows."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = mesh or global_mesh()
    template = init_state(width, height)  # abstract: leaves are small fills

    def leaf(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        sh = NamedSharding(mesh, P(RAYS_AXIS))
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx, x=x: x[idx])
    leaves, treedef = jax.tree.flatten(template)
    return jax.tree.unflatten(treedef, [leaf(x) for x in leaves])


def render_steps_distributed(scene, cam, cfg, state: RenderState, key,
                             n_steps: int, mesh=None) -> RenderState:
    """Advance the render ``n_steps`` bounce passes over the global mesh.

    The scene/camera pytrees are replicated to every chip (each host uploads
    its own copy — no transfer of scene data between hosts); the wavefront state is
    row-sharded. Results are bit-identical to a single-device render."""
    mesh = mesh or global_mesh()
    return sharded_render_steps(scene, cam, cfg, state, key, n_steps, mesh)


def gather_image(state: RenderState) -> np.ndarray:
    """Full [H, W, 4] accumulation buffer in every process (the deliberate
    crossing between hosts; everything before this is host-local)."""
    from jax.experimental import multihost_utils
    if jax.process_count() == 1:
        return np.asarray(state.accum)
    return np.asarray(
        multihost_utils.process_allgather(state.accum, tiled=True))


def _bench(argv=None) -> None:
    """Multi-host scaling probe: run on every host of the cluster."""
    import argparse
    import time
    from .. import scenes
    from ..engine.config import RenderConfig, Tracing
    from ..models.device_scene import compile_world, compile_camera

    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--rpp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=8)
    args = ap.parse_args(argv)

    pid = init_distributed()
    mesh = global_mesh()
    world = scenes.SCENES[args.scene](args.size, args.size)
    cfg = RenderConfig(tracing=Tracing(max_depth=args.depth, rpp=args.rpp))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(0)
    state = init_state_distributed(args.size, args.size, mesh)
    state = render_steps_distributed(scene, cam, cfg, state, key, args.rpp,
                                     mesh)
    np.asarray(jax.device_get(state.pass_idx))  # compile + warm barrier
    t0 = time.perf_counter()
    state = render_steps_distributed(scene, cam, cfg, state, key, args.rpp,
                                     mesh)
    img = gather_image(state)
    dt = time.perf_counter() - t0
    rays = args.rpp * args.size * args.size
    if pid == 0:
        print({"hosts": jax.process_count(), "chips": len(jax.devices()),
               "rays_per_s": round(rays / dt, 1),
               "mean": float(img[..., :3].mean())})


if __name__ == "__main__":
    _bench()
