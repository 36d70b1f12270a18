"""Benchmark: rays/s on one GPU for every built-in scene.

Measures every scene of ``rayzath_tpu.scenes.SCENES`` at 512^2, matching the
reference headless harness which benchmarks every scene x engine
(/root/reference/Application/headless.cpp:297-330). Ray accounting matches
the reference: one traced ray per pixel per cumulative pass
(cuda_render_kernel.cu:122-129). Timings end in ``block_until_ready``.

Output contract: exactly ONE JSON line on stdout — the headline
Cornell-512 depth-8 number, with the device it ran on. Per-scene results go
to BENCH_DETAIL.json next to this file and as progress lines on stderr.
Fails without a GPU: a CPU timing is not a device measurement.

Usage:
    python bench.py                  # all scenes; one stdout line (cornell)
    python bench.py --scene NAME     # just one scene (stdout line for it)
    python bench.py --quick          # shorter measurement window
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np

# The headline is the NEE-honest Cornell (emissive quad + spot light):
# every pass pays NEE + shadow traversal like the reference benchmark loop
# (Application/headless.cpp:207-246). Plain cornell_box (emissive-only, no
# shadow rays) is still measured for comparison.
HEADLINE = "cornell_box_nee"
DETAIL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "BENCH_DETAIL.json")


def device_record() -> dict:
    """The device the numbers belong to; raises SystemExit off a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: JAX platform is {dev.platform!r}, not "
                         "'gpu'; refusing to report a device measurement")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in card.split(",", 1))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": name, "power_limit": power}


def bench_scene(name: str, depth: int, quick: bool) -> dict:
    import rayzath_tpu as rz
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    from rayzath_tpu.engine.state import init_state
    from rayzath_tpu.engine.integrator import render_steps

    W = H = 512
    world = rz.scenes.SCENES[name](W, H)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=depth, rpp=8))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(0)

    chunk = 32  # passes per dispatched call
    state = init_state(W, H)
    t0 = time.perf_counter()
    state = render_steps(scene, cam, cfg, state, key, chunk)  # compile + warm
    jax.block_until_ready(state)
    warm_s = time.perf_counter() - t0

    # one timed chunk decides how many fit the measurement window
    t0 = time.perf_counter()
    state = render_steps(scene, cam, cfg, state, key, chunk)
    jax.block_until_ready(state)
    probe = time.perf_counter() - t0
    window = 2.0 if quick else 6.0
    n_chunks = max(1, min(64, int(window / max(probe, 1e-3))))

    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state = render_steps(scene, cam, cfg, state, key, chunk)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    rays = n_chunks * chunk * W * H
    rps = rays / dt
    spp = float(np.asarray(state.accum[..., 3]).mean())
    assert spp > 0, f"{name}: no samples accumulated"
    assert np.isfinite(np.asarray(state.accum)).all(), f"{name}: NaN in accum"
    return {
        "scene": name, "width": W, "height": H, "max_depth": depth,
        "rays_per_s": rps, "seconds": dt, "warmup_s": warm_s,
        "triangles": int(scene.n_triangles),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=None,
                    help="bench one scene (default: all)")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    device = device_record()
    import rayzath_tpu as rz
    names = [args.scene] if args.scene else list(rz.scenes.SCENES)

    results = []
    for name in names:
        try:
            r = bench_scene(name, args.depth, args.quick)
        except Exception as e:  # record the failure, keep the run alive
            r = {"scene": name, "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)

    detail = {"device": device, "results": results}
    with open(DETAIL_PATH, "w") as f:
        json.dump(detail, f, indent=1)

    head_name = args.scene or HEADLINE
    head = next((r for r in results if r["scene"] == head_name and "error" not in r),
                None)
    if head is None:
        print(json.dumps({"metric": f"{head_name}_rays_per_s", "value": 0,
                          "unit": "rays/s", "device": device}))
        sys.exit(1)
    print(json.dumps({
        "metric": f"{head['scene']}512_d{args.depth}_rays_per_s",
        "value": head["rays_per_s"],
        "unit": "rays/s",
        "device": device,
    }))
    if any("error" in r for r in results):
        sys.exit(1)


if __name__ == "__main__":
    main()
