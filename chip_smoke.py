"""On-card smoke test of the renderer's main path: one GPU, one process.

    python chip_smoke.py           # phases 1-6 on one GPU
    python chip_smoke.py --multi   # the four-GPU path and its comparison only

Phases (one informational line each):

1. device    JAX platform, device kind and count; the card's name and power
             limit from ``nvidia-smi`` (a child process that does not import
             JAX).
2. render    ``Renderer(world).render`` at 512^2, max depth 8, 64 passes on
             cornell_box_nee, mesh_heavy and instanced_field (expanded to the
             triangle soup), plus the plain Cornell box at 256^2 against the
             healthy brightness band. Compile time and rays/s are printed for
             information only.
3. parity    the BVH walk (ops.traverse.closest) against an f64 NumPy
             brute-force Moller-Trumbore on 4,096 sampled primary rays and
             their first-bounce rays, on teapot_like and mesh_heavy. All
             float32 and no TF32: ray generation is elementwise f32 and the
             walk has no matmul. Triangle ids must
             match except where the f64 barycentric margin or the relative
             gap between the two nearest t is below 1e-5.
4. headless  a scene saved with the repo's own saver plus a task file, run by
             ``Headless().run`` in-process at the reference defaults
             (1920x1080, max depth 16, rpp 64); report.txt must show rays.
5. gradient  three ``training_step``s at 128^2 on ``scenes.lit_blocker`` (a
             lit scene with a semi-transparent blocker): finite loss and
             gradients, and a non-zero d(alpha) of the blocker through the
             shadow walk's VJP.
6. gpu-tests the pytest tests marked ``gpu``, in this process.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``; it
is printed only when every phase passed. Without a GPU the script exits
non-zero before any phase.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

RES = 512
DEPTH = 8
PASSES = 64
PARITY_RAYS = 4096
HEADLESS = dict(size=(1920, 1080), depth=16, rpp=64)   # reference defaults
GRAD_SIZE = 128
MULTI = dict(size=2048, passes=16, train_size=256)
EPS_BAND = 1e-5
CORNELL_BAND = (40.0, 90.0)   # .claude/skills/verify/SKILL.md
SANE_BAND = (5.0, 220.0)      # near-black / blown-out images


def card_info() -> str:
    """The card's ``name, power.limit`` from nvidia-smi (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def require_gpu(jax) -> dict:
    """JAX's device summary; raises SystemExit unless the platform is gpu."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is {dev.platform!r}, "
                         "not 'gpu'; nothing was measured")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# --------------------------------------------------------------------------
# phase 2: render
# --------------------------------------------------------------------------

def render_scene(rz, np, world, passes: int, chunk: int = 8):
    """Render ``passes`` passes through the public Renderer; returns
    (renderer, compile seconds, rays/s)."""
    cam = world.cameras[0]
    r = rz.Renderer(world, rz.RenderConfig(
        tracing=rz.Tracing(max_depth=DEPTH, rpp=chunk)))
    t0 = time.perf_counter()
    r.render(rpp=chunk)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(passes // chunk):
        r.render(rpp=chunk)
    dt = time.perf_counter() - t0
    acc = np.asarray(r.view(cam).state.accum)
    if not np.isfinite(acc).all():
        raise AssertionError("accumulator is not finite")
    if not acc[..., 3].mean() > 0:
        raise AssertionError("no samples accumulated")
    return r, compile_s, passes * cam.width * cam.height / dt


def phase_render(rz, np):
    r, _, _ = render_scene(rz, np, rz.scenes.cornell_box(256, 256), 32)
    mean = float(r.image().mean())
    if not CORNELL_BAND[0] <= mean <= CORNELL_BAND[1]:
        raise AssertionError(f"cornell_box 256^2 mean pixel {mean:.2f} "
                             f"outside {CORNELL_BAND}")
    parts = [f"cornell_box 256^2 mean {mean:.2f}"]
    for name in ("cornell_box_nee", "mesh_heavy", "instanced_field"):
        world = rz.scenes.SCENES[name](RES, RES)
        r, compile_s, rps = render_scene(rz, np, world, PASSES)
        mean = float(r.image().mean())
        if not SANE_BAND[0] < mean < SANE_BAND[1]:
            raise AssertionError(f"{name} mean pixel {mean:.2f} outside "
                                 f"{SANE_BAND}")
        parts.append(f"{name} tris={r.scene.n_triangles} mean={mean:.2f} "
                     f"compile={compile_s:.1f}s rays/s={rps:.4g}")
    return "; ".join(parts)


# --------------------------------------------------------------------------
# phase 3: parity against an f64 brute force
# --------------------------------------------------------------------------

def f64_reference(np, o, d, v0, e1, e2, chunk: int = 128):
    """Closest hit of f64 rays against every triangle (reference MT
    numerics without the det nudge). Returns (tri_id, t, ambiguous): a ray
    is ambiguous when a triangle in front of the winner is within EPS_BAND
    of a barycentric edge, or the two nearest t differ by < EPS_BAND rel."""
    ids, ts, amb = [], [], []
    for i in range(0, len(o), chunk):
        oo, dd = o[i:i + chunk, None, :], d[i:i + chunk, None, :]
        p = np.cross(dd, e2[None])
        det = np.sum(e1[None] * p, -1)
        det = np.where(np.abs(det) < 1e-300, 1e-300, det)
        tv = oo - v0[None]
        b1 = np.sum(tv * p, -1) / det
        q = np.cross(tv, e1[None])
        b2 = np.sum(dd * q, -1) / det
        t = np.sum(e2[None] * q, -1) / det
        margin = np.minimum(np.minimum(b1, b2), 1.0 - b1 - b2)
        valid = (margin >= 0.0) & (b1 <= 1.0) & (t > 0.0)
        tt = np.where(valid, t, np.inf)
        two = np.partition(tt, 1, axis=1)[:, :2] if tt.shape[1] > 1 else \
            np.concatenate([tt, np.full_like(tt, np.inf)], 1)
        k = np.argmin(tt, axis=1)
        t1 = tt[np.arange(len(k)), k]
        hit = np.isfinite(t1)
        with np.errstate(invalid="ignore"):
            tie = hit & ((two[:, 1] - t1) < EPS_BAND * np.maximum(t1, 1e-30))
        reach = np.where(hit, t1 * (1.0 + EPS_BAND), np.inf)
        edge = ((np.abs(margin) < EPS_BAND) & (t > 0.0)
                & (t <= reach[:, None])).any(1)
        ids.append(np.where(hit, k, -1))
        ts.append(t1)
        amb.append(tie | edge)
    return np.concatenate(ids), np.concatenate(ts), np.concatenate(amb)


def phase_parity(rz, np, jax, jnp):
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    from rayzath_tpu.ops import traverse
    from rayzath_tpu.ops.camera import pixel_grid, generate_rays

    parts = ["float32, no TF32 (elementwise ray generation, matmul-free "
             "walk)"]
    for name in ("teapot_like", "mesh_heavy"):
        world = rz.scenes.SCENES[name](RES, RES)
        scene = compile_world(world)
        cam = compile_camera(world.cameras[0])
        n = scene.n_triangles
        v0, e1, e2 = (np.asarray(a, np.float64)[:n]
                      for a in (scene.tri_v0, scene.tri_e1, scene.tri_e2))
        rng = np.random.default_rng(0)
        pix = rng.choice(RES * RES, PARITY_RAYS, replace=False)
        grid = pixel_grid(RES, RES)[pix]
        u = jax.random.uniform(jax.random.key(1), (PARITY_RAYS, 4))
        o, d = generate_rays(cam, grid, u)
        walk = jax.jit(lambda o, d: traverse.closest(
            o, d, jnp.zeros(o.shape[0]), jnp.full(o.shape[0], 3e38),
            scene.aabb_links, scene.node_begin, scene.node_count,
            scene.tri_v0, scene.tri_e1, scene.tri_e2))
        for kind in ("primary", "bounce"):
            id_k = np.asarray(walk(o, d)[1])
            o64, d64 = np.asarray(o, np.float64), np.asarray(d, np.float64)
            id_r, t_r, amb = f64_reference(np, o64, d64, v0, e1, e2)
            bad = (id_k != id_r) & ~amb
            parts.append(f"{name} {kind}: {int(bad.sum())} mismatches of "
                         f"{len(id_r)} ({int(amb.sum())} in the 1e-5 band, "
                         f"{int((id_r >= 0).sum())} hits)")
            if bad.any():
                raise AssertionError("; ".join(parts))
            if kind == "primary":
                # first bounce: from each hit point, a random direction
                hit = id_r >= 0
                keep = np.nonzero(hit)[0]
                pts = o64[keep] + d64[keep] * t_r[keep, None]
                nd = rng.normal(size=(len(keep), 3))
                nd /= np.linalg.norm(nd, axis=1, keepdims=True)
                o = jnp.asarray(pts + nd * 1e-4, jnp.float32)
                d = jnp.asarray(nd, jnp.float32)
    return "; ".join(parts)


# --------------------------------------------------------------------------
# phase 4: headless
# --------------------------------------------------------------------------

def phase_headless(rz):
    from rayzath_tpu.headless import Headless
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        world = rz.scenes.teapot_like(*HEADLESS["size"])
        scene_path = os.path.join(tmp, "scene.json")
        world.save_scene(scene_path)
        task_path = os.path.join(tmp, "tasks.json")
        with open(task_path, "w") as f:
            json.dump({"tasks": [{"scene path": "scene.json",
                                  "engine": ["CUDAGPU"],
                                  "rpp": HEADLESS["rpp"], "timeout": 600,
                                  "max depth": HEADLESS["depth"]}]}, f)
        report_dir = os.path.join(tmp, "report")
        with open(os.devnull, "w") as sink:
            t0 = time.perf_counter()
            rc = Headless(out=sink).run(task_path, report_dir)
            dt = time.perf_counter() - t0
        with open(os.path.join(report_dir, "report.txt")) as f:
            report = f.read()
        if rc != 0 or "traced" not in report or " 0 rays" in report:
            raise AssertionError(f"headless report: {report!r}")
        w, h = HEADLESS["size"]
        return (f"teapot_like {w}x{h} depth {HEADLESS['depth']} rpp "
                f"{HEADLESS['rpp']} in {dt:.1f}s: " + " ".join(report.split()))


# --------------------------------------------------------------------------
# phase 5: gradient
# --------------------------------------------------------------------------

def phase_gradient(rz, np, jax, jnp):
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    from rayzath_tpu.engine.state import init_state
    from rayzath_tpu.parallel.train import image_loss, training_step

    size, n = GRAD_SIZE, 4
    world = rz.scenes.lit_blocker(size, size)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=n))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    state = init_state(size, size)
    key = jax.random.key(4)
    target = jnp.zeros((size, size, 3))
    blocker = 3   # world, default, floor, blocker

    g = jax.grad(lambda mc: image_loss(scene.replace(mat_color=mc), cam, cfg,
                                       state, key, target, n)[0])(
        scene.mat_color)
    d_alpha = float(g[blocker, 3])
    if not (np.isfinite(np.asarray(g)).all() and d_alpha != 0.0):
        raise AssertionError(f"d(alpha) of the blocker: {d_alpha}")
    losses = []
    for _ in range(3):
        scene, _, loss = training_step(scene, cam, cfg, state, key, target,
                                       jnp.float32(0.05), n)
        losses.append(float(loss))
    if not np.isfinite(losses).all():
        raise AssertionError(f"losses {losses}")
    return f"losses {losses}, d(alpha) of the blocker {d_alpha:.6g}"


# --------------------------------------------------------------------------
# phase 6: the tests marked gpu
# --------------------------------------------------------------------------

def phase_gpu_tests():
    import pytest
    os.environ["RZ_TEST_PLATFORM"] = "gpu"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu exited {rc}")
    return "pytest -m gpu passed"


# --------------------------------------------------------------------------
# --multi: four GPUs
# --------------------------------------------------------------------------

def phase_multi(rz, np, jax, jnp):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    from rayzath_tpu.engine.integrator import render_steps
    from rayzath_tpu.engine.state import init_state
    from rayzath_tpu.parallel import (make_mesh, sharded_render_steps,
                                      shard_state, replicate_scene,
                                      training_step)

    mesh = make_mesh(jax.devices())
    size, passes = MULTI["size"], MULTI["passes"]
    world = rz.scenes.mesh_heavy(size, size)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=DEPTH, rpp=passes))
    scene = compile_world(world)
    cam = compile_camera(world.cameras[0])
    key = jax.random.key(7)
    one = jax.devices()[0]
    scene1, cam1 = jax.device_put(scene, one), jax.device_put(cam, one)

    def run_single():
        return render_steps(scene1, cam1, cfg,
                            jax.device_put(init_state(size, size), one), key,
                            passes)

    def run_sharded():
        return sharded_render_steps(scene, cam, cfg, init_state(size, size),
                                    key, passes, mesh)

    single, sharded = run_single(), run_sharded()
    rates = []
    for run in (run_single, run_sharded):   # compiled above; timed here
        t0 = time.perf_counter()
        jax.block_until_ready(run().accum)
        rates.append(passes * size * size / (time.perf_counter() - t0))
    s_depth, m_depth = (np.asarray(x.path_depth) for x in (single, sharded))
    s_buf, m_buf = (np.asarray(x.depth_buf) for x in (single, sharded))
    if not ((s_depth == m_depth).all() and (s_buf == m_buf).all()):
        raise AssertionError(
            f"hit decisions differ: {int((s_depth != m_depth).sum())} path "
            f"depths, {int((s_buf != m_buf).sum())} depth-buffer pixels")
    acc_s, acc_m = np.asarray(single.accum), np.asarray(sharded.accum)
    np.testing.assert_allclose(acc_m, acc_s, rtol=1e-5, atol=1e-6)
    rel = np.abs(acc_m - acc_s) / (np.abs(acc_s) + 1e-6)
    parts = [f"sharded render mesh_heavy {size}^2 x{passes} on "
             f"{mesh.devices.size} devices: hit decisions identical, accum "
             f"max rel diff {float(rel.max()):.3g}; rays/s one device "
             f"{rates[0]:.4g}, {mesh.devices.size} devices {rates[1]:.4g}"]

    tsize, n = MULTI["train_size"], 4
    tw = rz.scenes.lit_blocker(tsize, tsize)
    tcfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=n))
    tscene = compile_world(tw)
    tcam = compile_camera(tw.cameras[0])
    target = jnp.zeros((tsize, tsize, 3))
    _, _, l1 = training_step(jax.device_put(tscene, one),
                             jax.device_put(tcam, one), tcfg,
                             jax.device_put(init_state(tsize, tsize), one),
                             key, jax.device_put(target, one),
                             jnp.float32(0.05), n)
    _, _, l4 = training_step(
        replicate_scene(tscene, mesh), replicate_scene(tcam, mesh), tcfg,
        shard_state(init_state(tsize, tsize), mesh), key,
        jax.device_put(target, NamedSharding(mesh, P("rays"))),
        jnp.float32(0.05), n, mesh=mesh)
    rel = abs(float(l4) - float(l1)) / abs(float(l1))
    if not rel <= 1e-5:
        raise AssertionError(f"training loss {float(l4)} vs {float(l1)}")
    parts.append(f"training_step {tsize}^2 loss {float(l4):.7g} vs single "
                 f"{float(l1):.7g} (rel {rel:.2g})")
    return "; ".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU path and its comparison")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import rayzath_tpu as rz

    device = require_gpu(jax)
    if args.multi and device["count"] != 4:
        raise SystemExit(f"--multi needs 4 GPUs, found {device['count']}")
    card = card_info()
    log("device", f"{device['platform']} {device['kind']} x{device['count']}")
    print(card, flush=True)

    phases = ([("multi", lambda: phase_multi(rz, np, jax, jnp))]
              if args.multi else [
                  ("render", lambda: phase_render(rz, np)),
                  ("parity", lambda: phase_parity(rz, np, jax, jnp)),
                  ("headless", lambda: phase_headless(rz)),
                  ("gradient", lambda: phase_gradient(rz, np, jax, jnp)),
                  ("gpu-tests", phase_gpu_tests),
              ])
    for name, run in phases:
        t0 = time.perf_counter()
        msg = run()
        log(name, f"ok in {time.perf_counter() - t0:.1f}s: {msg}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
