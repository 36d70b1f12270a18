"""One platform decision, the compile-cache placement, chip_smoke's device
check and the float32 camera rays (no TF32 where a ray is built)."""
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import rayzath_tpu as rz
from rayzath_tpu.engine import engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_pick_device_gpu(monkeypatch):
    fake = object()
    monkeypatch.setattr(engine.jax, "devices",
                        lambda kind=None: [fake] if kind == "gpu" else [])
    assert engine.pick_device("gpu") is fake


def test_pick_device_cpu():
    dev = engine.pick_device()          # the tests run on the CPU platform
    assert dev.platform == "cpu" and dev == jax.devices("cpu")[0]
    assert engine.pick_device("cpu") == dev


def test_pick_device_unknown_platform_raises(monkeypatch):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        engine.pick_device("metal")
    monkeypatch.setattr(engine.jax, "default_backend", lambda: "weirdchip")
    with pytest.raises(RuntimeError, match="weirdchip"):
        rz.Engine()


def _cache_dir_in_fresh_process(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax, rayzath_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_respects_env(tmp_path):
    assert _cache_dir_in_fresh_process(str(tmp_path)) == str(tmp_path)


def test_compile_cache_default_inside_checkout():
    path = _cache_dir_in_fresh_process(None)
    assert path == os.path.join(ROOT, ".jax_cache") == rz.DEFAULT_CACHE_DIR


def test_chip_smoke_refuses_cpu():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with pytest.raises(SystemExit, match="not 'gpu'"):
        smoke.require_gpu(jax)


def test_camera_rays_match_f64():
    """Camera rays built in float32 agree with an f64 NumPy construction to
    1e-6: the camera rotation is f32 multiply-adds, never a TF32 matmul."""
    from rayzath_tpu.models.device_scene import compile_camera
    from rayzath_tpu.ops.camera import generate_rays, pixel_grid
    world = rz.scenes.teapot_like(64, 48)
    cam = compile_camera(world.cameras[0])
    pix = pixel_grid(64, 48)
    u = jax.random.uniform(jax.random.key(2), (64 * 48, 4))
    o, d = generate_rays(cam, pix, u)

    p, u64 = np.asarray(pix, np.float64), np.asarray(u, np.float64)
    w, h = 64.0, 48.0
    tana = np.tan(float(cam.fov) * 0.5)
    dx = ((p[:, 0] + 0.5) / w - 0.5) * tana + (0.5 / w) * (u64[:, 0] * 2 - 1)
    dy = (((p[:, 1] + 0.5) / h - 0.5) * (-tana / (w / h))
          + (0.5 / w) * (u64[:, 1] * 2 - 1))
    dirs = np.stack([dx, dy, np.ones_like(dx)], 1) * float(cam.focal_distance)
    ang = u64[:, 2] * 2 * np.pi
    rad = np.sqrt(u64[:, 3]) * float(cam.aperture)
    org = np.stack([rad * np.sin(ang), rad * np.cos(ang), np.zeros_like(ang)],
                   1)
    rot = np.asarray(cam.rot, np.float64)
    o_ref = org @ rot.T + np.asarray(cam.position, np.float64)
    d_ref = (dirs - org) @ rot.T
    d_ref /= np.linalg.norm(d_ref, axis=1, keepdims=True)
    np.testing.assert_allclose(np.asarray(o), o_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(d), d_ref, rtol=1e-6, atol=1e-6)
