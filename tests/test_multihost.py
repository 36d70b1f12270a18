"""Multi-host runtime: two real OS processes must render bit-identically to
one process (the "fake cluster" test SURVEY §4 calls for; reference has no
distributed runtime at all — this is the multi-host extension of §2.7).

Each worker process initializes the JAX distributed runtime on the CPU
backend with one local device, renders its row band of a small Cornell
image through parallel/distributed.py, and allgathers the result. The
row-keyed RNG contract makes the 2-process image equal the 1-process one.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.pop("XLA_FLAGS", None)   # exactly one local CPU device
    import jax
    jax.config.update("jax_platforms", "cpu")
    from rayzath_tpu.parallel import distributed as D
    import rayzath_tpu as rz
    from rayzath_tpu.models.device_scene import compile_world, compile_camera

    port, pid, nproc, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    D.init_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    mesh = D.global_mesh()
    assert mesh.devices.size == nproc

    w = rz.scenes.cornell_box(32, 32)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=2))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    key = jax.random.key(11)
    state = D.init_state_distributed(32, 32, mesh)
    state = D.render_steps_distributed(scene, cam, cfg, state, key, 4, mesh)
    img = D.gather_image(state)
    band = D.host_row_band(32, mesh)
    if pid == 0:
        np.save(out, img)
        print(json.dumps({"band": band, "procs": jax.process_count()}))
""")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    out = str(tmp_path / "img.npy")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(i), "2", out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
    meta = json.loads(outs[0][0].strip().splitlines()[-1])
    assert meta["procs"] == 2
    assert meta["band"] == [0, 16] or tuple(meta["band"]) == (0, 16)
    img2 = np.load(out)
    assert img2.shape == (32, 32, 4)

    # single-process reference in THIS process (CPU, same key/state)
    import jax
    import rayzath_tpu as rz
    from rayzath_tpu.models.device_scene import compile_world, compile_camera
    from rayzath_tpu.engine.state import init_state
    from rayzath_tpu.engine.integrator import render_steps_preserve
    w = rz.scenes.cornell_box(32, 32)
    cfg = rz.RenderConfig(tracing=rz.Tracing(max_depth=3, rpp=2))
    scene = compile_world(w)
    cam = compile_camera(w.cameras[0])
    st = render_steps_preserve(scene, cam, cfg, init_state(32, 32),
                               jax.random.key(11), 4)
    img1 = np.asarray(st.accum)
    assert img2.dtype == img1.dtype
    np.testing.assert_array_equal(img2, img1)
