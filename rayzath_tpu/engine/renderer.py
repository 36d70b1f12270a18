"""Renderer: per-camera progressive state + jitted render cycles.

Analog of the reference render orchestration
(cuda_engine_core.cu:32-128 + cuda_engine_renderer.cu:73-262). The reference's
persistent render thread + fence gates become: XLA async dispatch (the jitted
step returns immediately; we only block when fetching results) with donated
render state, and the host-side double-buffered mirroring becomes a whole-scene
re-flatten whenever the world's content version changes.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import numpy as np

from ..models.device_scene import (DeviceScene, DeviceCamera, compile_world,
                                   compile_camera)
from ..models.world import World
from ..utils.timing import TimeTable
from ..ops.tonemap import final_color, to_u8
from ..ops.reproject import primary_hits, reproject_accum
from .config import RenderConfig
from .integrator import render_steps, ray_cast
from .state import RenderState, init_state, save_state, load_state


class CameraView:
    """Per-camera progressive render state + counters (the analog of the
    reference's per-camera FrameBuffers/TracingStates)."""

    def __init__(self, camera):
        self.camera = camera
        self.device_camera: Optional[DeviceCamera] = None
        self.state: Optional[RenderState] = None
        self.camera_version = -1
        self.ray_count = 0       # rays traced (W*H per bounce pass, as in reference)
        self.pass_count = 0      # bounce passes executed
        # (prev DeviceCamera, prev accum, prev depth) captured on camera move,
        # consumed by the renderer's reprojection pass
        self.pending_reprojection = None

    def ensure(self):
        if (self.state is None or self.camera_version != self.camera.version
                or self.state.width != self.camera.width
                or self.state.height != self.camera.height):
            if (self.state is not None
                    and self.state.width == self.camera.width
                    and self.state.height == self.camera.height
                    and self.camera.temporal_blend > 0.0):
                self.pending_reprojection = (self.device_camera,
                                             self.state.accum,
                                             self.state.depth_buf)
            self.device_camera = compile_camera(self.camera)
            self.state = init_state(self.camera.width, self.camera.height)
            self.camera_version = self.camera.version
            self.ray_count = 0
            self.pass_count = 0


class Renderer:
    def __init__(self, world: World, config: Optional[RenderConfig] = None,
                 seed: int = 0, device=None):
        self.world = world
        self.config = config or RenderConfig()
        self.key = jax.random.key(seed)
        self.scene: Optional[DeviceScene] = None
        self._scene_version = -1
        # version-keyed sub-build memo for compile_world: geometry/BVH and
        # atlases (see compile_world docstring)
        self._compile_cache: dict = {}
        self.views: Dict[int, CameraView] = {}
        self.time_table = TimeTable()
        # optional device pin (e.g. jax.devices("cpu")[0] for the CPU engine
        # of the headless runner); None = JAX default placement
        self.device = device

    # -- scene mirroring ------------------------------------------------------
    def update_scene(self) -> DeviceScene:
        v = self.world.content_version()
        if self.scene is None or v != self._scene_version:
            self.time_table.reset()
            self.scene = compile_world(self.world,
                                       leaf_size=self.config.bvh_leaf_size,
                                       cache=self._compile_cache)
            self._scene_version = v
            # world change invalidates progressive accumulation (reference
            # update-flag path, cuda_engine_renderer.cu:91-113)
            for view in self.views.values():
                if view.state is not None:
                    view.state = init_state(view.camera.width, view.camera.height)
                    view.ray_count = 0
                    view.pass_count = 0
                    view.pending_reprojection = None  # stale: scene changed
            self.time_table.update("update world")
        return self.scene

    def view(self, camera) -> CameraView:
        cv = self.views.get(id(camera))
        if cv is None:
            cv = CameraView(camera)
            self.views[id(camera)] = cv
        cv.ensure()
        return cv

    # -- rendering ------------------------------------------------------------
    def render(self, camera=None, rpp: Optional[int] = None, block: bool = True):
        """Run one render cycle: ``rpp`` cumulative bounce passes for the camera
        (default: the first enabled camera / config rpp)."""
        scene = self.update_scene()
        cameras = [camera] if camera is not None else [
            c for c in self.world.cameras if c.enabled]
        n = rpp if rpp is not None else self.config.tracing.rpp
        if self.device is not None:
            scene = jax.device_put(scene, self.device)
        for cam in cameras:
            cv = self.view(cam)
            if self.device is not None:
                cv.state = jax.device_put(cv.state, self.device)
                cv.device_camera = jax.device_put(cv.device_camera, self.device)
            if cv.pending_reprojection is not None:
                # temporal reuse across the camera move (reference
                # spacialReprojection, cuda_engine_renderer.cu:139)
                prev_cam, prev_accum, prev_depth = cv.pending_reprojection
                cv.pending_reprojection = None
                t0 = time.perf_counter()
                depth, space = primary_hits(scene, cv.device_camera, self.config)
                accum = reproject_accum(space, prev_cam, prev_accum, prev_depth,
                                        cam.temporal_blend)
                cv.state = cv.state.replace(accum=accum, depth_buf=depth,
                                            space_buf=space)
                self.time_table.set("temporal reproject",
                                    (time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            cv.state = render_steps(scene, cv.device_camera, self.config,
                                    cv.state, self.key, n)
            if block:
                jax.block_until_ready(cv.state.accum)
            self.time_table.set("trace", (time.perf_counter() - t0) * 1e3)
            cv.pass_count += n
            cv.ray_count += n * cam.width * cam.height

    def image(self, camera=None, operator: str = "hyper") -> np.ndarray:
        """Tone-mapped uint8 image [H,W,3] for a camera."""
        cam = camera or next(c for c in self.world.cameras if c.enabled)
        cv = self.view(cam)
        t0 = time.perf_counter()
        rgb = final_color(cv.state.accum, cv.device_camera.aperture,
                          cv.device_camera.exposure_time, operator)
        out = np.asarray(to_u8(rgb))
        self.time_table.set("tone mapping", (time.perf_counter() - t0) * 1e3)
        return out

    def image_f32(self, camera=None, operator: str = "hyper") -> np.ndarray:
        cam = camera or next(c for c in self.world.cameras if c.enabled)
        cv = self.view(cam)
        return np.asarray(final_color(cv.state.accum, cv.device_camera.aperture,
                                      cv.device_camera.exposure_time, operator))

    def depth(self, camera=None) -> np.ndarray:
        cam = camera or next(c for c in self.world.cameras if c.enabled)
        return np.asarray(self.view(cam).state.depth_buf)

    def focus(self, camera, x: int, y: int) -> float:
        """Auto-focus: set the camera's focal distance from the rendered depth
        at a pixel (reference Camera::focus, camera.cpp:80-88). Returns the
        new focal distance."""
        cv = self.view(camera)
        xi = min(max(int(x), 0), camera.width - 1)
        yi = min(max(int(y), 0), camera.height - 1)
        dist = float(np.asarray(cv.state.depth_buf[yi, xi]))
        camera.focal_point = (xi, yi)
        if dist > 0.0:
            camera.focal_distance = dist
            camera.touch()
        return camera.focal_distance

    def pick(self, camera, x: int, y: int):
        """Object picking at a pixel; returns (instance_idx, material_idx) or
        (-1, -1) (reference rayCast, cuda_render_kernel.cu:130-144)."""
        scene = self.update_scene()
        cv = self.view(camera)
        inst, mat = ray_cast(scene, cv.device_camera, self.config, cv.state, x, y)
        return int(inst), int(mat)

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, path: str, camera=None) -> None:
        cam = camera or next(c for c in self.world.cameras if c.enabled)
        save_state(path, self.view(cam).state)

    def load_checkpoint(self, path: str, camera=None) -> None:
        cam = camera or next(c for c in self.world.cameras if c.enabled)
        # compile the world FIRST: the first update_scene of a fresh
        # renderer resets every view's progressive state, which would wipe
        # the checkpoint loaded below (found by test_checkpoint.py)
        self.update_scene()
        cv = self.view(cam)
        cv.state = load_state(path)
        cv.pass_count = int(cv.state.pass_idx)
        cv.ray_count = cv.pass_count * cam.width * cam.height

    def debug_info(self) -> str:
        return str(self.time_table)
