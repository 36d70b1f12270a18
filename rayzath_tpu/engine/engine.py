"""Engine facade (reference RayZath/rayzath.hpp:45-60).

Owns the World, the RenderConfig, and the renderer backend. The reference's
CUDA-vs-CPU backend switch becomes one platform decision
(:func:`pick_device`): the jitted JAX integrator runs on the GPU when JAX's
platform is ``gpu``, on a JAX CPU device only when the platform is ``cpu``
(the tests, or the headless runner's explicit ``"CPU"`` engine), and any
other platform is an error — there is no silent fallback. The independent
NumPy oracle (rayzath_tpu.oracle) is the verification backend, exercised by
the test suite.
"""
from __future__ import annotations

from typing import Optional

import jax

from ..models.world import World
from .config import RenderConfig
from .renderer import Renderer

_instance: Optional["Engine"] = None


def pick_device(platform: Optional[str] = None):
    """The device the engine renders on: the first GPU when the platform is
    ``gpu``, the first CPU device when it is ``cpu``. ``platform`` defaults
    to JAX's default backend; any other platform raises."""
    platform = platform or jax.default_backend()
    if platform in ("gpu", "cpu"):
        return jax.devices(platform)[0]
    raise RuntimeError(f"unsupported JAX platform {platform!r}: the renderer "
                       "runs on a GPU, or on the CPU for tests")


class Engine:
    def __init__(self, config: Optional[RenderConfig] = None, seed: int = 0):
        self._world = World()
        self._config = config or RenderConfig()
        self._renderer = Renderer(self._world, self._config, seed=seed,
                                  device=pick_device())

    @staticmethod
    def instance() -> "Engine":
        global _instance
        if _instance is None:
            _instance = Engine()
        return _instance

    @property
    def world(self) -> World:
        return self._world

    @world.setter
    def world(self, world: World) -> None:
        self._world = world
        self._renderer = Renderer(world, self._config, seed=0,
                                  device=pick_device())

    @property
    def render_config(self) -> RenderConfig:
        return self._config

    @render_config.setter
    def render_config(self, cfg: RenderConfig) -> None:
        self._config = cfg
        self._renderer.config = cfg

    @property
    def renderer(self) -> Renderer:
        return self._renderer

    def render_world(self, block: bool = True, rpp: Optional[int] = None) -> None:
        """One render cycle over all enabled cameras (reference
        Engine::renderWorld, rayzath.cpp:64-94)."""
        self._renderer.render(rpp=rpp, block=block)

    def debug_info(self) -> str:
        return self._renderer.debug_info()
