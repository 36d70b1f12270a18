"""rayzath_tpu — a differentiable Monte-Carlo path tracer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the RayZath
renderer (C++/CUDA reference): wavefront integration over SoA ray buffers,
flattened world-space BVH walked per ray, counter-based stateless RNG,
texture atlases, progressive accumulation with checkpointable state, end-to-end
differentiability (path-replay style), and multi-GPU rendering via
jax.sharding meshes.
"""

import os as _os

import jax as _jax

#: The persistent compile cache's directory when ``JAX_COMPILATION_CACHE_DIR``
#: is unset: a fixed path inside the checkout (listed in .gitignore).
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def configure_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise a directory
    already configured through ``jax.config`` (e.g. by the test suite) is
    kept; otherwise :data:`DEFAULT_CACHE_DIR`. Applied through
    ``jax.config``, so it takes effect even when jax was imported first."""
    path = (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or _jax.config.jax_compilation_cache_dir or DEFAULT_CACHE_DIR)
    _jax.config.update("jax_compilation_cache_dir", path)
    return path


configure_compile_cache()

from .engine import Engine, Renderer, RenderConfig, Tracing, LightSampling
from .models import (World, Material, Mesh, Camera, SpotLight, DirectLight,
                     Instance, Group, Texture, NormalMap, MetalnessMap,
                     RoughnessMap, EmissionMap)
from . import scenes

__version__ = "0.1.0"

__all__ = [
    "Engine", "Renderer", "RenderConfig", "Tracing", "LightSampling",
    "World", "Material", "Mesh", "Camera", "SpotLight", "DirectLight",
    "Instance", "Group", "Texture", "NormalMap", "MetalnessMap",
    "RoughnessMap", "EmissionMap", "scenes",
]
