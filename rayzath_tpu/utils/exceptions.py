"""Typed exceptions + assert helpers (equivalent of RayZath/rzexception.hpp)."""
from __future__ import annotations


class RayZathError(RuntimeError):
    """Base error for the framework (reference RZThrow/RZAssert macros)."""


class SceneError(RayZathError):
    """Invalid scene construction or reference."""


class LoaderError(RayZathError):
    """Scene/asset loading failure."""


def rz_assert(cond: bool, message: str = "assertion failed") -> None:
    if not cond:
        raise RayZathError(message)
