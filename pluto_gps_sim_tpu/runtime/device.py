"""The one place that chooses where synthesis runs, and the compile cache.

Synthesis runs on this process's first device of JAX's default backend:
the GPU on a GPU host, the CPU elsewhere.  There is no fallback and no platform
branch; host-side f64 math (epoch solves, geodesy, the precise
reference) is pinned to the CPU separately by its callers.
"""

from __future__ import annotations

import os

__all__ = ["synthesis_device", "device_info", "compile_cache_dir",
           "configure_compile_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthesis_device():
    """The device production synthesis runs on (addressable by this
    process, also under jax.distributed)."""
    import jax
    return jax.local_devices()[0]


def device_info(device=None) -> dict:
    """platform, device_kind and device count of the synthesis backend."""
    import jax
    d = synthesis_device() if device is None else device
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices(d.platform))}


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache — a
    fixed path, so a later process on the same checkout finds what an
    earlier one compiled."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_REPO, ".jax_cache"))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir();
    returns the directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
