"""Device mesh construction for multi-device synthesis.

The framework's two parallel axes (SURVEY.md section 2, parallelism notes):

  * "time" — 0.1 s blocks shard across devices/hosts; closed-form phase
    parameters make every block independent (carrier continuity is
    precomputed analytically on the host), so this axis needs no
    communication at all — the reference's strictly sequential time
    loop (plutogpssim.c:2655) falling away.
  * "chan" — satellite channels shard across devices; the composite
    baseband is then a psum over this axis.  It moves the whole I/Q
    output between devices for nothing the time axis cannot do alone,
    so it is used only when a mesh asks for it explicitly.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "factor_devices"]


def factor_devices(n: int, chan_shards: int = 1) -> tuple[int, int]:
    """Split n devices into (time, chan): every device on "time" unless
    chan_shards asks for channel sharding."""
    if chan_shards < 1 or n % chan_shards:
        raise ValueError(f"{chan_shards} channel shards do not divide "
                         f"{n} devices")
    return n // chan_shards, chan_shards


def make_mesh(devices=None, time_shards: int | None = None,
              chan_shards: int | None = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if time_shards is None:
        time_shards, chan_shards = factor_devices(n, chan_shards or 1)
    elif chan_shards is None:
        chan_shards = n // time_shards
    if time_shards * chan_shards != n:
        raise ValueError(f"{time_shards}x{chan_shards} != {n} devices")
    arr = np.asarray(devices).reshape(time_shards, chan_shards)
    return Mesh(arr, axis_names=("time", "chan"))
