"""Physically-plausible synthetic kernel parameters without RINEX ingest.

Used by the driver compile checks (__graft_entry__) and the multi-process
dryrun so sharding tests need no fixture files: frequencies, phases, and
gains are drawn in the ranges the epoch solve produces for real GPS
geometry (f_carr within +-4 kHz Doppler, code rate tied by the 1/1540
carrier-to-code ratio, plutogpssim.c:1763-1764).
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_params"]


def synthetic_params(n_blocks: int, block_samples: int, seed: int = 3):
    """Returns (prmi, prmf, ca_tabs, sf_map) for the fused synthesis."""
    import jax  # noqa: F401  (triggers x64 config via package import)

    from ..constants import CODE_FREQ, MAX_CHAN
    from ..models.cacode import CA_TABLE
    from ..ops import params as pp
    from ..ops.synth_jnp import TILE, DevicePlan

    rng = np.random.RandomState(seed)
    M, C = n_blocks, MAX_CHAN
    # keep the implied sample rate >= 1.05 MHz so the C/A code rate per
    # sample stays inside the kernel's chip-arithmetic bound (v <= 1.1)
    fs = max(block_samples * 10.0, 1_050_000.0)
    delt = 1.0 / fs
    f_carr = rng.uniform(-4000.0, 4000.0, (M, C))
    f_code = CODE_FREQ + f_carr / 1540.0
    z3 = np.zeros((M, C, 1), np.int32)
    dp = DevicePlan(
        n_blocks=M, block_samples=block_samples,
        n_tiles=-(-block_samples // TILE),
        ca2=(CA_TABLE[:C] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=np.ones((M, C), bool),
        u=f_carr * delt, v=f_code * delt,
        c0=rng.uniform(0, 1, (M, C)),
        cp0=rng.uniform(0, 1023, (M, C)),
        b0=rng.randint(300, 1500, (M, C)).astype(np.int32),
        ic0=rng.randint(0, 20, (M, C)).astype(np.int32),
        gain=rng.uniform(0.3, 1.0, (M, C)),
        qcos_pm=np.zeros((M, C, 1024), np.int32),
        qsin_pm=np.zeros((M, C, 1024), np.int32),
        v_q12=np.zeros((M, C), np.int32), r24=np.zeros((M, C), np.int32),
        r36=np.zeros((M, C), np.int32), rrr=np.zeros((M, C), np.float32),
        step_u32=np.zeros((M, C), np.int32),
        sr12=np.zeros((M, C), np.int32),
        srem=np.zeros((M, C), np.float32),
        code_q12=z3, code_q24=z3, code_q36=z3, carr_u32=z3, carr_q12=z3,
    )
    prmi, prmf, _ = pp.build_block_params(dp)
    ca_tabs = pp.pack_ca_tables([dp.ca2])
    sf_map = np.zeros(M, np.int32)
    return prmi, prmf, ca_tabs, sf_map
