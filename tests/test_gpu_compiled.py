"""Compiled-GPU correctness gate — needs an NVIDIA GPU.

Everything else in the suite runs on the CPU (tests/conftest.py), where
the fused path runs its plain XLA version and the Triton kernel runs in
the Pallas interpreter.  These tests run the compiled artifacts on the
card against the f64 precise path:

    PLUTO_TEST_GPU=1 python -m pytest -m gpu tests/

chip_smoke.py runs exactly this before its own phases.  Whether a card
is there is decided inside the `gpu` fixture, so every process collects
the same tests.
"""

from __future__ import annotations

import numpy as np
import pytest

from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import params as pp
from pluto_gps_sim_tpu.ops import synth_fused as sf
from pluto_gps_sim_tpu.ops.synth_jnp import (
    pack_plan, synth_superframe_precise, synth_superframe_tiled)
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

pytestmark = pytest.mark.gpu

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])


@pytest.fixture(scope="module")
def gpu():
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "PLUTO_TEST_GPU=1 python -m pytest -m gpu tests/")
    return gpus[0]


@pytest.fixture(scope="module")
def plan4(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    sched = Scheduler(rin, g0, select_ephemeris_set(rin, g0),
                      np.asarray(llh2xyz(TOKYO)), fs=2_600_000.0)
    return pack_plan(sched.plan(4))


def _tracks_precise(got, golden):
    exact = float(np.mean(got == golden))
    err = int(np.abs(got.astype(np.int64) - golden.astype(np.int64)).max())
    assert exact >= 1.0 - 2e-6 and err <= 8, (exact, err)


def _args(dp):
    return (pp.build_block_params(dp), pp.pack_ca_tables([dp.ca2]),
            np.zeros(dp.n_blocks, np.int32), dp.block_samples)


def test_device_selection_picks_the_gpu(gpu):
    from pluto_gps_sim_tpu.runtime.device import synthesis_device

    assert synthesis_device() == gpu
    assert sf.kernel_for(gpu) == "triton"


def test_compiled_fused_vs_precise(gpu, plan4):
    out = sf.synth_blocks(*_args(plan4), device=gpu)
    assert out.devices() == {gpu}
    _tracks_precise(pp.unpack_iq(np.asarray(out)),
                    synth_superframe_precise(plan4))


def test_compiled_kernel_matches_xla_reference(gpu, plan4):
    import jax.numpy as jnp

    a = sf.synth_blocks(*_args(plan4), device=gpu)
    b = sf.synth_blocks(*_args(plan4), device=gpu, reference=True)
    assert bool(jnp.array_equal(a, b))


def test_compiled_tiled_vs_precise(gpu, plan4):
    _tracks_precise(synth_superframe_tiled(plan4, device=gpu),
                    synth_superframe_precise(plan4))
