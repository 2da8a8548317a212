"""Monte-Carlo batch synthesis: batched == per-trajectory, and sharded
== unsharded (BASELINE configs[4])."""

from __future__ import annotations

import numpy as np
import pytest

from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.parallel import MonteCarloBatch, make_mesh
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.stream import IqStream

FS = 1_000_000.0
BS = 16_384  # small blocks keep the CPU runs fast


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    return rin, g0, ieph


def _perturbed_receivers(b: int) -> np.ndarray:
    """B receivers scattered ~km around Tokyo."""
    rng = np.random.RandomState(5)
    base = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
    out = []
    for i in range(b):
        llh = base + np.array([rng.uniform(-1e-4, 1e-4),
                               rng.uniform(-1e-4, 1e-4),
                               rng.uniform(0, 100)])
        out.append(np.asarray(llh2xyz(llh)))
    return np.stack(out)


def test_mc_matches_individual_streams(scenario):
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(3)
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    batch = mc.generate(n_blocks=4)
    assert batch.shape == (3, 4, BS, 2)

    for b in range(3):
        solo = IqStream(rin, g0, ieph, xyz[b], fs=FS, block_samples=BS,
                        mode="tiled").generate(4)
        # fused vs tiled: not bit-identical paths (f32 vs f64 gain
        # truncation up to the nudge/patch floor), compare
        # by SNR and near-total sample equality
        ref = solo.astype(np.float64)
        diff = ref - batch[b].astype(np.float64)
        snr = 10 * np.log10(ref.var() / max(diff.var(), 1e-30))
        exact = np.mean(solo == batch[b])
        assert snr > 70.0 and exact > 0.995, (b, snr, exact)


def test_mc_sharded_matches_unsharded(scenario):
    import jax
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(4)
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    a = mc.generate(n_blocks=2)

    mc2 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    mesh = make_mesh(jax.devices("cpu")[:8])  # 4 time x 2 chan or similar
    b = mc2.generate(n_blocks=2, mesh=mesh)
    assert np.array_equal(a, b)


def test_mc_rejects_bad_shapes(scenario):
    rin, g0, ieph = scenario
    with pytest.raises(ValueError):
        MonteCarloBatch(rin, g0, ieph, np.zeros((2, 3, 3, 1)), fs=FS)


def test_mc_mesh_padding_small_batch(scenario):
    """Regression: B*n_blocks smaller than the time-shard count must pad
    up (zeros_like(prmi[:pad]) under-padded when pad > M)."""
    import jax
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(1)
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    mesh = make_mesh(jax.devices("cpu")[:8], time_shards=4, chan_shards=2)
    iq = mc.generate(n_blocks=1, mesh=mesh)  # 1 block over 4 time shards
    assert iq.shape == (1, 1, BS, 2)

    mc2 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    ref = mc2.generate(n_blocks=1)
    assert np.array_equal(iq, ref)


def test_mc_chunked_launches_match_single(scenario):
    """generate(chunk_blocks=...) must be bit-identical to one launch
    (it exists to bound HBM at B=256-scale batches)."""
    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(3)
    mc1 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    one = mc1.generate(n_blocks=4)
    mc2 = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)
    chunked = mc2.generate(n_blocks=4, chunk_blocks=5)
    assert np.array_equal(one, chunked)


def test_mc_boundary_branch_matches_individual(scenario):
    """Exercise the batched 30 s-boundary path (alloc precomp with the
    post-rollover eph set, shared NavCache init=False refresh) by
    starting 0.4 s before a boundary: plan 8 blocks -> the first plan
    hits the boundary, the second continues past it.  Must equal the
    unbatched per-receiver streams bit-for-bit."""
    from pluto_gps_sim_tpu.models.gpstime import inc_gps_time

    rin, g0, ieph = scenario
    # move the scenario clock to 0.4 s before the next 30 s boundary
    rem = (30.0 - (g0.sec % 30.0)) % 30.0
    g0b = inc_gps_time(g0, rem + 30.0 - 0.4)
    xyz = _perturbed_receivers(3)

    mc = MonteCarloBatch(rin, g0b, ieph, xyz, fs=FS, block_samples=BS)
    batch = mc.generate(n_blocks=8)
    assert mc.nav_cache.hits > 0, "shared nav cache never hit"

    for b in range(xyz.shape[0]):
        solo = IqStream(rin, g0b, ieph, xyz[b], fs=FS, block_samples=BS,
                        mode="fused").generate(8)
        assert np.array_equal(batch[b], solo), f"receiver {b} diverges " \
            "across the 30 s boundary"


def test_mc_streaming_superframes_match_monolithic(scenario):
    """superframes() streams (offset, chunk) pairs whose concatenation
    equals generate() — the bounded-host-RSS consumer for batches whose
    full IQ (B=256 x 300 blocks ~ 80 GB) must never materialize."""
    import zlib

    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(3), fs=FS,
                         block_samples=BS)
    mono = mc.generate(7)           # [3, 7, N, 2]

    mc2 = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(3), fs=FS,
                          block_samples=BS)
    crc_mono = [zlib.crc32(mono.reshape(21, BS, 2)[r].tobytes())
                for r in range(21)]
    seen = 0
    for off, iq in mc2.superframes(7, chunk_blocks=4):
        assert off == seen and iq.shape[0] <= 4
        for j in range(iq.shape[0]):
            assert zlib.crc32(iq[j].tobytes()) == crc_mono[off + j], \
                f"chunk CRC mismatch at global block {off + j}"
        seen += iq.shape[0]
    assert seen == 21


def test_mc_streaming_as_device(scenario):
    """as_device=True yields packed device arrays (no host fetch); their
    manual unpack equals the host path."""
    rin, g0, ieph = scenario
    mc = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                         block_samples=BS)
    mono = mc.generate(3).reshape(6, BS, 2)
    mc2 = MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=FS,
                          block_samples=BS)
    got = []
    for off, dev in mc2.superframes(3, chunk_blocks=3,
                                    as_device=True):
        packed = np.asarray(dev)[:, :BS]
        got.append(np.stack(
            [(packed & 0xFFFF).astype(np.uint16).view(np.int16),
             (packed >> 16).astype(np.int16)], axis=-1))
    assert np.array_equal(np.concatenate(got, axis=0), mono)


def test_mc_union_resolve_branch_matches_per_receiver(scenario):
    """plan_blocks' union-of-allocated-SVs solve has a re-solve guard
    for boundary re-allocations that claim an SV outside the solved
    union (montecarlo.py).  Drive 40 superframes (20 min — the window
    the plan_group re-solve test uses, with real rise/set churn) at B=2
    and assert (a) the guard actually FIRED (more batched solves than
    eph-run/epoch-cap chunks), and (b) the packed parameter planes are
    bit-identical to independent per-receiver Schedulers planning the
    same span — the ground truth nothing else checks at churn scale."""
    import pluto_gps_sim_tpu.parallel.montecarlo as mcm
    from pluto_gps_sim_tpu.models.lnav import NavCache
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

    rin, g0, ieph = scenario
    xyz = _perturbed_receivers(2)
    n_blocks = 40 * 300
    mc = MonteCarloBatch(rin, g0, ieph, xyz, fs=FS, block_samples=BS)

    # expected chunk count from the shared span simulation (state is
    # untouched by simulate_spans)
    spans = mc.scheds[0].simulate_spans(total_blocks=n_blocks)
    chunks = 0
    i = 0
    while i < len(spans):
        j, total = i, spans[i][1]
        while (j + 1 < len(spans) and spans[j + 1][2] == spans[i][2]
               and total + spans[j + 1][1] + 1
               <= MonteCarloBatch._SOLVE_CHUNK_EPOCHS):
            j += 1
            total += spans[j][1]
        chunks += 1
        i = j + 1

    sv0 = [s.state.sv_idx.copy() for s in mc.scheds]
    calls = []
    orig = mcm.solve_ranges_batch_lean

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    mcm.solve_ranges_batch_lean = spy
    try:
        prmi, prmf, ca2, sf_map = mc.plan_blocks(n_blocks)
    finally:
        mcm.solve_ranges_batch_lean = orig

    assert any(not np.array_equal(a, s.state.sv_idx)
               for a, s in zip(sv0, mc.scheds)), \
        "scenario never re-allocated channels; guard untested"
    assert len(calls) > chunks, \
        (len(calls), chunks,
         "union re-solve branch never fired; pin a churnier span")
    assert mc.patch_dropped == 0

    # ground truth: independent per-receiver schedulers over the same
    # span (fresh NavCache per receiver — nav products are content-
    # keyed, so sharing changes nothing)
    for b in range(2):
        sched = Scheduler(rin, g0, ieph, xyz[b], fs=FS, block_samples=BS,
                          nav_cache=NavCache())
        plans, done = [], 0
        while done < n_blocks:
            p = sched.plan(n_blocks - done)
            plans.append(p)
            done += p.n_blocks
        bp = sp.build_group_params(
            [pack_plan(p, tables=False) for p in plans])
        lo = b * n_blocks
        assert np.array_equal(prmi[lo:lo + n_blocks], bp.prmi), b
        assert np.array_equal(prmf[lo:lo + n_blocks], bp.prmf), b


def test_mc_rejects_blocks_beyond_kernel_range(scenario):
    """fs > 5.24 MHz exceeds the fused kernel's Q24 block range; the
    single-receiver stream splits transparently but the batch path does
    not — MonteCarloBatch must fail with guidance at construction, not
    with the kernel builder's bare assert mid-plan."""
    rin, g0, ieph = scenario
    with pytest.raises(ValueError, match="Q24 range"):
        MonteCarloBatch(rin, g0, ieph, _perturbed_receivers(2), fs=10e6)
