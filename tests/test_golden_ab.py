"""Golden A/B tests: our synthesis vs the unmodified reference.

The reference C simulator (compiled against stub iio/curl libs, see
ref_harness/) is the ground-truth oracle.  For identical RINEX + scenario
inputs we require the int16 IQ streams to agree within the reference's own
quantization noise floor — measured as SNR = 10*log10(P_ref / P_diff).

The only mismatch sources are fp-rounding differences between the
reference's sequential per-sample NCOs (carr_phase += f*dt, c:2741) and
our closed-form ramps (frac(c0 + u*n)): an occasional one-sample chip-edge
or LUT-index jitter.  Empirically this sits at ~90 dB SNR with >99.9% of
samples bit-exact; the bound below (60 dB) leaves margin while still
catching any real modeling error (a wrong Doppler, gain, nav bit, or code
phase collapses SNR below ~20 dB immediately).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from ref_harness import harness

from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2, read_user_motion
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.stream import IqStream

N_BLOCKS = 4          # 0.4 s at fs=3 MHz (reference compile-time block size)
FS = 3_000_000.0      # TX_SAMPLE_FREQ (c:43): NUM_SAMPLES=300k == exactly 0.1 s
TOKYO_LLH = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])


def _snr_db(ref: np.ndarray, ours: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    diff = ref - ours.astype(np.float64)
    p_sig = float(np.mean(ref**2))
    p_err = float(np.mean(diff**2))
    if p_err == 0.0:
        return np.inf
    return 10.0 * np.log10(p_sig / p_err)


def _run_scenario(oracle_exe, tmp_path, nav_file, extra_args):
    cap = os.path.join(str(tmp_path), "capture.bin")
    stderr = harness.run_oracle(oracle_exe, nav_file, cap, N_BLOCKS,
                                extra_args=extra_args)
    blocks = harness.load_capture(cap)
    assert blocks.shape[0] >= N_BLOCKS - 1, \
        f"oracle produced {blocks.shape[0]} blocks; stderr:\n{stderr}"
    return blocks, stderr


def _our_stream(fixture_paths, xyz, n_blocks, *, iono=True, static=True,
                mode="precise"):
    rin = read_rinex2(fixture_paths["rinex2"])
    if not iono:
        rin.ionoutc.enable = False
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    stream = IqStream(rin, g0, ieph, xyz, fs=FS, static_mode=static,
                      mode=mode)
    out = stream.generate(n_blocks)        # [blocks, N, 2] int16
    return out


def _compare(ref_blocks, ours, min_snr_db=60.0, min_exact=0.99):
    n = min(ref_blocks.shape[0], ours.shape[0])
    ref = ref_blocks[:n].reshape(n, -1)
    got = ours[:n].reshape(n, -1)
    snr = _snr_db(ref, got)
    exact = float(np.mean(ref == got))
    assert snr >= min_snr_db, f"SNR {snr:.1f} dB < {min_snr_db} dB " \
        f"(bit-exact fraction {exact:.6f})"
    assert exact >= min_exact, f"bit-exact fraction {exact:.6f}"
    return snr, exact


def test_golden_static_default_location(oracle_exe, tmp_path, fixture_paths):
    """configs[0]: static receiver at the Tokyo default LLH, iono on.

    -l must be passed explicitly: the reference only converts llh->xyz
    inside the -l option handler (c:2322), so without it the receiver
    silently sits at the ECEF origin — a reference quirk we don't copy."""
    ref_blocks, _ = _run_scenario(oracle_exe, tmp_path,
                                  fixture_paths["rinex2"],
                                  ["-l", "35.681298,139.766247,10.0"])
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    ours = _our_stream(fixture_paths, xyz, ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"static/default: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_static_custom_location_iono_off(oracle_exe, tmp_path,
                                                fixture_paths):
    """configs[1]: -l lat,lon,h with -i (ionospheric delay disabled)."""
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex2"],
        ["-l", "30.286502,120.032669,100", "-i"])
    llh = np.array([30.286502 / R2D, 120.032669 / R2D, 100.0])
    xyz = np.asarray(llh2xyz(llh))
    ours = _our_stream(fixture_paths, xyz, ref_blocks.shape[0], iono=False)
    snr, exact = _compare(ref_blocks, ours)
    print(f"static/-l/-i: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_user_motion(oracle_exe, tmp_path, fixture_paths):
    """configs[2]: dynamic user motion (-u CSV, 10 Hz epochs)."""
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex2"],
        ["-u", fixture_paths["motion"]])
    xyz = read_user_motion(fixture_paths["motion"])
    ours = _our_stream(fixture_paths, xyz, ref_blocks.shape[0], static=False)
    snr, exact = _compare(ref_blocks, ours)
    print(f"motion: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_full_occupancy(oracle_exe, tmp_path, fixture_paths):
    """A location with 15 visible satellites: all 12 channel slots busy
    (the reference's worst case), 3 SVs skipped identically."""
    ref_blocks, _ = _run_scenario(oracle_exe, tmp_path,
                                  fixture_paths["rinex2"],
                                  ["-l", "30.0,-120.0,10.0"])
    llh = np.array([30.0 / R2D, -120.0 / R2D, 10.0])
    xyz = np.asarray(llh2xyz(llh))
    ours = _our_stream(fixture_paths, xyz, ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"full occupancy: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_rinex3(oracle_exe, tmp_path, fixture_paths):
    """RINEX v3 end-to-end: oracle -3 path vs our read_rinex3 -> IQ.

    Reference quirk: its getopt string declares `3:` (argument-taking,
    c:2296), so -3 consumes the NEXT token — put it last with a dummy
    argument or it silently eats another flag.  Our -3 is a plain flag."""
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex3"],
        ["-l", "35.681298,139.766247,10.0", "-3", "x"])
    from pluto_gps_sim_tpu.ingest import read_rinex3
    rin = read_rinex3(fixture_paths["rinex3"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    stream = IqStream(rin, g0, ieph, xyz, fs=FS, mode="precise")
    ours = stream.generate(ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"rinex3: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_fs5mhz_ref_compat(oracle_exe, tmp_path, fixture_paths):
    """configs[1] at -s 5000000.  The reference's NUM_SAMPLES is a
    compile-time 300,000 (c:44), so at fs=5 MHz each buffer spans only
    0.06 s of signal while scenario time still advances 0.1 s per buffer
    (c:2800) — an epoch-drift quirk.  Our scheduler reproduces it exactly
    when told block_samples=300000 at fs=5 MHz (normally it sizes blocks
    fs/10); the framework default is the corrected behavior."""
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex2"],
        ["-l", "35.681298,139.766247,10.0", "-s", "5000000"])
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    stream = IqStream(rin, g0, ieph, xyz, fs=5_000_000.0,
                      block_samples=300_000, mode="precise")
    ours = stream.generate(ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"fs=5MHz/ref-compat: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_ecef_and_start_time(oracle_exe, tmp_path, fixture_paths):
    """-c (ECEF static) + -t (validated start time) paths vs oracle."""
    from pluto_gps_sim_tpu.models.gpstime import GpsTime
    # Tokyo ECEF, start 30 s into the file's validity
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    ecef = f"{xyz[0]:.3f},{xyz[1]:.3f},{xyz[2]:.3f}"
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex2"],
        ["-c", ecef, "-t", "2023/01/10,00:00:30"])

    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, GpsTime(2244, 172830.0))
    ieph = select_ephemeris_set(rin, g0)
    # -c parses with %lf -> same doubles as our %.3f round-trip
    xyz_c = np.array([float(v) for v in ecef.split(",")])
    stream = IqStream(rin, g0, ieph, xyz_c, fs=FS, mode="precise")
    ours = stream.generate(ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"-c/-t: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_golden_time_overwrite(oracle_exe, tmp_path, fixture_paths):
    """-T: TOC/TOE overwritten to the (7200 s aligned) scenario start;
    exercises the ephemeris-shift branch (c:2521-2553).

    Reference quirk: its -T handler only parses the literal "now"
    (c:2331-2349) — a date passed to -T is silently ignored, so the
    overwrite branch needs -t <date> PLUS -T <anything>.  Our CLI
    accepts the date directly on -T (what the usage text advertises)."""
    from pluto_gps_sim_tpu.models.gpstime import GpsTime, date2gps, DateTime
    targ = "2023/03/05,04:00:00"
    ref_blocks, _ = _run_scenario(
        oracle_exe, tmp_path, fixture_paths["rinex2"],
        ["-l", "35.681298,139.766247,10.0", "-t", targ, "-T", "x"])

    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = date2gps(DateTime(2023, 3, 5, 4, 0, 0.0))
    g0 = setup_scenario(rin, g0, timeoverwrite=True)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    stream = IqStream(rin, g0, ieph, xyz, fs=FS, mode="precise")
    ours = stream.generate(ref_blocks.shape[0])
    snr, exact = _compare(ref_blocks, ours)
    print(f"-T overwrite: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_tiled_matches_precise(fixture_paths):
    """The tiled XLA path tracks the f64 golden path within its own
    (tighter) tolerance — one A/B inside the framework, no oracle needed."""
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    a = _our_stream(fixture_paths, xyz, 2, mode="precise")
    b = _our_stream(fixture_paths, xyz, 2, mode="tiled")
    snr = _snr_db(a.reshape(-1), b.reshape(-1))
    exact = float(np.mean(a == b))
    assert snr >= 70.0, f"tiled vs precise SNR {snr:.1f} dB"
    assert exact >= 0.999


def test_pallas_gain_above_unity(fixture_paths):
    """Regression: path_loss = 20200000/d exceeds 1.0 whenever the
    geometric range is below 20,200 km (routine near zenith for real
    ephemerides), making |trunc(table*gain)| > 512.  The kernel's biased
    packed accumulator must budget for it — with the old 512 bias a
    single-channel trough sample underflowed the low half and borrowed
    into Q (I came out ~ +65021 instead of ~ -515)."""
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import (pack_plan,
                                                 synth_superframe_precise)
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    sched = Scheduler(rin, g0, ieph, xyz, fs=1_000_000.0,
                      block_samples=65_536)
    plan = sched.plan(1)
    # keep exactly one channel, pushed above unity gain
    first = int(np.flatnonzero(plan.active[0])[0])
    act = np.zeros_like(plan.active)
    act[:, first] = True
    plan.active = act
    gain = plan.gain.copy()
    # 1.0503761...: irrational-ish so T*g rarely lands integer-adjacent
    # (a rational like 1.05 = 21/20 makes ~5% of products straddle
    # integers, where f32-vs-f64 scaling rounding legitimately differs
    # by 1 LSB)
    gain[:, first] *= 1.0503761437 / gain[:, first].max()
    plan.gain = gain
    dp = pack_plan(plan)

    golden = synth_superframe_precise(dp)
    prm = sp.build_block_params(dp)
    assert prm.patch_dropped == 0
    ca_tabs = sp.pack_ca_tables([dp.ca2])
    packed = np.asarray(synth_blocks(
        prm, ca_tabs, np.zeros(1, np.int32), dp.block_samples))
    n = dp.block_samples
    iq = np.stack([(packed[:, :n] & 0xFFFF).astype(np.uint16).view(np.int16),
                   (packed[:, :n] >> 16).astype(np.int16)], axis=-1)
    assert golden.min() < -520, "scenario failed to exceed unity gain"
    diff = np.abs(golden.astype(np.int64) - iq.astype(np.int64))
    # the underflow bug produced ~65536-sized wraps; scaling-rounding
    # noise is at most 1 LSB
    assert diff.max() <= 1, f"gain>1 corruption: max diff {diff.max()}"
    assert float(np.mean(diff == 0)) >= 0.99


def test_pallas_matches_precise(fixture_paths):
    """The fused path (its plain XLA version on the CPU) against the f64
    golden path."""
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    xyz = np.asarray(llh2xyz(TOKYO_LLH))

    fs = 2_600_000.0  # also exercises a non-tile-aligned block size
    sched_a = Scheduler(rin, g0, ieph, xyz, fs=fs)
    plan = sched_a.plan(2)
    dp = pack_plan(plan)

    from pluto_gps_sim_tpu.ops.synth_jnp import synth_superframe_precise
    golden = synth_superframe_precise(dp)           # [M, N, 2] int16

    prm = sp.build_block_params(dp)
    assert prm.patch_dropped == 0
    ca_tabs = sp.pack_ca_tables([dp.ca2])
    sf_map = np.zeros(dp.n_blocks, np.int32)
    packed = np.asarray(synth_blocks(
        prm, ca_tabs, sf_map, dp.block_samples))
    n = dp.block_samples
    iq = packed[:, :n].view(np.int16).reshape(dp.n_blocks, n, 2) \
        if packed.dtype == np.int32 else packed
    # int32 (I | Q<<16) little-endian == interleaved int16 I,Q
    iq = np.stack([(packed[:, :n] & 0xFFFF).astype(np.uint16).view(np.int16),
                   (packed[:, :n] >> 16).astype(np.int16)], axis=-1)
    # round 3: with the gain-trunc patch words and the three-level
    # carrier residual the kernel reproduces the f64 golden path
    # sample-exactly on this scenario (deterministic — same fixture,
    # same arithmetic every run)
    exact = float(np.mean(golden == iq))
    max_err = int(np.abs(iq.astype(np.int64)
                         - golden.astype(np.int64)).max())
    assert np.array_equal(iq, golden), \
        f"fused vs precise: bit-exact {exact:.6%}, max err {max_err}"


def test_golden_10s_drift(oracle_exe, tmp_path, fixture_paths):
    """Mid-length (10 s, 100 blocks) A/B in the DEFAULT suite: catches
    slow carrier/code-chain drift that 0.4 s scenarios cannot (the
    per-block f64 carrier-phase chain, scheduler.py, vs the reference's
    per-sample wrap c:2741-2746), without the RUN_SOAK gate.  Runs the
    production tiled path, which must match the f64 precise path
    bit-for-bit (four-level NCO) and the oracle at its fp-noise floor."""
    n_blocks = 100
    cap = os.path.join(str(tmp_path), "capture10.bin")
    harness.run_oracle(oracle_exe, fixture_paths["rinex2"], cap,
                       n_blocks + 20,
                       extra_args=["-l", "35.681298,139.766247,10.0"],
                       push_sleep_ms=60, timeout=300.0)
    ref_blocks = harness.load_capture(cap)
    assert ref_blocks.shape[0] >= n_blocks
    ref_blocks = ref_blocks[:n_blocks]

    xyz = np.asarray(llh2xyz(TOKYO_LLH))
    ours = _our_stream(fixture_paths, xyz, n_blocks, mode="tiled")
    # measured: 87-91 dB / >99.98% (floor: one chip-edge flip from the
    # reference's sequential-accumulation rounding costs ~30 dB on one
    # of the 100 blocks -> ~68 dB total if it happens to land here)
    snr, exact = _compare(ref_blocks, ours, min_snr_db=65.0,
                          min_exact=0.998)
    print(f"10s drift A/B: SNR {snr:.1f} dB, bit-exact {exact:.4%}")


def test_doppler_resonant_block_tracks_precise(fixture_paths):
    """Regression for the round-3 carrier fix: a channel whose Doppler
    puts frac(f_carr/fs)*512 within ~1e-9 of an integer keeps the 9-bit
    LUT index riding a boundary for the whole block.  The original
    single-level f32 carrier residual (error +-1 u32 unit) collected
    ~2k adjacent-LUT picks per such block; the two-level Q12+f32
    residual (error 2^-12 units) must track the f64 precise path
    sample-exactly here."""
    from pluto_gps_sim_tpu.constants import MAX_CHAN
    from pluto_gps_sim_tpu.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, synth_superframe_precise, synth_superframe_tiled)
    from pluto_gps_sim_tpu.runtime.scheduler import SuperframePlan

    fs = 2_600_000.0
    N = 65536  # short block, CPU friendly
    C = MAX_CHAN
    rng = np.random.RandomState(11)

    active = np.zeros((1, C), bool)
    active[0, :4] = True
    # channel 0: resonant Doppler (frac(u)*512 = 3 + 1e-9); channels
    # 1-3: ordinary Dopplers
    delt = 1.0 / fs
    f_carr = np.zeros((1, C))
    f_carr[0, 0] = ((3.0 + 1e-9) / 512.0) / delt
    f_carr[0, 1:4] = [-2717.3, 395.9, -967.7]
    f_code = 1_023_000.0 + f_carr / 1540.0
    plan = SuperframePlan(
        n_blocks=1, block_samples=N, delt=delt,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active,
        f_carr=f_carr, f_code=f_code,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=np.where(active, 0.8, 0.0),
        azel=np.zeros((1, C, 2)),
    )
    dp = pack_plan(plan)
    golden = synth_superframe_precise(dp)
    packed = np.asarray(synth_blocks(
        sp.build_block_params(dp), sp.pack_ca_tables([dp.ca2]),
        np.zeros(1, np.int32), N))[:, :N]
    got = np.stack([(packed & 0xFFFF).astype(np.uint16).view(np.int16),
                    (packed >> 16).astype(np.int16)], axis=-1)
    bad = int((got != golden).sum())
    assert bad == 0, f"{bad} components diverge on the resonant block"
    tiled = synth_superframe_tiled(dp)
    assert np.array_equal(tiled, golden), "tiled diverges on resonance"


def test_gain_trunc_patch_exact(fixture_paths):
    """Regression for the gain-trunc boundary handling: the kernel's
    per-sample iv = trunc(f32(T)*f32(g)) differs from the f64 tables'
    trunc(T*g) by 1 LSB on LUT entries whose product lands within f32
    rounding of an integer (~0.02 entries/block on real scenarios).
    build_block_params detects these host-side and (round 5) NUDGES the
    f32 gain lane a few ulps so the kernel's truncs match the f64 tables
    outright; the legacy patch-word path (nudge=False) must also still
    reproduce the f64 precise path sample-exactly via the in-kernel
    row patch pass (ops.params._SLOT_I et al.)."""
    from pluto_gps_sim_tpu.constants import MAX_CHAN
    from pluto_gps_sim_tpu.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, synth_superframe_precise)
    from pluto_gps_sim_tpu.runtime.scheduler import SuperframePlan

    # this gain puts 405*g within f32 rounding of an integer:
    # trunc_f64 = 367, trunc_f32 = 368 (405 appears in both LUT halves)
    g_boundary = 0.9086419713826426
    assert (np.trunc(405 * g_boundary)
            != float(np.trunc(np.float32(405) * np.float32(g_boundary)))), \
        "test gain no longer sits on a trunc boundary"

    fs = 2_600_000.0
    N = 65536
    C = MAX_CHAN
    rng = np.random.RandomState(7)
    active = np.zeros((1, C), bool)
    active[0, :3] = True
    f_carr = np.zeros((1, C))
    f_carr[0, :3] = [-2717.3, 395.9, -967.7]
    f_code = 1_023_000.0 + f_carr / 1540.0
    gain = np.where(active, 0.5, 0.0)
    gain[0, 1] = g_boundary
    plan = SuperframePlan(
        n_blocks=1, block_samples=N, delt=1.0 / fs,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=f_code,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=gain, azel=np.zeros((1, C, 2)))
    dp = pack_plan(plan)
    golden = synth_superframe_precise(dp)

    def run(prmi_, prmf_):
        packed = np.asarray(synth_blocks(
            (prmi_, prmf_), sp.pack_ca_tables([dp.ca2]),
            np.zeros(1, np.int32), N))[:, :N]
        return np.stack(
            [(packed & 0xFFFF).astype(np.uint16).view(np.int16),
             (packed >> 16).astype(np.int16)], axis=-1)

    # production path (nudge): the boundary gain's lane moves a few ulps
    # and NO patch words are needed; output matches f64 sample-exactly
    prmi, prmf, n_dropped = sp.build_block_params(dp)
    assert n_dropped == 0
    words = np.array([prmf[0, sp.patch_word_lane(k)]
                      for k in range(sp._N_PATCH)])
    assert int((words != 0).sum()) == 0, \
        "nudge should clear the single-magnitude boundary without patches"
    assert prmf[0, sp._F_GAIN + 1] != np.float32(g_boundary), \
        "gain lane was not nudged"
    got = run(prmi, prmf)
    assert np.array_equal(got, golden), (
        f"{int((got != golden).sum())} components diverge with nudge on")

    # legacy patch-word path (nudge=False): one word per LUT half,
    # applied in-kernel, same exact output
    prmi_p, prmf_p, n_dropped_p = sp.build_block_params(dp, nudge=False)
    assert n_dropped_p == 0
    words_p = np.array([prmf_p[0, sp.patch_word_lane(k)]
                        for k in range(sp._N_PATCH)])
    assert int((words_p != 0).sum()) == 2, \
        "expected one patch word per LUT half for |T|=405"
    got_p = run(prmi_p, prmf_p)
    assert np.array_equal(got_p, golden), (
        f"{int((got_p != golden).sum())} components diverge with patches on")

    # discrimination: with the patch lanes zeroed the boundary gain MUST
    # reproduce the 1-LSB divergence, or this test is exercising nothing
    prmf_no = prmf_p.copy()
    for k in range(sp._N_PATCH):
        prmf_no[:, sp.patch_word_lane(k)] = 0.0
    got_no = run(prmi_p, prmf_no)
    bad = int((got_no != golden).sum())
    assert bad > 0, "unpatched kernel unexpectedly exact (dead test)"
    assert int(np.abs(got_no.astype(np.int64)
                      - golden.astype(np.int64)).max()) == 1


def test_gain_trunc_patch_overflow_degrades_gracefully(fixture_paths):
    """A gain within ~2^-25 of a small rational (here ~17/31) flips many
    LUT magnitudes at once — more than the per-block patch slots.  With
    nudging disabled (nudge=False, pinning the legacy pure-patch path and
    the kernel's overflow machinery) the builder must NOT fail: it
    patches what fits, counts the rest in the returned
    BlockParams.patch_dropped, and the unpatched entries stay within the
    kernel's +-1 LSB f32-trunc behavior.  The production path (nudge on)
    must resolve the SAME gain with zero patch words, zero drops, and a
    sample-exact output — the round-5 closure of the _N_PATCH hole."""
    from pluto_gps_sim_tpu.constants import MAX_CHAN
    from pluto_gps_sim_tpu.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, synth_superframe_precise)
    from pluto_gps_sim_tpu.runtime.scheduler import SuperframePlan

    g_rational = 0.5483870934593348   # ~17/31 - 3e-9: 16 patch words
    t64 = np.trunc(sp._MAGS64 * g_rational)
    t32 = np.trunc(sp._MAGS64.astype(np.float32) * np.float32(g_rational))
    n_flip = int((t64 != t32.astype(np.float64)).sum())
    assert n_flip >= 8, "gain no longer overflows the patch slots"

    fs = 2_600_000.0
    N = 65536
    C = MAX_CHAN
    rng = np.random.RandomState(5)
    active = np.zeros((1, C), bool)
    active[0, :2] = True
    f_carr = np.zeros((1, C))
    f_carr[0, :2] = [-2717.3, 395.9]
    f_code = 1_023_000.0 + f_carr / 1540.0
    gain = np.where(active, 0.5, 0.0)
    gain[0, 0] = g_rational
    plan = SuperframePlan(
        n_blocks=1, block_samples=N, delt=1.0 / fs,
        prn=np.where(active[0], np.arange(1, C + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(C)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (C, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=f_code,
        code_phase=rng.uniform(0, 1023, (1, C)),
        icode=rng.randint(0, 20, (1, C)).astype(np.int32),
        ibit=rng.randint(0, 30, (1, C)).astype(np.int32),
        iword=rng.randint(0, 10, (1, C)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (1, C)),
        gain=gain, azel=np.zeros((1, C, 2)))
    dp = pack_plan(plan)
    golden = synth_superframe_precise(dp)

    def run(prmi_, prmf_):
        packed = np.asarray(synth_blocks(
            (prmi_, prmf_), sp.pack_ca_tables([dp.ca2]),
            np.zeros(1, np.int32), N))[:, :N]
        return np.stack(
            [(packed & 0xFFFF).astype(np.uint16).view(np.int16),
             (packed >> 16).astype(np.int16)], axis=-1)

    # legacy pure-patch path: slots saturate, the rest is counted and
    # degrades to +-1 LSB
    prmi, prmf, n_dropped = sp.build_block_params(dp, nudge=False)
    assert n_dropped == n_flip * 2 - sp._N_PATCH
    words = np.array([prmf[0, sp.patch_word_lane(k)]
                      for k in range(sp._N_PATCH)])
    assert int((words != 0).sum()) == sp._N_PATCH, "slots not saturated"
    err = np.abs(run(prmi, prmf).astype(np.int64)
                 - golden.astype(np.int64))
    assert int(err.max()) <= 1, "overflow degradation exceeded 1 LSB"

    # production path: the same-direction burst nudges away entirely —
    # zero words, zero drops, sample-exact
    prmi_n, prmf_n, n_dropped_n = sp.build_block_params(dp)
    assert n_dropped_n == 0, "nudge failed to absorb the rational gain"
    words_n = np.array([prmf_n[0, sp.patch_word_lane(k)]
                        for k in range(sp._N_PATCH)])
    assert int((words_n != 0).sum()) == 0
    got_n = run(prmi_n, prmf_n)
    assert np.array_equal(got_n, golden), (
        f"{int((got_n != golden).sum())} components diverge with nudge on")


def test_patch_prefilter_matches_dense_sweep_on_real_scenario(fixture_paths):
    """The interval+f32 prefilter in build_block_params must find EXACTLY
    the gain-trunc mismatches a dense f64-vs-f32 sweep over every
    (block, channel, magnitude) triple finds — including the drop count
    when a block's demand overflows the patch slots.  Pinned (with
    nudge=False, the pure-patch path) on a real scenario superframe that
    actually drops (round-4 bench streams reported nonzero
    patch_dropped_stream here; a captured run showed one block demanding
    8 words with 7 slots, caused by gains like ~37/62 + ~9/10 dwelling
    together), so both the candidate set AND the overflow accounting are
    checked against ground truth.  The production path (nudge on) must
    clear the SAME span with zero drops and zero residual patch words —
    the round-5 bench/soak zero-drop guarantee on its worst measured
    input."""
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    sched = Scheduler(rin, g0, ieph, np.asarray(llh2xyz(TOKYO_LLH)),
                      fs=2_600_000.0)
    sched.skip(300)                    # the bench child's first rep start
    total_dropped = 0
    checked = 0
    nudged_words = nudged_drops = 0
    for plan in sched.plan_group(8, 300):
        dp = pack_plan(plan, tables=False)
        # production path first: zero drops AND zero residual words on
        # the span that used to overflow
        bp_n = sp.build_block_params(dp)
        nudged_drops += bp_n.patch_dropped
        nudged_words += int(np.count_nonzero(
            np.stack([bp_n.prmf[:, sp.patch_word_lane(k)]
                      for k in range(sp._N_PATCH)], axis=1)))
        bp = sp.build_block_params(dp, nudge=False)
        # dense ground truth over every (block, channel, magnitude)
        g = np.where(dp.active, dp.gain, 0.0)
        t64 = np.trunc(g[:, :, None] * sp._MAGS64[None, None, :])
        t32 = np.trunc(g.astype(np.float32)[:, :, None]
                       * sp._MAGS64.astype(np.float32)[None, None, :])
        mism = (t64 != t32.astype(np.float64)) & dp.active[:, :, None]
        m_i, c_i, j_i = np.nonzero(mism)
        demand = np.zeros(dp.active.shape[0], np.int64)
        for m, j in zip(m_i, j_i):
            demand[m] += int(sp._MAG_IN_COS[j]) + int(sp._MAG_IN_SIN[j])
        over = int(np.maximum(demand - sp._N_PATCH, 0).sum())
        n_patched = int(np.count_nonzero(
            np.stack([bp.prmf[:, sp.patch_word_lane(k)]
                      for k in range(sp._N_PATCH)], axis=1)))
        assert bp.patch_dropped == over, \
            (bp.patch_dropped, over, "prefilter drop count != ground truth")
        assert n_patched == int(demand.sum()) - over, \
            "patched word count != ground-truth demand minus overflow"
        total_dropped += bp.patch_dropped
        checked += 1
    assert checked == 8
    assert total_dropped >= 1, \
        "scenario no longer overflows anywhere; pin a new dropping span"
    assert nudged_drops == 0 and nudged_words == 0, \
        (nudged_drops, nudged_words,
         "nudge left residual patch demand on the pinned dropping span")
