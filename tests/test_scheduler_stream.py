"""Scheduler / stream control-plane tests: 30 s boundary updates,
ephemeris-set rollover, superframe-split invariance, rise/set handling,
snapshot/restore.

These exercise the host control plane the reference runs inline in its
generation loop (plutogpssim.c:2762-2798) — nav refresh, rollover,
re-allocation — and the design property that makes time-block
sharding legal: any split of the block stream into superframes yields
bit-identical IQ.
"""

from __future__ import annotations

import numpy as np
import pytest

from pluto_gps_sim_tpu.constants import R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models import lnav
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.models.gpstime import GpsTime, inc_gps_time
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler
from pluto_gps_sim_tpu.runtime.stream import IqStream

TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])
FS = 1_000_000.0


@pytest.fixture(scope="module")
def rinex(fixture_paths):
    return read_rinex2(fixture_paths["rinex2"])


def _xyz():
    return np.asarray(llh2xyz(TOKYO))


def test_superframe_boundary_alignment(rinex):
    """plan() must stop exactly at 30 s boundaries so nav/alloc updates
    land where the reference's inline loop runs them (c:2762)."""
    g0 = setup_scenario(rinex, None)
    sched = Scheduler(rinex, g0, select_ephemeris_set(rinex, g0), _xyz(),
                      fs=FS)
    p1 = sched.plan(1000)
    assert p1.n_blocks == 300  # t0 is a 30 s boundary -> full superframe
    p2 = sched.plan(7)         # partial plans still advance correctly
    assert p2.n_blocks == 7
    p3 = sched.plan(1000)
    assert p3.n_blocks == 293  # stops at the next boundary


def test_ephemeris_rollover(rinex):
    """Starting 29:30 into set 0's validity, the next set (toc +2 h) comes
    within 1 h after 30 s of signal -> ieph advances and subframes are
    rebuilt from the new set (c:2774-2790)."""
    toc0 = GpsTime(int(rinex.eph[0].toc_week[0]),
                   float(rinex.eph[0].toc_sec[0]))
    g0 = inc_gps_time(toc0, 3570.0)
    g0 = setup_scenario(rinex, g0)
    ieph = select_ephemeris_set(rinex, g0)
    assert ieph == 0
    sched = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)

    sched.plan(300)            # boundary at +30 s: dt == 3600, not yet (<)
    assert sched.ieph == 0
    sched.plan(300)            # boundary at +60 s: dt == 3570 -> rollover
    assert sched.ieph == 1, "rollover did not advance the ephemeris set"
    st = sched.state
    c = int(np.flatnonzero(st.prn > 0)[0])
    want = lnav.eph_to_subframes(rinex.eph[1], int(st.prn[c]) - 1,
                                 rinex.ionoutc)
    assert np.array_equal(st.sbf[c], want), "subframes not rebuilt"


def test_split_invariance(rinex):
    """Any superframe split yields bit-identical IQ — the property that
    lets time-blocks shard freely across chips/hosts."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)

    def run(max_blocks):
        s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
        return s.generate(12), s

    a, _ = run(None)
    for split in (1, 5):
        b_stream = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
        parts = list(b_stream.superframes(12, max_blocks=split))
        b = np.concatenate(parts, axis=0)
        assert np.array_equal(a, b), f"split={split} changed the stream"


def test_rise_set_reallocation(rinex):
    """Channels free when satellites set and new ones claim freed slots;
    allocated_sat stays consistent (c:1936-1985 semantics)."""
    g0 = setup_scenario(rinex, None)
    sched = Scheduler(rinex, g0, select_ephemeris_set(rinex, g0), _xyz(),
                      fs=FS)
    seen = set()
    for _ in range(20):  # 10 minutes of scenario time
        sched.plan(300)
        st = sched.state
        active = np.flatnonzero(st.prn > 0)
        seen.update(int(st.prn[c]) for c in active)
        # invariant: allocated_sat maps sv -> channel and back
        for sv in range(st.allocated_sat.size):
            ch = int(st.allocated_sat[sv])
            if ch >= 0:
                assert int(st.prn[ch]) == sv + 1
        for c in active:
            assert int(st.allocated_sat[int(st.prn[c]) - 1]) == c
    assert len(seen) >= 7  # constellation rotates through the sky


def test_snapshot_restore_roundtrip(rinex):
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    s1 = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
    a1 = s1.generate(4)
    snap = s1.snapshot()
    a2 = s1.generate(4)

    s2 = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
    s2.generate(4)  # advance to the same point
    s2.restore(snap)
    b2 = s2.generate(4)
    assert np.array_equal(a2, b2)


def test_motion_wraparound(fixture_paths, rinex):
    """Motion index wraps at EOF like the reference (c:2802-2805)."""
    from pluto_gps_sim_tpu.ingest import read_user_motion
    xyz = read_user_motion(fixture_paths["motion"])
    g0 = setup_scenario(rinex, None)
    sched = Scheduler(rinex, g0, select_ephemeris_set(rinex, g0), xyz,
                      fs=FS, static_mode=False)
    n = xyz.shape[0]
    assert sched._motion_index(0) == 0
    assert sched._motion_index(1) == 0        # iumd increments at loop end
    assert sched._motion_index(n) == n - 1
    assert sched._motion_index(n + 1) == 0    # wrap


def test_stream_mesh_sharded_matches_single(rinex):
    """IqStream(mesh=...) — full production stream over a (time, chan)
    mesh — equals the single-device fused stream bit-for-bit."""
    import jax
    from pluto_gps_sim_tpu.parallel import make_mesh

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    a = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=32768,
                 mode="fused").generate(3)
    mesh = make_mesh(jax.devices("cpu")[:8])
    # 3 blocks over 2 time shards also exercises the pad-to-shards path
    b = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=32768,
                 mode="fused", mesh=mesh).generate(3)
    assert np.array_equal(a, b)


def test_channel_exhaustion_more_visible_than_slots(rinex):
    """15 satellites visible but only 12 channel slots: the allocator
    claims the first 12 in SV order and skips the rest without error
    (reference semantics, c:1936-1972); a freed slot is reclaimed by an
    unallocated visible SV at the next boundary."""
    from pluto_gps_sim_tpu.models import orbits
    xyz = np.asarray(llh2xyz(np.radians(np.array([30.0, 240.0, 0.0]))
                             + [0, 0, 10.0]))
    g0 = setup_scenario(rinex, None)
    sched = Scheduler(rinex, g0, select_ephemeris_set(rinex, g0), xyz,
                      fs=FS, block_samples=16384)
    st = sched.state
    vis, _ = orbits.check_visibility(rinex.eph[0], g0.sec, xyz)
    vis_svs = np.flatnonzero(np.asarray(vis))
    assert vis_svs.size > 12, "fixture scenario no longer exhausts slots"
    assert int((st.prn > 0).sum()) == 12
    # lowest-numbered visible SVs win, like the reference's scan order
    assert set(st.prn[st.prn > 0] - 1) == set(vis_svs[:12])
    # stream still synthesizes fine at full occupancy
    plan = sched.plan(1)
    assert plan.active[0].sum() == 12


def test_abandoned_generator_rolls_back(rinex):
    """Breaking out of superframes() (the generator runs one dispatched
    superframe ahead) must not skip signal: a later generate() resumes
    exactly after the last YIELDED superframe."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    ref = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled").generate(9)

    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
    got = []
    for sf in s.superframes(None, max_blocks=3):
        got.append(sf)
        if len(got) == 2:
            break          # abandon with superframe 3 already dispatched
    got.append(s.generate(3))          # must be blocks 6..8, not 9..11
    got = np.concatenate(got, axis=0)
    assert got.shape == ref.shape
    assert np.array_equal(got, ref), "abandoned generator skipped signal"


def test_stream_across_gps_week_rollover(rinex, fixture_paths):
    """A stream crossing the GPS week boundary (sec wraps 604800 -> 0,
    week increments) must stay finite, split-invariantly, with active
    channels — the epoch anchor is week-aware (epoch.py t_anchor)."""
    from pluto_gps_sim_tpu.ingest import read_rinex2
    from pluto_gps_sim_tpu.models.gpstime import GpsTime

    rin = read_rinex2(fixture_paths["rinex2"])  # fresh copy (mutated below)
    # time-overwrite the ephemerides so the scenario starts 1.2 s before
    # the week boundary (aligned down to a 7200 s boundary internally)
    target = GpsTime(2260, 604800.0 - 1.2)
    g0 = setup_scenario(rin, target, timeoverwrite=True)
    ieph = select_ephemeris_set(rin, g0)

    s = IqStream(rin, g0, ieph, _xyz(), fs=FS, mode="tiled")
    a = s.generate(24)            # 2.4 s: blocks 12.. are in week 2261
    assert s.sched._epoch_time(s.sched.jblk).week == 2261
    assert np.abs(a).max() > 0, "silent stream across week rollover"
    assert a.shape[0] == 24

    s2 = IqStream(rin, g0, ieph, _xyz(), fs=FS, mode="tiled")
    b = np.concatenate(list(s2.superframes(24, max_blocks=5)), axis=0)
    assert np.array_equal(a, b), "week rollover breaks split invariance"


def test_superframes_as_device_matches_host(rinex):
    """as_device=True yields the device-resident output whose host
    conversion equals the normal host path (device-side consumers)."""
    import numpy as _np

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    host = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                    block_samples=16384).generate(3)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                 block_samples=16384)
    dev = [_np.asarray(x) for x in s.superframes(3, as_device=True)]
    assert _np.array_equal(_np.concatenate(dev, axis=0), host)


def test_plan_group_matches_sequential(rinex):
    """plan_group batches the range solve over superframe runs; it must
    reproduce the plan() loop bit for bit, including across 30 s
    boundaries (nav refresh + re-allocation) and an ephemeris rollover."""
    import dataclasses

    toc0 = GpsTime(int(rinex.eph[0].toc_week[0]),
                   float(rinex.eph[0].toc_sec[0]))
    g0 = setup_scenario(rinex, inc_gps_time(toc0, 3570.0))
    ieph = select_ephemeris_set(rinex, g0)

    sa = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    sb = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    ref = [sa.plan(300) for _ in range(5)]          # crosses the rollover
    grp = sb.plan_group(3) + sb.plan_group(2)
    assert len(grp) == 5 and sa.ieph == sb.ieph and sa.ieph != ieph
    for k, (p, q) in enumerate(zip(ref, grp)):
        for f in dataclasses.fields(p):
            a, b = getattr(p, f.name), getattr(q, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), (k, f.name)
            else:
                assert a == b, (k, f.name)

    # total_blocks cap produces the same partial spans as capped plan()
    sc = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    sd = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    rem, r2 = 750, []
    while rem > 0:
        p = sc.plan(min(300, rem))
        r2.append(p)
        rem -= p.n_blocks
    g2 = sd.plan_group(8, total_blocks=750)
    assert [p.n_blocks for p in g2] == [p.n_blocks for p in r2]
    for p, q in zip(r2, g2):
        assert np.array_equal(p.carr_phase, q.carr_phase)
        assert np.array_equal(p.gain, q.gain)


def test_batched_dispatch_identical(rinex):
    """superframes_per_dispatch=K yields the same stream in K-superframe
    steps (one device call each)."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    a = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                 block_samples=16384).generate(20)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                 block_samples=16384, superframes_per_dispatch=3)
    parts = list(s.superframes(20, max_blocks=6))
    # dispatch_ramp(3): groups of 1, 2, then 3 superframes (capped)
    assert [p.shape[0] for p in parts] == [6, 12, 2]
    assert np.array_equal(np.concatenate(parts, axis=0), a)


def test_batched_dispatch_pallas_interpret(rinex):
    """The fused multi-superframe dispatch path (sf_map + per-superframe
    C/A tables) matches the tiled stream bit for bit."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    a = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                 block_samples=8192).generate(9)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="fused",
                 block_samples=8192, superframes_per_dispatch=2)
    parts = list(s.superframes(9, max_blocks=3))
    assert np.array_equal(np.concatenate(parts, axis=0), a)


def test_skip_matches_plan_loop_across_rollover(rinex):
    """Scheduler.skip (the O(boundaries) fast-forward behind host
    partitioning) must leave the scheduler in a state whose NEXT plans
    are bit-identical to a plan() loop over the skipped span —
    including across an ephemeris rollover boundary, where the range anchor must
    be priced with the pre-rollover set (c:2774-2790)."""
    import dataclasses

    toc0 = GpsTime(int(rinex.eph[0].toc_week[0]),
                   float(rinex.eph[0].toc_sec[0]))
    g0 = setup_scenario(rinex, inc_gps_time(toc0, 3570.0))
    ieph = select_ephemeris_set(rinex, g0)

    sa = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    sb = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    for _ in range(3):
        sa.plan(300)           # crosses the rollover at +60 s
    sb.skip(900)
    assert sa.ieph == sb.ieph and sa.ieph != ieph  # rollover happened
    for _ in range(2):         # two more superframes stay locked
        pa, pb = sa.plan(300), sb.plan(300)
        for f in dataclasses.fields(pa):
            a, b = getattr(pa, f.name), getattr(pb, f.name)
            if isinstance(a, np.ndarray):
                assert np.array_equal(a, b), f.name
            else:
                assert a == b, f.name

    # mid-superframe skip target (partition start not on a boundary)
    sc = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    sd = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)
    sc.plan(300); sc.plan(140)
    sd.skip(440)
    pc, pd = sc.plan(300), sd.plan(300)
    assert pc.n_blocks == pd.n_blocks == 160
    for f in dataclasses.fields(pc):
        a, b = getattr(pc, f.name), getattr(pd, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name

    # ref-compat block sizing (NUM_SAMPLES quirk): phase_ratio != 1, so
    # skip's anchor re-base must scale the range delta like plan() does
    se = Scheduler(rinex, g0, ieph, _xyz(), fs=5_000_000.0,
                   block_samples=300_000)
    sf = Scheduler(rinex, g0, ieph, _xyz(), fs=5_000_000.0,
                   block_samples=300_000)
    assert abs(se.phase_ratio - 0.6) < 1e-12
    for _ in range(2):
        se.plan(300)
    sf.skip(600)
    pe, pf = se.plan(300), sf.plan(300)
    assert np.array_equal(pe.carr_phase, pf.carr_phase)
    assert np.array_equal(pe.f_carr, pf.f_carr)


def test_host_partition_concatenates_identically(rinex):
    """IqStream(n_hosts=N, host_id=h): each host fast-forwards the
    deterministic control plane to its contiguous share; the N partial
    streams concatenate byte-identically to the unsharded run — the
    multi-host delivery story (each host streams 1/N through its own
    NIC) replacing the reference's sequential loop (c:2655-2806)."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    full = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                    block_samples=16384).generate(32)
    parts = []
    for h in range(3):
        s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                     block_samples=16384, superframes_per_dispatch=2,
                     n_hosts=3, host_id=h)
        got = np.concatenate(list(s.superframes(32, max_blocks=7)), axis=0)
        assert got.shape[0] in (10, 11)  # 32 blocks over 3 hosts
        parts.append(got)
    assert np.array_equal(np.concatenate(parts, axis=0), full)

    with pytest.raises(ValueError):
        IqStream(rinex, g0, ieph, _xyz(), fs=FS, n_hosts=3, host_id=3)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, n_hosts=2, host_id=0)
    with pytest.raises(ValueError):
        next(s.superframes(None))  # endless streams cannot partition


def test_pack_ca_group_cache_is_transparent(rinex):
    """IqStream's packed C/A-table cache must be invisible: any mix of
    hits, misses, and evictions returns exactly sp.pack_ca_tables'
    output (same shape — one slot per superframe — same bytes)."""
    from pluto_gps_sim_tpu.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="fused",
                 block_samples=8192)
    tabs = [(CA_TABLE[np.arange(i, i + 12) % 32] * 2 - 1).astype(np.int8)
            for i in range(70)]  # > the 64-entry cache bound
    # repeated group (all misses, then all hits), duplicate inside a
    # group, and an eviction sweep past the cache bound
    for group in ([tabs[0]] * 3, [tabs[0], tabs[1], tabs[0]], tabs, tabs):
        got = s._pack_ca_group(group)
        want = sp.pack_ca_tables(group)
        assert got.shape == want.shape and np.array_equal(got, want)
    assert len(s._ca_cache) <= 64
    # LRU, not FIFO: a table hit on every group must survive an eviction
    # sweep of > 64 distinct tables interleaved with its hits
    s._ca_cache.clear()
    s._pack_ca_group([tabs[0]])
    for t in tabs[1:]:
        s._pack_ca_group([t, tabs[0]])     # sweep + keep tabs[0] hot
    assert tabs[0].tobytes() in s._ca_cache, \
        "hot C/A table evicted by the sweep (FIFO regression)"


def test_as_device_multi_dispatch_tiled(rinex):
    """as_device=True with superframes_per_dispatch>1 in tiled mode must
    yield one array per GROUP (concatenated over its per-plan
    dispatches), not the internal handle list (regression: consumers
    got a list of opaque 3-tuples)."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    host = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                    block_samples=16384).generate(4)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled",
                 block_samples=16384, superframes_per_dispatch=2)
    outs = [np.asarray(x) for x in s.superframes(4, max_blocks=2,
                                                 as_device=True)]
    assert all(o.ndim == 3 for o in outs)
    assert np.array_equal(np.concatenate(outs, axis=0), host)


def test_restore_rejects_incomplete_snapshot(rinex):
    """A snapshot from an older schema (missing channel-state fields,
    e.g. the carrier anchor pair) must fail loudly, not resume with a
    silent phase discontinuity."""
    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, mode="tiled")
    snap = s.snapshot()
    del snap["channel_state"]["rho_anchor"]
    with pytest.raises(ValueError, match="rho_anchor"):
        s.restore(snap)


def test_plan_group_solve_grids_exact(rinex):
    """plan_group's range solves cover exactly the spans they feed — no
    padding (the old canonical-shape padding served the jitted solve's
    XLA compile cache, retired by the round-5 numpy port) — and the
    mid-run re-solve branch after a rise/set re-allocation still fires
    and still produces plans identical to a plan() loop (the
    equivalence tests above own the values; this pins the solve-call
    pattern)."""
    from pluto_gps_sim_tpu.runtime import scheduler as sched_mod

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    s = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)

    lengths = []
    orig = sched_mod.solve_ranges_lean

    def spy(eph, ionoutc, g_secs, rx):
        lengths.append(len(g_secs))
        return orig(eph, ionoutc, g_secs, rx)

    sched_mod.solve_ranges_lean = spy
    try:
        sv_hist = [s.state.sv_idx.copy()]
        for _ in range(5):                     # 40 superframes = 20 min
            assert len(s.plan_group(8)) == 8
            sv_hist.append(s.state.sv_idx.copy())
    finally:
        sched_mod.solve_ranges_lean = orig

    assert len(lengths) >= 5
    # exact-length grids: never longer than the group span, and the
    # per-group solves tile it (5 groups x 2400 blocks + 1 epoch each
    # + re-solve overlap epochs)
    assert max(lengths) <= 8 * 300 + 1, lengths
    assert sum(lengths) >= 5 * (8 * 300 + 1), lengths
    # the scenario must actually exercise the guarded re-solve path:
    # a rise/set re-allocation happens (sv_idx changes) and it lands
    # MID-RUN, forcing the re-solve branch (more solves than groups)
    assert any(not np.array_equal(a, b)
               for a, b in zip(sv_hist, sv_hist[1:])), \
        "scenario never re-allocated channels; re-solve branch untested"
    assert len(lengths) > 5, \
        "re-allocation never landed mid-run; re-solve branch untested"


def test_plan_group_final_capped_group_solves_exact_span(rinex):
    """A total_blocks-capped FINAL dispatch group (end of a finite
    stream) has fewer spans than requested; its range solve covers
    exactly the capped span (500 blocks -> 501 epochs), not the full
    group shape."""
    from pluto_gps_sim_tpu.runtime import scheduler as sched_mod

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    s = Scheduler(rinex, g0, ieph, _xyz(), fs=FS)

    lengths = []
    orig = sched_mod.solve_ranges_lean

    def spy(eph, ionoutc, g_secs, rx):
        lengths.append(len(g_secs))
        return orig(eph, ionoutc, g_secs, rx)

    sched_mod.solve_ranges_lean = spy
    try:
        full = s.plan_group(8)                       # steady-state group
        lengths.clear()
        capped = s.plan_group(8, total_blocks=500)   # final short group
    finally:
        sched_mod.solve_ranges_lean = orig

    assert len(full) == 8 and len(capped) == 2
    assert sum(p.n_blocks for p in capped) == 500
    assert sum(n - 1 for n in lengths) == 500, lengths


def test_split_plan_lifts_block_cap(rinex, monkeypatch):
    """ops.synth_jnp.split_plan: blocks beyond the fused kernel's Q24
    range split into K re-anchored sub-blocks.  Checks (at small sizes,
    with the cap monkeypatched down so the split path engages):
    (1) the fused path on the split plan == precise on the split
    plan, sample-exact; (2) reassembled split-precise tracks UNSPLIT
    precise (the re-anchor rounding is ~1e-10 chips — allow a handful
    of chip-edge straddles); (3) IqStream in fused mode transparently
    splits and yields [M, N, 2] rows that match the unsplit tiled
    stream within the shared quantization floor."""
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, split_plan, synth_superframe_precise)

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    N = 49152                       # 3 sub-blocks of 16384
    sched = Scheduler(rinex, g0, ieph, _xyz(), fs=FS, block_samples=N)
    plan = sched.plan(4)
    dp = pack_plan(plan)            # tables for the precise path
    dp_s = split_plan(dp, 16384)
    assert dp_s.n_blocks == 4 * 3 and dp_s.block_samples == 16384

    golden_s = synth_superframe_precise(dp_s)        # [M*K, sub, 2]
    prm = sp.build_group_params([dp_s])
    assert prm.patch_dropped == 0
    packed = np.asarray(synth_blocks(
        prm, sp.pack_ca_tables([dp_s.ca2]),
        np.zeros(dp_s.n_blocks, np.int32), dp_s.block_samples))[:, :dp_s.block_samples]
    got = sp.unpack_iq(packed)
    assert np.array_equal(got, golden_s), (
        f"{int((got != golden_s).sum())} components diverge "
        f"(split fused vs split precise)")

    golden_u = synth_superframe_precise(dp)          # [M, N, 2]
    re_s = golden_s.reshape(4, 3 * 16384, 2)[:, :N]
    bad = int((re_s != golden_u).sum())
    assert bad <= 8, f"{bad} split-vs-unsplit precise mismatches"

    # stream-level: fused mode splits transparently when block_samples
    # exceeds the (patched) kernel cap
    monkeypatch.setattr(sp, "MAX_BLOCK_SAMPLES", 16384)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=N,
                 mode="fused")
    assert s._split_k == 3
    t = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=N,
                 mode="tiled")
    got_s = np.concatenate(list(s.superframes(4, max_blocks=2)), axis=0)
    want_t = np.concatenate(list(t.superframes(4, max_blocks=2)), axis=0)
    assert got_s.shape == want_t.shape == (4, N, 2)
    d = np.abs(got_s.astype(np.int32) - want_t.astype(np.int32))
    # fused-split and tiled anchor their NCOs at different offsets, so
    # a few samples may straddle the shared ~1e-11-chip trunc floor
    assert int((d > 0).sum()) <= 8 and int(d.max()) <= 8, (
        int((d > 0).sum()), int(d.max()))


def test_patch_variant_latch_is_output_invariant(rinex):
    """The per-stream patch-variant latch (IqStream._saw_patches ->
    synth_blocks force_patches) exists to pin ONE compiled
    variant per stream; the wide (patch-pass) variant on a patch-free
    dispatch must produce bit-identical output to the narrow fast path,
    at both the kernel and the stream level."""
    from pluto_gps_sim_tpu.ops import params as sp
    from pluto_gps_sim_tpu.ops.synth_fused import synth_blocks
    from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan

    g0 = setup_scenario(rinex, None)
    ieph = select_ephemeris_set(rinex, g0)
    sched = Scheduler(rinex, g0, ieph, _xyz(), fs=FS, block_samples=16384)
    dp = pack_plan(sched.plan(2), tables=False)
    prm = sp.build_group_params([dp])
    assert not np.any(prm.prmf[:, 128:]), "fixture dispatch not patch-free"
    args = (prm, sp.pack_ca_tables([dp.ca2]),
            np.zeros(dp.n_blocks, np.int32), dp.block_samples)
    narrow = np.asarray(synth_blocks(*args))
    wide = np.asarray(synth_blocks(*args, force_patches=True))
    assert np.array_equal(narrow, wide)

    a = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=16384,
                 mode="fused").generate(2)
    s = IqStream(rinex, g0, ieph, _xyz(), fs=FS, block_samples=16384,
                 mode="fused")
    s._saw_patches = True                 # latched stream, same output
    assert np.array_equal(s.generate(2), a)
