"""Benchmark: composite GPS IQ synthesis throughput on one GPU.

Scenario: 12 active channels at fs=2.6 MHz (the reference's headline
configuration — it must sustain 2.6 Msps on one CPU core to avoid SDR
underruns; plutogpssim.c:43, 2152).  We synthesize minutes of signal per
device call with the fused path and report samples/s.  One process: it
fails when JAX finds no GPU, and never falls back to the CPU.

Core measurements, one JSON line:

  value / vs_baseline   synthesis throughput of back-to-back calls (six
                        chained calls of distinct parameter sets, one
                        sync at the end) on the 12-channel worst case
  e2e_device_x          full production pipeline: Scheduler.plan ->
                        pack -> build_group_params -> H2D -> synthesis ->
                        on-device checksum reduction (8 B D2H/superframe).
                        Everything except bulk IQ egress.
  e2e_sustained_x       the same pipeline's MARGINAL rate between 120 s
                        and 360 s runs, so flat per-call costs cancel.
  e2e_pipelined_x       the production runtime path: IqStream's two-deep
                        software pipeline (planner thread) at
                        superframes_per_dispatch=8 with a device-side
                        consumer (as_device=True) that reduces and
                        synchronizes per group with one group of lag.
                        May EXCEED the 12-channel multiple: the stream
                        synthesizes the scenario's actual visible set
                        (~7 SVs on this fixture).
  e2e_delivered_x       the same stream with the full int16 IQ fetched to
                        host NumPy (D2H enqueued at dispatch time) — the
                        delivered-samples contract (c:2152).

Also recorded: host_ctrl_ms_per_sf (the host control plane per 30 s
superframe), patch-drop counters (hard-gated to zero), and `env`: the
device (platform, device_kind, count), the card's name and power limit,
nproc and load average.

Before timing, the synthesis output is VERIFIED against the f64 precise
path (4 blocks) and against the tiled path on the device (300 blocks); a
wrong-but-fast build cannot bench.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np


def _env(dev) -> dict:
    import jax

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
            "nproc": os.cpu_count(),
            "loadavg1": round(os.getloadavg()[0], 2)}


def main() -> None:
    sys.path.insert(0, "tests")
    import jax

    from pluto_gps_sim_tpu.runtime.device import (configure_compile_cache,
                                                  synthesis_device)
    configure_compile_cache()
    dev = synthesis_device()
    if dev.platform != "gpu":
        print(json.dumps({"metric": "iq_synthesis_throughput_12ch_2p6MHz",
                          "value": None, "error": f"no GPU ({dev.platform})"}))
        sys.exit(2)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

    from fixtures import ensure_fixtures
    paths = ensure_fixtures()

    import jax.numpy as jnp

    from pluto_gps_sim_tpu.ingest import read_rinex2
    from pluto_gps_sim_tpu.models.geodesy import llh2xyz
    from pluto_gps_sim_tpu.ops import params as pp
    from pluto_gps_sim_tpu.ops import synth_fused as sf
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, synth_superframe_precise, synth_superframe_tiled_async)
    from pluto_gps_sim_tpu.runtime import (
        select_ephemeris_set, setup_scenario)
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu.runtime.stream import IqStream

    fs = 2_600_000.0
    rin = read_rinex2(paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    llh = np.array([35.681298, 139.766247, 10.0])
    llh = llh * np.array([1 / 57.2957795131, 1 / 57.2957795131, 1.0])
    xyz = np.asarray(llh2xyz(llh))
    env = _env(dev)
    partial: dict = {}

    # ---- correctness gate: synthesis vs the f64 precise path -------------
    # The fused path matches the f64 path to the NCOs' shared ~1e-11
    # quantization floors (measured 100.000000% / max err 0); the bound
    # allows ~4 components of 2M.  ANY chip or nav-bit flip is a
    # full-amplitude error and fails loudly.
    sched_v = Scheduler(rin, g0, ieph, xyz, fs=fs)
    dp_v = pack_plan(sched_v.plan(4))
    golden = synth_superframe_precise(dp_v)          # [M, N, 2] int16
    prm_v = pp.build_block_params(dp_v)
    if prm_v.patch_dropped != 0:
        print(json.dumps({"metric": "VERIFY_FAILED",
                          "patch_dropped": prm_v.patch_dropped}))
        sys.exit(1)
    got = pp.unpack_iq(np.asarray(sf.synth_blocks(
        prm_v, pp.pack_ca_tables([dp_v.ca2]),
        np.zeros(dp_v.n_blocks, np.int32), dp_v.block_samples, device=dev)))
    exact = float(np.mean(got == golden))
    max_err = int(np.abs(got.astype(np.int64)
                         - golden.astype(np.int64)).max())
    if exact < 1.0 - 2e-6 or max_err > 8:
        print(json.dumps({"metric": "VERIFY_FAILED",
                          "bit_exact": exact, "max_err": max_err}))
        sys.exit(1)

    # second gate, full-superframe scale: fused vs tiled over 300 blocks,
    # compared ON DEVICE (two scalars cross the link).  Bound allows ~15
    # of 156M components; a chip/nav flip still fails max_err <= 8.
    dp_g = pack_plan(sched_v.plan(300))
    tiled_g = synth_superframe_tiled_async(dp_g, device=dev)

    def _gate_stats(packed, tiled):
        i16, q16 = sf.unpack_packed(packed)
        t32 = tiled.astype(jnp.int32)
        di = jnp.abs(i16 - t32[..., 0])
        dq = jnp.abs(q16 - t32[..., 1])
        return (jnp.sum((di > 0).astype(jnp.int32))
                + jnp.sum((dq > 0).astype(jnp.int32)),
                jnp.maximum(di.max(), dq.max()))

    packed_g = sf.synth_blocks(
        pp.build_block_params(dp_g), pp.pack_ca_tables([dp_g.ca2]),
        np.zeros(dp_g.n_blocks, np.int32), dp_g.block_samples, device=dev)
    with jax.enable_x64(False):
        n_bad, m_err = jax.jit(_gate_stats)(packed_g, tiled_g)
    exact_g = 1.0 - int(n_bad) / (2 * dp_g.n_blocks * dp_g.block_samples)
    if exact_g < 1.0 - 1e-7 or int(m_err) > 8:
        print(json.dumps({"metric": "VERIFY_FAILED_300BLK",
                          "bit_exact": exact_g, "max_err": int(m_err)}))
        sys.exit(1)
    del packed_g, tiled_g

    # ---- timing parameter sets ---------------------------------------------
    sched = Scheduler(rin, g0, ieph, xyz, fs=fs)

    def build_args(n_superframes: int):
        # plan_group = the production host path (one range solve per
        # eph-set run of superframes, as IqStream dispatch groups use)
        plans = sched.plan_group(n_superframes, 300)
        dps = [pack_plan(p, tables=False) for p in plans]
        bp = pp.build_group_params(dps)
        partial["patch_dropped_rig"] = (partial.get("patch_dropped_rig", 0)
                                        + bp.patch_dropped)
        prmi, prmf = bp.prmi.copy(), bp.prmf.copy()
        # force the full 12-channel load: clone active channels' params
        # into any inactive slots (the reference's worst case, MAX_CHAN=12)
        act = np.concatenate([d.active for d in dps], axis=0)
        src = np.flatnonzero(act[0])
        for c in range(act.shape[1]):
            if not act[0, c]:
                s_col = int(src[c % src.size])
                for base in range(0, 120, 12):
                    prmi[:, base + c] = prmi[:, base + s_col]
                for base in (pp._F_SR12, pp._F_SREM, pp._F_CQ12,
                             pp._F_RRR, pp._F_GAIN):
                    prmf[:, base + c] = prmf[:, base + s_col]
        ca_tabs = pp.pack_ca_tables([p.ca2 for p in plans])
        sf_map = np.concatenate(
            [np.full(p.n_blocks, i, np.int32) for i, p in enumerate(plans)])
        return (prmi, prmf), ca_tabs, sf_map, dps[0].block_samples

    n_sf = 4  # 120 s of signal per call
    raw = [build_args(n_sf) for _ in range(6)]

    # host control plane per 30 s superframe — exactly the production
    # stages IqStream runs (plan_group -> pack -> build_group_params ->
    # C/A tables); min-of-5 rejects scheduler noise
    def _host_pass():
        t0 = time.perf_counter()
        plans = sched.plan_group(n_sf, 300)
        dps = [pack_plan(p, tables=False) for p in plans]
        pp.build_group_params(dps)
        pp.pack_ca_tables([d.ca2 for d in dps])
        return (time.perf_counter() - t0) / len(plans)

    host_ctrl_ms = 1e3 * min(_host_pass() for _ in range(5))

    block_samples = raw[0][3]
    M = raw[0][2].size

    def run_chain():
        outs = [sf.synth_blocks(*r, device=dev) for r in raw]
        outs[-1].block_until_ready()
        return outs

    run_chain()                                 # compile + warm
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_chain()
        ts.append((time.perf_counter() - t0) / len(raw))
    dt = float(np.median(ts))
    msps = M * block_samples / dt / 1e6
    rt_multiple = msps * 1e6 / fs

    # ---- end-to-end pipeline (device-side consumption) --------------------
    csum = jax.jit(jnp.sum)

    def e2e_device_once(k=n_sf):
        """(samples, seconds) for a k-superframe pipeline run."""
        t0 = time.perf_counter()
        prm, ca_tabs, sf_map, bs = build_args(k)
        s = int(csum(sf.synth_blocks(prm, ca_tabs, sf_map, bs, device=dev)))
        assert s != 0
        return sf_map.size * bs, time.perf_counter() - t0

    e2e_device_once(12)          # compile-warm the 12-superframe shapes
    e2e_device_once(4)
    runs4 = [e2e_device_once(4) for _ in range(5)]
    runs12 = [e2e_device_once(12) for _ in range(5)]
    e2e_dev = float(np.median([n / t for n, t in runs4]))
    # sustained = marginal samples/s between 120 s and 360 s runs; a
    # noise-inverted slope reports null rather than a nonsense multiple
    d_samp = runs12[0][0] - runs4[0][0]
    t4m = float(np.median([t for _, t in runs4]))
    t12m = float(np.median([t for _, t in runs12]))
    d_t = t12m - t4m
    e2e_sus = d_samp / d_t if d_t > 0.05 * t4m else None
    if e2e_sus is not None and e2e_sus > msps * 1e6:
        e2e_sus = None

    # ---- production pipelined e2e (IqStream, device-side consumer) --------
    k_sf = 8

    def pipelined(n_blocks, skip_sf=0):
        stream = IqStream(rin, g0, ieph, xyz, fs=fs, mode="fused",
                          device=dev, superframes_per_dispatch=k_sf)
        if skip_sf:
            stream.fast_forward(300 * skip_sf)
        t0 = time.perf_counter()
        done = total = 0
        pending = []
        for dev_out in stream.superframes(n_blocks, as_device=True):
            pending.append(csum(dev_out))
            while len(pending) > 1:              # lag-1 sync
                total += int(pending.pop(0))
            done += dev_out.shape[0]
        for p in pending:
            total += int(p)
        dt_ = time.perf_counter() - t0
        assert done == n_blocks and total != 0
        partial["patch_dropped_stream"] = (
            partial.get("patch_dropped_stream", 0) + stream.patch_dropped)
        return n_blocks * block_samples / dt_ / fs

    # warm every ramp shape incl. one full k_sf-superframe group
    pipelined((2 ** (k_sf - 1).bit_length() - 1 + k_sf) * 300)
    pipe_runs = [pipelined(24000, skip_sf=1 + r) for r in range(5)]

    # ---- end-to-end with delivered samples --------------------------------
    def delivered(n_blocks, skip_sf=0):
        stream = IqStream(rin, g0, ieph, xyz, fs=fs, mode="fused",
                          device=dev)
        if skip_sf:
            stream.fast_forward(300 * skip_sf)
        t0 = time.perf_counter()
        done = 0
        for sf_ in stream.superframes(n_blocks):
            assert sf_.dtype == np.int16 and sf_.shape[1] == block_samples
            done += sf_.shape[0]
        dt_ = time.perf_counter() - t0
        assert done == n_blocks
        partial["patch_dropped_stream"] = (
            partial.get("patch_dropped_stream", 0) + stream.patch_dropped)
        return n_blocks * block_samples / dt_

    delivered(300)                                       # compile-warm
    e2e_del = delivered(600, skip_sf=1)

    # ---- drop budget gate: ANY gain-trunc patch drop in a timing stream
    # or the rig is a regression and fails the artifact
    drops = (partial.get("patch_dropped_stream", 0)
             + partial.get("patch_dropped_rig", 0))
    if drops:
        print(json.dumps({"metric": "VERIFY_FAILED_DROP_BUDGET", **partial}))
        sys.exit(1)

    print(json.dumps({
        "metric": "iq_synthesis_throughput_12ch_2p6MHz",
        "value": round(msps, 1),
        "unit": "Msamples/s/device",
        "vs_baseline": round(rt_multiple, 1),
        "verify": (f"fused tracks precise: {exact * 100:.4f}% exact, max "
                   f"err {max_err}<=8; vs tiled (300 blocks) "
                   f"{exact_g * 100:.6f}%"),
        "e2e_device_x": round(e2e_dev / fs, 1),
        "e2e_sustained_x": (round(e2e_sus / fs, 1) if e2e_sus else None),
        "e2e_pipelined_x": round(float(np.median(pipe_runs)), 1),
        "e2e_pipelined_runs": [round(r, 1) for r in pipe_runs],
        "e2e_delivered_x": round(e2e_del / fs, 1),
        "host_ctrl_ms_per_sf": round(host_ctrl_ms, 2),
        "patch_dropped_stream": partial.get("patch_dropped_stream", 0),
        "patch_dropped_rig": partial.get("patch_dropped_rig", 0),
        "env": env,
    }))


if __name__ == "__main__":
    main()
