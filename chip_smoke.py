#!/usr/bin/env python3
"""On-card smoke test: the production path on NVIDIA GPUs, end to end.

    python chip_smoke.py                # one card, phases 0-5
    python chip_smoke.py --four-cards   # four cards: sharded paths only

One process holds the card at a time: phase 1 runs the `gpu`-marked
tests in a child before this process initializes JAX.  Every phase
prints one line (or a few); any failure exits non-zero without the
final JSON line.  The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Fixtures are generated from a seed (tests/fixtures.py); nothing is
downloaded.  The phases take their devices as arguments, so the
four-card phase also runs on four virtual CPU devices
(tests/test_chip_smoke.py).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOKYO = (35.681298, 139.766247, 10.0)
FS = 2_600_000.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def _scenario(start_offset_s: float | None = None):
    """(rin, g0, ieph, xyz) of the seeded RINEX v2 fixture at Tokyo;
    start_offset_s moves the start that far past the first TOC."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fixtures import ensure_fixtures

    from pluto_gps_sim_tpu.constants import R2D
    from pluto_gps_sim_tpu.ingest import read_rinex2
    from pluto_gps_sim_tpu.models.geodesy import llh2xyz
    from pluto_gps_sim_tpu.models.gpstime import GpsTime, inc_gps_time
    from pluto_gps_sim_tpu.runtime import (select_ephemeris_set,
                                           setup_scenario)

    rin = read_rinex2(ensure_fixtures()["rinex2"])
    g0 = None
    if start_offset_s is not None:
        toc0 = GpsTime(int(rin.eph[0].toc_week[0]),
                       float(rin.eph[0].toc_sec[0]))
        g0 = inc_gps_time(toc0, start_offset_s)
    g0 = setup_scenario(rin, g0)
    ieph = select_ephemeris_set(rin, g0)
    llh = np.array([TOKYO[0] / R2D, TOKYO[1] / R2D, TOKYO[2]])
    return rin, g0, ieph, np.asarray(llh2xyz(llh))


def _bit_stats(got: np.ndarray, want: np.ndarray) -> tuple[float, int]:
    exact = float(np.mean(got == want))
    err = int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())
    return exact, err


def _device_stats():
    """jitted (n_bad, max_err) of packed int32 IQ vs int16 [M, N, 2],
    computed on the device (two scalars cross the link)."""
    import jax
    import jax.numpy as jnp

    from pluto_gps_sim_tpu.ops.synth_fused import unpack_packed

    def stats(packed, ref):
        i16, q16 = unpack_packed(packed)
        r = ref.astype(jnp.int32)
        di = jnp.abs(i16 - r[..., 0])
        dq = jnp.abs(q16 - r[..., 1])
        return (jnp.sum((di > 0).astype(jnp.int32))
                + jnp.sum((dq > 0).astype(jnp.int32)),
                jnp.maximum(di.max(), dq.max()))

    return jax.jit(stats)


# ---------------------------------------------------------------------------
# phases


def gpu_tests() -> None:
    """The `gpu`-marked tests in a child process (this process has not
    touched the card yet); skips count as failures."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, PLUTO_TEST_GPU="1")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=600)
        tail = "\n".join(r.stdout.strip().splitlines()[-3:])
        print(tail, flush=True)
        check(r.returncode == 0, f"gpu tests failed (rc={r.returncode}):\n"
              f"{r.stdout[-4000:]}{r.stderr[-2000:]}")
        import xml.etree.ElementTree as ET
        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
        check(n > 0 and skipped == 0,
              f"gpu tests: {n} collected, {skipped} skipped")


def gates(dev, card: str) -> None:
    """Production kernel vs the f64 precise path (CPU) at 2.6, 5 and
    10 MHz (split), and vs the plain XLA version on the same device."""
    import jax.numpy as jnp

    from pluto_gps_sim_tpu.ops import params as pp
    from pluto_gps_sim_tpu.ops import synth_fused as sf
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, split_plan, synth_superframe_precise)
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler

    rin, g0, ieph, xyz = _scenario()
    print(f"  kernel: {sf.kernel_for(dev)} (reference: xla)", flush=True)
    for fs in (2.6e6, 5e6, 10e6):
        dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=fs).plan(4))
        dps = split_plan(dp, pp.MAX_BLOCK_SAMPLES)
        args = (pp.build_group_params([dps]), pp.pack_ca_tables([dps.ca2]),
                np.zeros(dps.n_blocks, np.int32), dps.block_samples)
        t0 = time.perf_counter()
        out = sf.synth_blocks(*args, device=dev)
        got = pp.unpack_iq(np.asarray(out))
        t_first = time.perf_counter() - t0
        ref_same = bool(jnp.array_equal(
            out, sf.synth_blocks(*args, device=dev, reference=True)))
        exact, err = _bit_stats(got, synth_superframe_precise(dps))
        print(f"  fs={fs / 1e6:g} MHz, {dps.n_blocks} x {dps.block_samples}"
              f" samples: vs precise bit-exact {exact:.8f}, max err {err};"
              f" kernel == xla reference: {ref_same} (compile+run "
              f"{t_first:.1f} s)", flush=True)
        check(exact >= 1 - 2e-6 and err <= 8, f"fs={fs} gate")
        check(ref_same, f"fs={fs}: kernel != xla reference")
        if dps is not dp:
            k = dps.n_blocks // dp.n_blocks
            re = got.reshape(dp.n_blocks, k * dps.block_samples, 2)
            exact, err = _bit_stats(re[:, :dp.block_samples],
                                    synth_superframe_precise(dp))
            print(f"    reassembled vs unsplit precise: bit-exact "
                  f"{exact:.8f}, max err {err}", flush=True)
            check(exact >= 1 - 2e-6 and err <= 8, "10 MHz reassembled gate")
    # production group shape: K=8 superframes at 2.6 MHz
    n_blocks, bs = 8 * 300, int(FS / 10)
    for reference in (False, True):
        comp = sf.compile_synth(n_blocks, bs, 8, dev, reference=reference)
        ma = comp.memory_analysis()
        name = "xla reference" if reference else "kernel"
        print(f"  memory analysis, {name} at the K=8 group ({n_blocks} x "
              f"{bs}): output {ma.output_size_in_bytes / 1e9:.3f} GB, temp "
              f"{ma.temp_size_in_bytes / 1e9:.3f} GB, args "
              f"{ma.argument_size_in_bytes / 1e6:.2f} MB [{card}]",
              flush=True)
        check(ma.temp_size_in_bytes < ma.output_size_in_bytes,
              "group temporaries exceed the output size")


def patched_gate(dev) -> None:
    """A dispatch that carries gain-trunc patch words (nudge off): the
    kernel + row patch pass must match the f64 precise path exactly."""
    from pluto_gps_sim_tpu.constants import MAX_CHAN
    from pluto_gps_sim_tpu.models.cacode import CA_TABLE
    from pluto_gps_sim_tpu.ops import params as pp
    from pluto_gps_sim_tpu.ops import synth_fused as sf
    from pluto_gps_sim_tpu.ops.synth_jnp import (pack_plan,
                                                 synth_superframe_precise)
    from pluto_gps_sim_tpu.runtime.scheduler import SuperframePlan

    rng = np.random.RandomState(7)
    n, c_all = 260_000, MAX_CHAN
    active = np.zeros((2, c_all), bool)
    active[:, :3] = True
    f_carr = np.zeros((2, c_all))
    f_carr[:, :3] = [-2717.3, 395.9, -967.7]
    gain = np.where(active, 0.5, 0.0)
    gain[1, 1] = 0.9086419713826426     # 405*g on a trunc boundary
    plan = SuperframePlan(
        n_blocks=2, block_samples=n, delt=1.0 / FS,
        prn=np.where(active[0], np.arange(1, c_all + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(c_all)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (c_all, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (2, c_all)),
        icode=rng.randint(0, 20, (2, c_all)).astype(np.int32),
        ibit=rng.randint(0, 30, (2, c_all)).astype(np.int32),
        iword=rng.randint(0, 10, (2, c_all)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (2, c_all)), gain=gain,
        azel=np.zeros((2, c_all, 2)))
    dp = pack_plan(plan)
    bp = pp.build_block_params(dp, nudge=False)
    rows = sf.patch_rows(bp.prmf)
    got = pp.unpack_iq(np.asarray(sf.synth_blocks(
        bp, pp.pack_ca_tables([dp.ca2]), np.zeros(2, np.int32), n,
        device=dev)))
    exact, err = _bit_stats(got, synth_superframe_precise(dp))
    print(f"  patched dispatch ({rows.size} row(s) with words): vs precise "
          f"bit-exact {exact:.8f}, max err {err}", flush=True)
    check(rows.size == 1 and exact == 1.0, "patched dispatch gate")


def cli_run(tmp: str) -> None:
    """The CLI, in-process, 60 s at K=8 with --selfcheck and --stats."""
    from pluto_gps_sim_tpu import cli

    out = os.path.join(tmp, "smoke.bin")
    rc = cli.main(["-e", os.path.join(REPO, "tests/data/brdc_test.23n"),
                   "-l", ",".join(str(v) for v in TOKYO), "-s",
                   str(int(FS)), "-d", "60", "--dispatch-superframes", "8",
                   "-o", out, "--selfcheck", "--stats"])
    size = os.path.getsize(out) if os.path.exists(out) else 0
    print(f"  cli rc={rc}, wrote {size / 1e6:.1f} MB", flush=True)
    check(rc == 0 and size == 600 * int(FS / 10) * 4, "cli run")
    os.remove(out)


def rollover_stream(dev) -> None:
    """450 s across the ephemeris rollover through the production
    IqStream(mode="fused", K=8) — groups of 1, 2, 4 and 8 superframes —
    every 300-block superframe held on the device to the tiled path."""
    from pluto_gps_sim_tpu.ops.synth_jnp import (
        pack_plan, synth_superframe_tiled_async)
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu.runtime.stream import IqStream

    rin, g0, ieph, xyz = _scenario(start_offset_s=3540.0)
    n_blocks = 4500
    stream = IqStream(rin, g0, ieph, xyz, fs=FS, mode="fused", device=dev,
                      superframes_per_dispatch=8)
    shadow = Scheduler(rin, g0, ieph, xyz, fs=FS)
    bs = shadow.block_samples
    stats = _device_stats()
    bad = max_err = done = total = 0
    groups = []
    for packed in stream.superframes(n_blocks, as_device=True):
        groups.append(packed.shape[0] // 300)
        for off in range(0, packed.shape[0], 300):
            dp = pack_plan(shadow.plan(300))
            check(dp.n_blocks == 300, "shadow span drifted off the grid")
            tiled = synth_superframe_tiled_async(dp, device=dev)
            n_bad, m = stats(packed[off:off + 300], tiled)
            bad += int(n_bad)
            max_err = max(max_err, int(m))
            total += 2 * 300 * bs
        done += packed.shape[0]
    exact = 1.0 - bad / total
    print(f"  {done} blocks in groups {groups}, ephemeris set "
          f"{ieph}->{stream.sched.ieph}: vs tiled on device bit-exact "
          f"{exact:.10f} ({bad} components), max err {max_err}, patch "
          f"words dropped {stream.patch_dropped}", flush=True)
    check(done == n_blocks and stream.sched.ieph != ieph, "rollover span")
    check(exact >= 1 - 1e-8 and max_err <= 8, "rollover stream vs tiled")
    check(stream.patch_dropped == 0, "patch words dropped")


def receivable(dev) -> None:
    """40 s of IqStream output through the software receiver."""
    from pluto_gps_sim_tpu.runtime.stream import IqStream
    from pluto_gps_sim_tpu.utils.receiver import receive_and_fix

    rin, g0, ieph, xyz = _scenario()
    stream = IqStream(rin, g0, ieph, xyz, fs=FS, mode="fused", device=dev,
                      superframes_per_dispatch=2)
    iq = np.concatenate(list(stream.superframes(400)), axis=0)
    sol, tracks = receive_and_fix(iq, FS, ref_week=g0.week,
                                  measure_sample=int(round(FS)))
    err = float(np.linalg.norm(sol.xyz - xyz))
    decoded = all(tr.decoded for tr in tracks.values())
    print(f"  receiver fix {err:.2f} m from the true position, "
          f"{len(sol.prns)} SVs, all decoded: {decoded}", flush=True)
    check(err < 15.0 and len(sol.prns) >= 6 and decoded, "receiver fix")


def timing(dev, card: str) -> None:
    """Warm K=8 group synthesis (kernel and xla reference) and the
    IqStream real-time multiple, consumed on the device and delivered
    to host memory.  Informative only: this is not the benchmark."""
    import jax
    import jax.numpy as jnp

    from pluto_gps_sim_tpu.ops import params as pp
    from pluto_gps_sim_tpu.ops import synth_fused as sf
    from pluto_gps_sim_tpu.ops.synth_jnp import pack_plan
    from pluto_gps_sim_tpu.runtime.scheduler import Scheduler
    from pluto_gps_sim_tpu.runtime.stream import IqStream

    rin, g0, ieph, xyz = _scenario()
    plans = Scheduler(rin, g0, ieph, xyz, fs=FS).plan_group(8, 300)
    dps = [pack_plan(p, tables=False) for p in plans]
    bp = pp.build_group_params(dps)
    args = (bp, pp.pack_ca_tables([d.ca2 for d in dps]),
            np.concatenate([np.full(d.n_blocks, i, np.int32)
                            for i, d in enumerate(dps)]),
            dps[0].block_samples)
    samples = bp.prmi.shape[0] * dps[0].block_samples
    for name, ref in (("kernel", False), ("xla reference", True)):
        sf.synth_blocks(*args, device=dev, reference=ref).block_until_ready()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            sf.synth_blocks(*args, device=dev,
                            reference=ref).block_until_ready()
            ts.append(time.perf_counter() - t0)
        t = float(np.median(ts))
        print(f"  K=8 group synthesis, {name}: {t * 1e3:.2f} ms median of 5 "
              f"({samples / t / 1e6:.0f} Msps, "
              f"{samples / t / FS:.0f}x real time) [{card}]", flush=True)

    csum = jax.jit(jnp.sum)

    def stream_rate(n_blocks: int, on_device: bool) -> float:
        stream = IqStream(rin, g0, ieph, xyz, fs=FS, mode="fused",
                          device=dev, superframes_per_dispatch=8)
        t0 = time.perf_counter()
        pending, done = [], 0
        for out in stream.superframes(n_blocks, as_device=on_device):
            if on_device:
                pending.append(csum(out))
                while len(pending) > 1:       # lag-1 device consumer
                    int(pending.pop(0))
            done += out.shape[0]
        for p in pending:
            int(p)
        check(done == n_blocks and stream.patch_dropped == 0, "stream run")
        return n_blocks / 10.0 / (time.perf_counter() - t0)

    stream_rate(4500, True)                   # warm every group shape
    x_dev = stream_rate(24_000, True)
    x_host = stream_rate(4800, False)
    print(f"  IqStream K=8 real-time multiple: {x_dev:.1f}x consumed on "
          f"device (2400 s of signal), {x_host:.1f}x delivered to host "
          f"memory (480 s) [{card}]", flush=True)


def four_cards(devices, fs: float = FS, k_sf: int = 8,
               mc_receivers: int = 32, mc_blocks: int = 300,
               block_samples: int | None = None, max_blocks: int = 300):
    """Sharded paths on `devices` vs one device, compared on the device:
    one full K-superframe IqStream group over a time mesh, and a
    Monte-Carlo batch over the same mesh."""
    import jax
    import jax.numpy as jnp

    from pluto_gps_sim_tpu.models.geodesy import llh2xyz, xyz2llh
    from pluto_gps_sim_tpu.parallel import MonteCarloBatch, make_mesh
    from pluto_gps_sim_tpu.runtime.stream import IqStream

    one = devices[0]
    mesh = make_mesh(devices)
    rin, g0, ieph, xyz = _scenario()
    # the ramp (1, 2, 4, ...) then one full K group
    ramp, sizes = [], IqStream.dispatch_ramp(k_sf)
    while not ramp or ramp[-1] < k_sf:
        ramp.append(next(sizes))
    n_blocks = sum(ramp) * max_blocks

    def stream(**kw):
        return list(IqStream(
            rin, g0, ieph, xyz, fs=fs, block_samples=block_samples,
            mode="fused", superframes_per_dispatch=k_sf, **kw).superframes(
                n_blocks, max_blocks=max_blocks, as_device=True))

    a, b = stream(device=one), stream(mesh=mesh)
    same = [bool(jnp.array_equal(x, jax.device_put(y, one)))
            for x, y in zip(a, b)]
    print(f"  IqStream over mesh time={mesh.shape['time']} "
          f"chan={mesh.shape['chan']}: groups {[x.shape[0] for x in b]} "
          f"blocks, identical to one device: {same}", flush=True)
    check(len(a) == len(b) == len(ramp) and all(same), "sharded stream")

    rng = np.random.RandomState(5)
    llh0 = np.asarray(xyz2llh(xyz))
    rx = np.stack([np.asarray(llh2xyz(llh0 + [rng.uniform(-1e-4, 1e-4),
                                              rng.uniform(-1e-4, 1e-4),
                                              rng.uniform(0, 100)]))
                   for _ in range(mc_receivers)])

    def batch(**kw):
        mc = MonteCarloBatch(rin, g0, ieph, rx, fs=fs,
                             block_samples=block_samples)
        return [out for _, out in mc.superframes(mc_blocks, as_device=True,
                                                 **kw)]

    a, b = batch(device=one), batch(mesh=mesh)
    same = len(a) == len(b) == 1 and bool(
        jnp.array_equal(a[0], jax.device_put(b[0], one)))
    print(f"  MonteCarloBatch {mc_receivers} x {mc_blocks} blocks over the "
          f"mesh: identical to one device: {same}", flush=True)
    check(same, "sharded Monte-Carlo batch")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "pluto_gps_sim_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        with phase("0 device"):
            card = card_line()
            import jax

            from pluto_gps_sim_tpu.runtime.device import (
                configure_compile_cache)
            print(card, flush=True)
            print(f"  jax {jax.__version__}, compile cache "
                  f"{configure_compile_cache()}", flush=True)
        if not args.four_cards:
            with phase("1 gpu tests"):
                gpu_tests()
        devices = jax.devices()
        dev = devices[0]
        print(f"  devices: {len(devices)} x {dev.platform} "
              f"({dev.device_kind})", flush=True)
        check(dev.platform == "gpu", f"JAX found no GPU ({dev.platform})")
        # host f64 math runs on the CPU; synthesis is placed explicitly
        jax.config.update("jax_default_device", jax.devices("cpu")[0])
        if args.four_cards:
            check(len(devices) >= 4, f"{len(devices)} cards, need 4")
            with phase("four cards"):
                four_cards(devices[:4])
        else:
            with phase("2 gates"):
                gates(dev, card)
                patched_gate(dev)
            with phase("3a cli"):
                tmp = tempfile.mkdtemp(prefix="chip_smoke_")
                try:
                    cli_run(tmp)
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
            with phase("3b rollover stream"):
                rollover_stream(dev)
            with phase("4 receivable"):
                receivable(dev)
            with phase("5 timing"):
                timing(dev, card)
    except Exception as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", flush=True)
        return 1
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
