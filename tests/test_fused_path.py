"""The fused synthesis path: its XLA version against the f64 precise
path at the edges of its range, the Triton kernel (interpret mode)
against the XLA version, the row patch pass, the wrapper's shapes and
padding, and the one device-selection point."""

from __future__ import annotations

import json
import os
import re

import jax
import numpy as np
import pytest

from pluto_gps_sim_tpu.constants import MAX_CHAN, R2D
from pluto_gps_sim_tpu.ingest import read_rinex2
from pluto_gps_sim_tpu.models.cacode import CA_TABLE
from pluto_gps_sim_tpu.models.geodesy import llh2xyz
from pluto_gps_sim_tpu.ops import params as pp
from pluto_gps_sim_tpu.ops import synth_fused as sf
from pluto_gps_sim_tpu.ops.synth_jnp import (
    pack_plan, split_plan, synth_superframe_precise)
from pluto_gps_sim_tpu.runtime import select_ephemeris_set, setup_scenario
from pluto_gps_sim_tpu.runtime.scheduler import Scheduler, SuperframePlan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKYO = np.array([35.681298 / R2D, 139.766247 / R2D, 10.0])


@pytest.fixture(scope="module")
def scenario(fixture_paths):
    rin = read_rinex2(fixture_paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    return rin, g0, ieph, np.asarray(llh2xyz(TOKYO))


def _synth(dp):
    return pp.unpack_iq(np.asarray(sf.synth_blocks(
        pp.build_group_params([dp]), pp.pack_ca_tables([dp.ca2]),
        np.zeros(dp.n_blocks, np.int32), dp.block_samples)))


def _group(scenario, n_sf: int, block_samples: int):
    rin, g0, ieph, xyz = scenario
    sched = Scheduler(rin, g0, ieph, xyz, fs=1e6, block_samples=block_samples)
    dps = [pack_plan(p, tables=False) for p in sched.plan_group(n_sf, 2)]
    sf_map = np.concatenate([np.full(d.n_blocks, i, np.int32)
                             for i, d in enumerate(dps)])
    return (pp.build_group_params(dps),
            pp.pack_ca_tables([d.ca2 for d in dps]), sf_map)


def _boundary_plan(n_blocks: int, patched_block: int, n: int = 8192):
    """Three active channels; channel 1 of one block carries the gain
    whose 405*g product sits on a trunc boundary (two patch words with
    the nudge off)."""
    rng = np.random.RandomState(7)
    c_all = MAX_CHAN
    active = np.zeros((n_blocks, c_all), bool)
    active[:, :3] = True
    f_carr = np.zeros((n_blocks, c_all))
    f_carr[:, :3] = [-2717.3, 395.9, -967.7]
    gain = np.where(active, 0.5, 0.0)
    gain[patched_block, 1] = 0.9086419713826426
    plan = SuperframePlan(
        n_blocks=n_blocks, block_samples=n, delt=1.0 / 2.6e6,
        prn=np.where(active[0], np.arange(1, c_all + 1), 0).astype(np.int32),
        ca2=(CA_TABLE[np.arange(c_all)] * 2 - 1).astype(np.int8),
        bits=rng.choice([-1, 1], (c_all, 1800)).astype(np.int8),
        active=active, f_carr=f_carr, f_code=1_023_000.0 + f_carr / 1540.0,
        code_phase=rng.uniform(0, 1023, (n_blocks, c_all)),
        icode=rng.randint(0, 20, (n_blocks, c_all)).astype(np.int32),
        ibit=rng.randint(0, 30, (n_blocks, c_all)).astype(np.int32),
        iword=rng.randint(0, 10, (n_blocks, c_all)).astype(np.int32),
        carr_phase=rng.uniform(0, 1, (n_blocks, c_all)), gain=gain,
        azel=np.zeros((n_blocks, c_all, 2)))
    return pack_plan(plan)


def test_fused_matches_precise_at_top_of_5mhz_range(scenario):
    """500k-sample rows put the Q24/Q36 ramps at the top of their range
    (n reaches 499999 of the 524287 bound)."""
    rin, g0, ieph, xyz = scenario
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=5e6).plan(2))
    assert dp.block_samples == 500_000
    got = _synth(dp)
    assert got.shape == (2, 500_000, 2)
    assert np.array_equal(got, synth_superframe_precise(dp))


def test_fused_split_rows_at_10mhz_match_precise(scenario):
    """fs=10 MHz: each 1M-sample block splits into two re-anchored 500k
    sub-blocks; the fused path tracks the split precise path, and the
    reassembled rows track the unsplit one (same gate as on the card)."""
    rin, g0, ieph, xyz = scenario
    dp = pack_plan(Scheduler(rin, g0, ieph, xyz, fs=10e6).plan(1))
    dps = split_plan(dp, pp.MAX_BLOCK_SAMPLES)
    assert (dps.n_blocks, dps.block_samples) == (2, 500_000)
    got = _synth(dps)
    for have, want in ((got, synth_superframe_precise(dps)),
                       (got.reshape(1, -1, 2)[:, :dp.block_samples],
                        synth_superframe_precise(dp))):
        diff = np.abs(have.astype(np.int64) - want.astype(np.int64))
        assert np.mean(diff == 0) >= 1 - 2e-6 and diff.max() <= 8


def test_triton_kernel_interpret_matches_xla(scenario):
    """The GPU kernel, run by the Pallas interpreter, is bit-identical to
    the XLA main pass on a two-superframe group with inactive (zero-gain)
    slots and a block length that is not a multiple of its tile."""
    from pluto_gps_sim_tpu.ops import synth_triton

    bp, ca, sf_map = _group(scenario, 2, 5000)
    prmi = bp.prmi[:, :pp.PLANE_HALF]
    prmf = bp.prmf[:, :pp.PLANE_HALF]
    assert np.any(prmf[:, pp._F_GAIN:pp._F_GAIN + MAX_CHAN] == 0)
    with jax.enable_x64(False):
        want = np.asarray(sf.main_pass(prmi, prmf, ca, sf_map, 5000))
        got = np.asarray(jax.jit(
            lambda *a: synth_triton.main_pass(*a, 5000, interpret=True))(
                prmi, prmf, ca, sf_map))
    assert got.shape == (sf_map.size, 5000)
    assert np.array_equal(got, want)


def test_xla_main_pass_block_chunks_match_one_pass(scenario):
    """Groups longer than one block chunk (padded to whole chunks and
    trimmed back) give the same output as one unchunked pass."""
    bp, ca, sf_map = _group(scenario, 1, 1024)
    m = sf._REF_CHUNK * 2 + 5
    prmi = np.tile(bp.prmi[:, :pp.PLANE_HALF], (m // 2 + 1, 1))[:m]
    prmf = np.tile(bp.prmf[:, :pp.PLANE_HALF], (m // 2 + 1, 1))[:m]
    sf_map = np.zeros(m, np.int32)
    with jax.enable_x64(False):
        chunked = np.asarray(sf.main_pass(prmi, prmf, ca, sf_map, 1024))
        whole = np.asarray(sf.pack_iq(*sf._main_pass(prmi, prmf, ca, sf_map,
                                                     1024)))
    assert chunked.shape == (m, 1024)
    assert np.array_equal(chunked, whole)


def test_patch_args_bucket_and_pad_rows():
    """Patched rows bucket to a power of two >= 8, padded with copies of
    the last patched row; a forced pass on a patch-free dispatch patches
    block 0 with empty slots; no words and no force compiles it out."""
    m = 12
    prmi = np.arange(m * 256, dtype=np.int32).reshape(m, 256)
    prmf = np.zeros((m, 256), np.float32)
    prmf[[3, 7], pp.patch_word_lane(0)] = 1234.0
    sf_map = np.arange(m, dtype=np.int32) // 5
    rows, slot_i, slot_f, sf_rows = sf.patch_args(prmi, prmf, sf_map)
    assert list(rows) == [3, 7, 7, 7, 7, 7, 7, 7]
    assert np.array_equal(slot_i, prmi[rows, 128:])
    assert np.array_equal(slot_f, prmf[rows, 128:])
    assert np.array_equal(sf_rows, sf_map[rows])

    empty = np.zeros((m, 256), np.float32)
    assert sf.patch_args(prmi, empty, sf_map) is None
    rows, slot_i, slot_f, _ = sf.patch_args(prmi, empty, sf_map, force=True)
    assert rows.shape == (8,) and not rows.any()
    assert not slot_f.any()


def test_patch_pass_touches_only_patched_rows():
    """Nudge off: the one block that carries words is corrected to the
    precise path; every other row is left exactly as the main pass made
    it; the forced variant on a patch-free dispatch changes nothing."""
    dp = _boundary_plan(3, patched_block=1)
    golden = synth_superframe_precise(dp)
    bp = pp.build_block_params(dp, nudge=False)
    assert list(sf.patch_rows(bp.prmf)) == [1]
    ca = pp.pack_ca_tables([dp.ca2])
    sf_map = np.zeros(3, np.int32)
    n = dp.block_samples
    patched = pp.unpack_iq(np.asarray(sf.synth_blocks(bp, ca, sf_map, n)))
    unpatched = pp.unpack_iq(np.asarray(sf.synth_blocks(
        (bp.prmi, bp.prmf[:, :128]), ca, sf_map, n)))
    assert np.array_equal(patched, golden)
    assert np.array_equal(patched[[0, 2]], unpatched[[0, 2]])
    assert not np.array_equal(patched[1], unpatched[1])

    clean = pp.build_block_params(dp)       # nudge on: no words at all
    assert sf.patch_rows(clean.prmf).size == 0
    a = np.asarray(sf.synth_blocks(clean, ca, sf_map, n))
    b = np.asarray(sf.synth_blocks(clean, ca, sf_map, n, force_patches=True))
    assert np.array_equal(a, b)


@pytest.mark.parametrize("time_shards, chan_shards", [(4, 1), (2, 2)])
def test_sharded_patched_dispatch_matches_single(time_shards, chan_shards):
    """Patch words on a mesh: each time shard patches only its own rows
    (after the channel psum), matching the single-device output."""
    from pluto_gps_sim_tpu.parallel import make_mesh, synth_sharded

    dp = _boundary_plan(6, patched_block=4)
    bp = pp.build_block_params(dp, nudge=False)
    ca = pp.pack_ca_tables([dp.ca2])
    sf_map = np.zeros(6, np.int32)
    single = np.asarray(sf.synth_blocks(bp, ca, sf_map, dp.block_samples))
    mesh = make_mesh(jax.devices("cpu")[:4], time_shards=time_shards,
                     chan_shards=chan_shards)
    got = np.asarray(synth_sharded(mesh, bp.prmi, bp.prmf, ca, sf_map,
                                   dp.block_samples))
    assert got.shape == single.shape == (6, dp.block_samples)
    assert np.array_equal(got, single)
    assert np.array_equal(pp.unpack_iq(got), synth_superframe_precise(dp))


def test_make_synth_tiled_compiles_once_per_shape():
    from pluto_gps_sim_tpu.ops.synth_jnp import make_synth_tiled

    a = make_synth_tiled(3, 5000, 3)
    assert make_synth_tiled(3, 5000, 3) is a
    assert make_synth_tiled(4, 5000, 3) is not a


def test_device_selection_point():
    """One helper picks the synthesis device (the default backend's first
    device) and the main-pass implementation follows its platform."""
    from types import SimpleNamespace

    from pluto_gps_sim_tpu.runtime.device import (device_info,
                                                  synthesis_device)

    dev = synthesis_device()
    assert dev == jax.local_devices()[0] == jax.devices()[0]
    info = device_info()
    assert info == {"platform": dev.platform, "kind": dev.device_kind,
                    "count": len(jax.devices())}
    assert sf.kernel_for(dev) == "xla"                 # the suite's CPU
    assert sf.kernel_for(SimpleNamespace(platform="gpu")) == "triton"


def test_cli_auto_mode_is_fused_and_names_device(tmp_path, fixture_paths,
                                                  capsys):
    from pluto_gps_sim_tpu.cli import main

    out = str(tmp_path / "auto.bin")
    assert main(["-e", fixture_paths["rinex2"], "-l",
                 "35.681298,139.766247,10.0", "-s", "1000000", "-d", "0.2",
                 "-o", out, "--stats"]) == 0
    err = capsys.readouterr().err
    dev = jax.devices()[0]
    assert f"Synthesis: fused on {dev.platform} ({dev.device_kind})" in err
    line = next(ln for ln in err.splitlines() if ln.startswith("sink stats"))
    stats = json.loads(line.split("sink stats: ", 1)[1])
    assert stats["mode"] == "fused"
    assert stats["device"]["platform"] == dev.platform
    assert stats["samples"] == 200_000


def test_compile_cache_dir(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at a fixed, git-ignored path inside the checkout."""
    from pluto_gps_sim_tpu.runtime import device

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert device.compile_cache_dir() == "/elsewhere/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    default = device.compile_cache_dir()
    assert default == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()
    old = jax.config.jax_compilation_cache_dir
    try:
        assert device.configure_compile_cache() == default
        assert jax.config.jax_compilation_cache_dir == default
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_factor_devices_defaults_to_time():
    from pluto_gps_sim_tpu.parallel import factor_devices, make_mesh

    assert factor_devices(4) == (4, 1)
    assert factor_devices(8, chan_shards=2) == (4, 2)
    with pytest.raises(ValueError):
        factor_devices(6, chan_shards=4)
    cpus = jax.devices("cpu")[:8]
    assert dict(make_mesh(cpus).shape) == {"time": 8, "chan": 1}
    assert dict(make_mesh(cpus, chan_shards=2).shape) == {"time": 4, "chan": 2}
    assert dict(make_mesh(cpus, time_shards=2).shape) == {"time": 2, "chan": 4}


def test_no_interpret_or_tpu_branch_left():
    """No interpret-mode fallback and no TPU platform branch in the
    program: interpret mode exists only as the Triton kernel's test
    hook."""
    files = [os.path.join(REPO, f) for f in
             ("bench.py", "__graft_entry__.py", "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pluto_gps_sim_tpu")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fp:
            src = fp.read()
        rel = os.path.relpath(path, REPO)
        if rel != os.path.join("pluto_gps_sim_tpu", "ops", "synth_triton.py"):
            assert not re.search(r"\binterpret\b", src), rel
        for bad in ('== "tpu"', "pallas.tpu", "pltpu",
                    "PrefetchScalarGridSpec"):
            assert bad not in src, (rel, bad)
