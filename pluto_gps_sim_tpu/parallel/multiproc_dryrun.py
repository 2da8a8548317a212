"""Multi-process sharded-synthesis dryrun on CPU devices.

Validates the framework's multi-HOST story on one machine: N python
processes, each owning `local_devices` virtual CPU devices, bootstrap a
global JAX runtime via jax.distributed and run three phases:

  1. synthetic-parameter sharded synthesis over one global
     ("time","chan") mesh whose CHANNEL axis spans the process boundary
     — the composite psum crosses processes the way it would cross the
     network between hosts — checked bit-for-bit against an unsharded
     local run;
  2. a REAL RINEX scenario host-partitioned with
     IqStream(n_hosts=N, host_id=pid): each process fast-forwards the
     control plane to its contiguous share and synthesizes only its own
     blocks; its partial stream must equal the same slice of a full
     single-host run (so the N streams concatenate byte-identically);
  3. the real scenario's scheduler-planned parameters through the
     global-mesh sharded synthesis (real scheduler -> stream path, not
     synthetic params), again checked per-shard bit-for-bit.

Workers are spawned as fresh interpreters through `python -c` because
(a) JAX/XLA env vars must be set before any jax import and (b)
jax.distributed.initialize must run before anything initializes the XLA
backend.  The -c stub initializes the distributed runtime FIRST and only
then imports the package and calls worker_body().

Coordinator helper `run_multiprocess_dryrun(n_processes)` spawns the
workers and collects their verdicts; used by __graft_entry__'s
dryrun_multichip and tests/test_multiprocess.py.

Reference contrast: the reference is a single process whose only
parallelism is one generator thread + one TX thread over a mutex
(plutogpssim.c:2689-2759); its strictly sequential time loop is what the
closed-form time axis removes (SURVEY.md section 2, parallelism notes).
"""

from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["run_multiprocess_dryrun", "worker_body"]

LOCAL_DEVICES = 4
OK_TAG = "MULTIPROC_DRYRUN OK"


def _real_scenario():
    """(rin, g0, ieph, xyz) from the test-suite RINEX fixture — the real
    ingest -> scenario -> scheduler path, not synthetic params."""
    import numpy as np

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tests = os.path.join(repo, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from fixtures import ensure_fixtures

    from ..ingest import read_rinex2
    from ..models.geodesy import llh2xyz
    from ..runtime import select_ephemeris_set, setup_scenario

    paths = ensure_fixtures()
    rin = read_rinex2(paths["rinex2"])
    g0 = setup_scenario(rin, None)
    ieph = select_ephemeris_set(rin, g0)
    llh = np.array([35.681298, 139.766247, 10.0]) / \
        np.array([57.2957795131, 57.2957795131, 1.0])
    xyz = np.asarray(llh2xyz(llh))
    return rin, g0, ieph, xyz


def worker_body(pid: int, nproc: int) -> None:
    """Runs AFTER jax.distributed.initialize (see the -c stub below)."""
    import jax
    import numpy as np

    import pluto_gps_sim_tpu  # noqa: F401 (x64 config)
    from jax.sharding import Mesh

    from ..ops import params as pp
    from ..ops.synth_fused import synth_blocks
    from . import synth_sharded
    from .synthetic import synthetic_params

    devs = jax.devices()
    assert len(devs) == nproc * LOCAL_DEVICES, (len(devs), nproc)

    # chan axis ACROSS processes: transpose the (process, local) grid so
    # the psum over "chan" crosses the process boundary (the network
    # path on real multi-host meshes); "time" stays within each process
    grid = np.asarray(devs).reshape(nproc, LOCAL_DEVICES).T
    mesh = Mesh(grid, axis_names=("time", "chan"))

    block_samples = 32768        # tiny blocks: correctness only
    n_blocks = 2 * mesh.shape["time"]
    prmi, prmf, ca_tabs, sf_map = synthetic_params(n_blocks, block_samples)

    out = synth_sharded(mesh, prmi, prmf, ca_tabs, sf_map, block_samples)

    # unsharded local reference (every process computes the full result)
    local = jax.local_devices()[0]
    ref = np.asarray(synth_blocks(
        (prmi, prmf), ca_tabs, sf_map, block_samples, device=local))

    n_checked = 0
    for s in out.addressable_shards:
        got = np.asarray(s.data)
        want = ref[s.index]
        assert got.shape == want.shape, (got.shape, want.shape)
        assert np.array_equal(got, want), \
            f"process {pid}: shard {s.index} diverges from unsharded run"
        n_checked += 1
    assert n_checked > 0, "process owns no output shards"

    # ---- phase 2: REAL scenario, host-partitioned stream ----------------
    # The multi-host delivery story: this process plays host `pid` of
    # `nproc`, fast-forwards the deterministic control plane to its
    # contiguous share of a real RINEX scenario (ingest -> scheduler ->
    # stream, nothing synthetic) and synthesizes only its own blocks.
    # Check: its partial stream equals the same slice of a full
    # single-host run, so the nproc partial streams concatenate
    # byte-identically to the unsharded stream.
    from ..runtime.stream import IqStream

    fs, bs, n_total = 1_000_000.0, 8192, 24
    rin, g0, ieph, xyz = _real_scenario()
    # uniform 6-block spans keep the jit shape count at one per phase
    full_s = IqStream(rin, g0, ieph, xyz, fs=fs, block_samples=bs,
                      mode="tiled")
    full = np.concatenate(
        list(full_s.superframes(n_total, max_blocks=6)), axis=0)
    part = IqStream(rin, g0, ieph, xyz, fs=fs, block_samples=bs,
                    mode="tiled", superframes_per_dispatch=2,
                    n_hosts=nproc, host_id=pid)
    mine = np.concatenate(
        list(part.superframes(n_total, max_blocks=6)), axis=0)
    lo = pid * n_total // nproc
    hi = (pid + 1) * n_total // nproc
    assert mine.shape[0] == hi - lo, (mine.shape, lo, hi)
    assert np.array_equal(mine, full[lo:hi]), \
        f"process {pid}: host-partitioned stream diverges in [{lo},{hi})"

    # ---- phase 3: the real scenario's params through the global mesh ----
    # Host 0's first superframe, planned by the real scheduler, runs
    # through the sharded synthesis with the channel psum crossing the
    # process boundary; every process checks its addressable shards.
    from ..ops.synth_jnp import pack_plan

    sched_plans = IqStream(rin, g0, ieph, xyz, fs=fs, block_samples=bs,
                           mode="tiled")
    plans = sched_plans.sched.plan_group(2, max_blocks=4)
    dps = [pack_plan(p, tables=False) for p in plans]
    pairs = [pp.build_block_params(dp) for dp in dps]
    prmi_r = np.concatenate([p.prmi for p in pairs])
    prmf_r = np.concatenate([p.prmf for p in pairs])
    ca_r = pp.pack_ca_tables([dp.ca2 for dp in dps])
    sf_r = np.concatenate([np.full(dp.n_blocks, i, np.int32)
                           for i, dp in enumerate(dps)])
    out_r = synth_sharded(mesh, prmi_r, prmf_r, ca_r, sf_r, bs)
    ref_r = np.asarray(synth_blocks(
        (prmi_r, prmf_r), ca_r, sf_r, bs, device=local))
    for s in out_r.addressable_shards:
        assert np.array_equal(np.asarray(s.data), ref_r[s.index]), \
            f"process {pid}: real-scenario shard {s.index} diverges"

    print(f"{OK_TAG}: process {pid}/{nproc}, mesh time={mesh.shape['time']} "
          f"chan={mesh.shape['chan']} (chan spans processes), "
          f"{n_checked} shards bit-exact; real-scenario host partition "
          f"[{lo},{hi}) byte-identical; real-scenario mesh psum bit-exact",
          flush=True)
    # align processes before the shutdown barrier: per-process jit
    # compile times skew by minutes on a loaded host, and the barrier
    # (raised to 1200 s at initialize) should start from a common point
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("dryrun-done")
    jax.distributed.shutdown()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multiprocess_dryrun(n_processes: int = 2,
                            timeout: float = 600.0) -> str:
    """Spawn the workers; returns their combined stdout.  Raises on any
    failure (non-zero exit, missing OK tag)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # CPU-only workers: this dryrun tests the multi-process path, and
    # must not contend for a card another process may hold
    env["JAX_PLATFORMS"] = "cpu"
    stub = (
        "import os, sys\n"
        "pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "os.environ['XLA_FLAGS'] = "
        f"'--xla_force_host_platform_device_count={LOCAL_DEVICES}'\n"
        "import jax\n"
        "jax.distributed.initialize(coordinator_address=coord,"
        " num_processes=nproc, process_id=pid,"
        " shutdown_timeout_seconds=1200)\n"
        "from pluto_gps_sim_tpu.parallel.multiproc_dryrun import worker_body\n"
        "worker_body(pid, nproc)\n")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", stub, str(pid), str(n_processes), coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)
        for pid in range(n_processes)
    ]
    outs = []
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"multiprocess dryrun: process {pid} hung")
        outs.append(out)
        if p.returncode != 0 or OK_TAG not in out:
            raise RuntimeError(
                f"multiprocess dryrun: process {pid} failed "
                f"(rc={p.returncode}):\n{out}")
    return "\n".join(outs)


if __name__ == "__main__":
    # direct invocation runs the whole coordinator+workers check
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(run_multiprocess_dryrun(n))
