"""Multi-process distributed synthesis dryrun.

Two jax.distributed processes x 4 virtual CPU devices each form one
8-device global mesh whose CHANNEL axis spans the process boundary, so
the composite psum crosses processes — the communication pattern of a
real multi-host deployment (SCALING.md).  Each worker verifies its
addressable output shards bit-for-bit against an unsharded local run.

The reference has no distributed story at all (one process, two threads,
plutogpssim.c:2689-2759); this is the framework's multi-host north star
exercised as far as a single machine allows.
"""

from __future__ import annotations

from pluto_gps_sim_tpu.parallel.multiproc_dryrun import (
    OK_TAG,
    run_multiprocess_dryrun,
)


def test_two_process_dcn_dryrun():
    out = run_multiprocess_dryrun(2, timeout=420.0)
    assert out.count(OK_TAG) == 2
    assert "chan spans processes" in out
