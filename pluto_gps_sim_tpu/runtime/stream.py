"""IQ stream driver: scheduler -> device synthesis -> consumer.

Replaces the reference's mutex/condvar double-buffer handoff to the SDR
thread (plutogpssim.c:2689-2759, 2146-2158) with a pull-based generator
of superframe-sized int16 IQ arrays.  The device produces far faster
than real time; sinks (files, UDP, SDR bridges) pace themselves.

Also exposes snapshot/restore: because all per-sample state is
closed-form from (scheduler state, block index), resuming a stream is
just re-planning from the saved host state — the checkpoint is a few KB.
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
from typing import Iterator

import numpy as np

from ..models.gpstime import GpsTime
from ..ingest.rinex import RinexResult
from ..ops import params as pp
from ..ops import synth_fused
from ..ops.synth_jnp import (
    DevicePlan,
    pack_plan,
    split_plan,
    synth_superframe_precise,
    synth_superframe_tiled_async,
)
from .device import synthesis_device
from .scheduler import Scheduler

__all__ = ["IqStream"]


class IqStream:
    """Iterates int16 IQ superframes [M, N, 2] for a scenario.

    superframes_per_dispatch=K batches K consecutive superframes into
    ONE device call (multi-superframe sf_map + per-superframe C/A
    tables), amortizing per-dispatch latency over K x 30 s of signal;
    the yielded arrays are identical, just K superframes tall (the
    first few groups ramp 1, 2, 4, ... so a cold pipeline delivers its
    first samples ~5x sooner — dispatch_ramp()).  Device memory
    bounds K: the pipeline keeps up to THREE groups' packed outputs
    resident (~K x 0.31 GB each at fs=2.6 MHz).

    mode: "fused" (production: ops.synth_fused on the synthesis
    device), "tiled" (the per-tile XLA reference path, same device) or
    "precise" (the f64 reference, CPU).  device defaults to
    runtime.device.synthesis_device().

    n_hosts/host_id partition a finite stream across hosts: host h
    fast-forwards the deterministic control plane to its contiguous
    share and synthesizes only blocks [h*M/N, (h+1)*M/N); the N hosts'
    outputs concatenate byte-identically to an unsharded run (split
    invariance is what legalizes this — see test_split_invariance)."""

    def __init__(self, rin: RinexResult, start: GpsTime, ieph: int,
                 xyz: np.ndarray, fs: float,
                 block_samples: int | None = None,
                 static_mode: bool = True,
                 mode: str = "fused", device=None, mesh=None,
                 superframes_per_dispatch: int = 1,
                 n_hosts: int = 1, host_id: int = 0):
        self.sched = Scheduler(rin, start, ieph, xyz, fs,
                               block_samples=block_samples,
                               static_mode=static_mode)
        if superframes_per_dispatch < 1:
            raise ValueError("superframes_per_dispatch must be >= 1")
        self.superframes_per_dispatch = int(superframes_per_dispatch)
        if not (0 <= host_id < n_hosts):
            raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
        self.n_hosts = int(n_hosts)
        self.host_id = int(host_id)
        if mode not in ("tiled", "precise", "fused"):
            raise ValueError(f"unknown synthesis mode {mode!r}")
        if mesh is not None and mode != "fused":
            raise ValueError("mesh sharding requires mode='fused'")
        # blocks beyond the fused path's Q24 range (fs > 5.24 MHz at
        # 0.1 s blocks) split into K equal re-anchored sub-blocks
        # (ops.synth_jnp.split_plan) — sub-blocks are just shorter rows
        # of the block axis, so the production path covers ANY
        # -s >= 1 MHz like the reference (c:2326-2329); _finish
        # reassembles [M*K, sub] -> [M, N]
        self._split_k = 1
        if mode == "fused":
            n = self.sched.block_samples
            if n > pp.MAX_BLOCK_SAMPLES:
                self._split_k = -(-n // pp.MAX_BLOCK_SAMPLES)
        self.mode = mode
        # public split geometry for as_device consumers (see
        # superframes()); sub_block_samples matches what split_plan
        # derives per dispatch
        self.split_k = self._split_k
        self.sub_block_samples = -(-self.sched.block_samples
                                   // self._split_k)
        self.device = (device if device is not None or mode == "precise"
                       else synthesis_device())
        self.mesh = mesh  # jax.sharding.Mesh("time", "chan") or None
        # gain-trunc patch words dropped to the per-block slot cap by
        # THIS stream's dispatches (each leaves one LUT entry at the
        # device's f32 trunc, +-1 LSB on that block's dwell samples);
        # per-stream so concurrent streams / MC batches attribute drops
        self.patch_dropped = 0
        # one-compiled-variant latch: patch-free groups compile the
        # patch pass out, but the first group that carries a residual
        # patch word (rare mixed-direction straddle; measured zero on
        # every scenario since the gain nudge) needs it — latch it so
        # the stream keeps the patch-pass variant from then on instead
        # of flip-flopping between compiled shapes mid-stream
        self._saw_patches = False
        # packed C/A tables keyed by the +-1 chip table's bytes: the
        # channel allocation only changes at rise/set (minutes), so
        # every superframe of a dispatch group usually shares ONE
        # table and the bit-pack pass (~1.2 ms/table on one core, on
        # the host-bound critical path) collapses to dict hits
        self._ca_cache: dict = {}

    @staticmethod
    def dispatch_ramp(k: int) -> Iterator[int]:
        """Dispatch-group sizes for superframes_per_dispatch=k: 1, 2,
        4, ..., then k forever.  A cold pipeline has nothing to hide
        host planning or device synthesis under, so the first full-k
        group exposes its whole plan+synthesize latency (~0.25 s at
        k=8/2.6 MHz) before the first sample emerges; ramping doubles
        the group size as the pipeline fills, cutting time-to-first-
        sample ~5x while steady state is unchanged.  Deterministic and
        public so shadow streams / A-B tests can mirror the grouping."""
        s = 1
        while s < k:
            yield s
            s *= 2
        while True:
            yield k

    def superframes(self, n_blocks_total: int | None,
                    max_blocks: int = 300,
                    as_device: bool = False) -> Iterator:
        """Yield superframes covering n_blocks_total 0.1 s blocks
        (None = endless).

        The loop is software-pipelined TWO dispatch groups deep with
        all host planning on a background thread: the planner plans,
        packs, and dispatches group k+2 while group k+1 synthesizes on
        the device and group k is consumed by the caller — so host
        control plane, device synthesis, per-call dispatch latency,
        and D2H transfer all overlap (the reference's equivalent is the
        producer/TX double buffer, c:2689-2759, which overlaps exactly
        one buffer).  The host work is numpy/CPU-jax, which releases
        the GIL, and the dispatch-side waits are PCIe I/O — both
        overlap the consumer even on a single-core host.  Device memory
        bounds the depth: up to THREE groups' packed outputs are
        resident at once (consumed + queued + dispatching, ~K x 0.31 GB
        each at fs=2.6 MHz).

        snapshot() during iteration returns the resume point right
        after the last *yielded* superframe, not the planned-ahead
        scheduler state; abandoning the generator rolls the scheduler
        back to exactly after the last yielded superframe.

        as_device=True yields the raw device output instead of host
        int16 [M, N, 2] — for the fused path, packed int32 IQ [M, N]
        still on the device — so device-side consumers (reductions,
        swarm statistics, a device-resident downstream DSP stage) skip
        the host fetch entirely.  When the transparent sub-block split
        is active (self.split_k > 1, i.e. block_samples exceeded the
        fused path's Q24 range), the raw rows are the SUB-blocks:
        [M*split_k, sub_block_samples], the last sub-row of each
        scenario block extrapolating past the block end — a consumer
        mapping rows to 0.1 s blocks must reassemble via (split_k,
        sub_block_samples); host-fetch consumers get the reassembled
        [M, N, 2] either way.
        """
        if self.n_hosts > 1:
            if n_blocks_total is None:
                raise ValueError(
                    "host-partitioned streams need a finite n_blocks_total")
            lo = self.host_id * n_blocks_total // self.n_hosts
            hi = (self.host_id + 1) * n_blocks_total // self.n_hosts
            if self.sched.jblk > lo:
                raise RuntimeError(
                    f"scheduler already at block {self.sched.jblk}, past "
                    f"this host's partition start {lo}")
            self.fast_forward(lo - self.sched.jblk)
            remaining = hi - lo
        else:
            remaining = n_blocks_total

        # maxsize=1 + the item the planner is blocked putting = two
        # dispatched groups ahead of the consumer (see HBM note above)
        q: _queue.Queue = _queue.Queue(maxsize=1)
        stop = threading.Event()
        lock = threading.Lock()
        # before-planning snapshots of every group not yet yielded, in
        # plan order — [0] is the rollback point if the generator is
        # abandoned (covers queued, dispatching, and mid-plan groups)
        unyielded: collections.deque = collections.deque()

        def _put(item) -> None:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except _queue.Full:
                    continue

        def _planner() -> None:
            rem = remaining
            ramp = self.dispatch_ramp(self.superframes_per_dispatch)
            try:
                while not stop.is_set():
                    if rem is not None and rem <= 0:
                        break
                    with lock:
                        unyielded.append(self._state_snapshot())
                    k = next(ramp)
                    if self.superframes_per_dispatch > 1:
                        plans = self.sched.plan_group(
                            k, max_blocks, total_blocks=rem)
                    else:
                        todo = max_blocks if rem is None else \
                            min(rem, max_blocks)
                        plan = self.sched.plan(todo)
                        plans = [] if plan is None else [plan]
                    if not plans:
                        with lock:
                            unyielded.pop()
                        break
                    if rem is not None:
                        rem -= sum(p.n_blocks for p in plans)
                    prep = self._prepare_group(plans)   # host-only work
                    after = self._state_snapshot()
                    handle = self._dispatch_prepared(prep)
                    if not as_device:
                        # enqueue the D2H now so delivery overlaps the
                        # next group's synthesis (the reference's
                        # memcpy-under-mutex handoff, c:2147-2150,
                        # serializes here instead)
                        self._start_fetch(handle)
                    _put(("ok", handle, after))
            except BaseException as e:        # surfaced at the consumer
                _put(("err", e))
                return
            _put(None)

        # resume point before anything is yielded = the iteration start
        # (snapshot() must not read live scheduler state once the
        # planner owns it)
        self._yield_snap = self._state_snapshot()
        self._planner_alive = True
        t = threading.Thread(target=_planner, name="iqstream-planner",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if item[0] == "err":
                    raise item[1]
                _, handle, snap_after = item
                out = (self._device_view(handle) if as_device
                       else self._finish(handle))
                with lock:
                    unyielded.popleft()
                self._yield_snap = snap_after
                yield out      # abandonment suspends HERE
        finally:
            stop.set()
            # unblock a planner stuck in put(), then wait it out before
            # touching scheduler state
            try:
                while True:
                    q.get_nowait()
            except _queue.Empty:
                pass
            t.join()
            self._planner_alive = False
            if unyielded:
                # groups were planned (and possibly dispatched) but
                # never yielded: roll the scheduler back so a later
                # superframes()/generate() call resumes exactly after
                # the last DELIVERED superframe instead of silently
                # skipping signal
                self.restore(unyielded[0])

    def generate(self, n_blocks_total: int) -> np.ndarray:
        """Generate the whole scenario into one array [blocks, N, 2]."""
        parts = list(self.superframes(n_blocks_total))
        return np.concatenate(parts, axis=0)

    def fast_forward(self, n_blocks: int) -> None:
        """Advance the scheduler n_blocks without synthesizing — the
        host-partition entry point.  O(boundaries), not O(blocks): the
        closed-form carrier anchors (scheduler module docstring) mean
        host h of N reaches its partition start by maintaining only the
        per-30 s boundary state (~2 ms per simulated 30 s), so the
        control-plane replay cost of deep partitions is negligible."""
        self.sched.skip(n_blocks)

    # -- dispatch / fetch ------------------------------------------------

    def _prepare_group(self, plans: list):
        """ALL host-side packing for one dispatch group (runs on the
        planner thread): plan -> DevicePlan pack, and for the fused
        path the parameter planes, C/A bit tables, and
        block->superframe map.  No device calls here — the split from
        _dispatch_prepared is what lets planning overlap synthesis."""
        if self.mode != "fused":
            return ("plain", [self._pack(p) for p in plans])

        dps = [self._pack(p) for p in plans]
        n_orig = dps[0].block_samples
        if self._split_k > 1:
            dps = [split_plan(dp, pp.MAX_BLOCK_SAMPLES) for dp in dps]
        # one batched build for the whole group (bit-identical to
        # per-plan builds + concat; amortizes numpy per-op dispatch,
        # the host-bound pipeline's dominant control cost after the
        # range solve)
        bp = pp.build_group_params(dps)
        self.patch_dropped += bp.patch_dropped
        prmi, prmf = bp.prmi, bp.prmf
        if not self._saw_patches and np.any(prmf[:, 128:]):
            self._saw_patches = True
        ca_tabs = self._pack_ca_group([dp.ca2 for dp in dps])
        sf_map = np.concatenate(
            [np.full(dp.n_blocks, i, np.int32)
             for i, dp in enumerate(dps)])
        return ("fused", dps[0], prmi, prmf, ca_tabs, sf_map, n_orig)

    def _pack_ca_group(self, ca2s: list) -> np.ndarray:
        """pack_ca_tables through the per-stream packed-table cache.

        Output is bit-identical to pp.pack_ca_tables(ca2s) and keeps its
        [len(ca2s), C, 32] shape (one table slot per superframe, so the
        compiled shape per group size is unchanged) — only the
        per-table packing work is deduplicated."""
        packed = []
        for ca2 in ca2s:
            key = ca2.tobytes()
            hit = self._ca_cache.pop(key, None)   # pop+reinsert = LRU:
            if hit is None:                       # a table hit every group
                if len(self._ca_cache) >= 64:     # but inserted early must
                    self._ca_cache.pop(next(iter(self._ca_cache)))  # stay
                hit = pp.pack_ca_tables([ca2])[0]
            self._ca_cache[key] = hit
            packed.append(hit)
        return np.stack(packed)

    def _dispatch_prepared(self, prep):
        """Start the device work for a prepared group; returns the
        opaque handle _finish/_device_view consume."""
        if prep[0] == "fused":
            _, dp0, prmi, prmf, ca_tabs, sf_map, n_orig = prep
            out = self._launch_fused(prmi, prmf, ca_tabs, sf_map,
                                     dp0.block_samples)
            return ("packed", out, (dp0, n_orig))
        dps = prep[1]
        if len(dps) == 1:
            return self._dispatch(dps[0])
        # tiled/precise: per-plan dispatches, one concatenated yield
        return ("multi", [self._dispatch(d) for d in dps], None)

    def _dispatch_group(self, plans: list):
        """Prepare + dispatch one or more consecutive superframe plans
        as ONE device call (fused: multi-superframe sf_map +
        per-superframe C/A tables, ops.synth_fused), so the
        per-dispatch flat cost amortizes over superframes_per_dispatch
        x 30 s of signal."""
        return self._dispatch_prepared(self._prepare_group(plans))

    def _device_view(self, handle):
        """The raw (device-resident) output behind a dispatch handle, as
        ONE array over the group's blocks — what as_device=True yields.
        Fused groups are already a single packed array; tiled/precise
        groups dispatch per plan, so their outputs concatenate here
        (on device for tiled, host for precise)."""
        kind, out, _ = handle
        if kind != "multi":
            return out
        parts = [h[1] for h in out]
        if out[0][0] == "np":
            return np.concatenate(parts, axis=0)
        import jax.numpy as jnp
        return jnp.concatenate(parts, axis=0)

    def _start_fetch(self, handle) -> None:
        """Begin the device->host copy without blocking; _finish's
        np.asarray then consumes the already-moving buffer."""
        kind, out, _ = handle
        outs = [h[1] for h in out] if kind == "multi" else [out]
        for o in outs:
            fn = getattr(o, "copy_to_host_async", None)
            if fn is not None:
                fn()

    def _dispatch(self, dp: DevicePlan):
        """Start synthesis of one superframe; returns an opaque handle
        (an asynchronously-computing device array + unpack recipe)."""
        if self.mode == "precise":
            return ("np", synth_superframe_precise(dp), dp)
        return ("jax", synth_superframe_tiled_async(dp, device=self.device),
                dp)

    def _finish(self, handle) -> np.ndarray:
        kind, out, dp = handle
        if kind == "np":
            return out
        if kind == "jax":
            return np.asarray(out)
        if kind == "multi":
            return np.concatenate([self._finish(h) for h in out], axis=0)
        dp0, n_orig = dp
        iq = pp.unpack_iq(out)                     # [M*K, sub, 2]
        if self._split_k > 1:
            # reassemble sub-blocks into scenario blocks; the last
            # sub-block of each row extrapolated past the true block
            # end (split_plan), so trim K*sub -> N
            k = self._split_k
            iq = iq.reshape(iq.shape[0] // k, k * iq.shape[1], 2)
            iq = iq[:, :n_orig]
        return iq

    def _pack(self, plan) -> DevicePlan:
        return pack_plan(plan, tables=self.mode != "fused")

    def _launch_fused(self, prmi, prmf, ca_tabs, sf_map,
                      block_samples: int):
        """The fused synthesis — on the synthesis device, or sharded
        over a ("time", "chan") mesh.  Multiple superframes batch into
        one call through the block->superframe map and per-superframe
        C/A tables (inputs come packed from _prepare_group, which runs
        on the planner thread)."""
        if self.mesh is not None:
            from ..parallel import synth_sharded
            return synth_sharded(self.mesh, prmi, prmf, ca_tabs, sf_map,
                                 block_samples)
        return synth_fused.synth_blocks(
            (prmi, prmf), ca_tabs, sf_map, block_samples,
            device=self.device, force_patches=self._saw_patches)

    # -- snapshot / resume ---------------------------------------------------

    def _state_snapshot(self) -> dict:
        s = self.sched
        return {
            "jblk": s.jblk, "ieph": s.ieph,
            "channel_state": {k: np.copy(v) for k, v in
                              vars(s.state).items()},
        }

    def snapshot(self) -> dict:
        """Host state capsule; everything device-side is derived.

        During superframes() iteration this is the resume point after
        the last yielded superframe (the planner thread runs up to two
        dispatch groups ahead, see superframes()); while the planner is
        alive the live scheduler state is ITS working state and is
        never read here (the frozen per-yield capsule is)."""
        snap = getattr(self, "_yield_snap", None)
        if snap is not None and (getattr(self, "_planner_alive", False)
                                 or snap["jblk"] != self.sched.jblk):
            return {"jblk": snap["jblk"], "ieph": snap["ieph"],
                    "channel_state": {k: np.copy(v) for k, v in
                                      snap["channel_state"].items()}}
        return self._state_snapshot()

    def restore(self, snap: dict) -> None:
        s = self.sched
        # a snapshot written by an older schema (e.g. one without the
        # carrier anchor pair) would leave fields at their defaults and
        # resume with a silent per-channel phase discontinuity at the
        # splice — fail loudly instead
        missing = set(vars(s.state)) - set(snap["channel_state"])
        if missing:
            raise ValueError(
                f"snapshot lacks channel-state fields {sorted(missing)} "
                "(written by an incompatible framework version?)")
        s.jblk = snap["jblk"]
        s.ieph = snap["ieph"]
        for k, v in snap["channel_state"].items():
            setattr(s.state, k, np.copy(v))
        self._yield_snap = None
