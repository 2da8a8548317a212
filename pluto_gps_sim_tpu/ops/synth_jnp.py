"""Composite IQ sample synthesis as closed-form phase ramps (XLA path).

This replaces the reference's sequential per-sample NCO cascade
(plutogpssim.c:2690-2756) with embarrassingly parallel math over
(block, channel, sample):

  carrier   phase(n) = frac(c0 + u*n),  u = fl(f_carr*delt)
  code      P(n)     = cp0 + v*n chips, v = fl(f_code*delt)
            chip(n)  = floor(P);  wraps w = chip//1023; chip_idx = chip%1023
            bit(n)   = bits[B0 + (C0 + w)//20]       (B0 = iword*30+ibit)
  mixing    ip = s * trunc(cosTable[idx] * gain)      (s = chip_pm * bit_pm)

The C expression `(int)(dataBit*codeCA*cosTable[i]*gain)` truncates toward
zero; since s = +-1, it equals s * trunc(table*gain), so the truncated
per-channel gain tables are precomputed once per (block, channel) in f64
on the host and the device does pure integer gathers — bit-identical
mixing to the reference.

Two precision strategies:
  * precise (f64 ramps): the golden reference, always run on the CPU;
  * tiled   (same four-level integer NCOs as the fused path —
    Q12+Q24+Q36+f32 code, u32+f32 carrier — on per-tile f64 anchors
    computed host-side, gathering the f64-exact gain tables): the
    on-device reference path (ops.synth_fused is production).
    Code-phase truncation 2^-36 chips = 1.5e-11 (the f64 closed form's
    own rounding floor), carrier ~1e-9 cycles.  Fewer levels are NOT
    enough: a two-level (Q12+f32) code NCO jitters chip edges by
    ~1.2e-7 chips (~0.1
    full-amplitude sample flips per 300k-sample block; the round-1
    "rollover cliff" was exactly this, scattered uniformly over every
    long tiled run), and even the Q24 truncation at 6e-8 chips still
    flipped ~0.03 samples/block.

Channel masking: inactive channels get zeroed gain tables and zeroed
parameters, so slots stay static-shape (jit-stable) and contribute 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CA_SEQ_LEN, MAX_CHAN
from ..models.tables import COS_TABLE_512, SIN_TABLE_512

__all__ = ["DevicePlan", "pack_plan", "split_plan",
           "synth_superframe_precise",
           "synth_superframe_tiled", "synth_superframe_tiled_async",
           "TILE"]

TILE = 2048  # samples per tile of the tiled path's per-tile anchors


@dataclass
class DevicePlan:
    """Kernel-ready arrays for one superframe (all numpy, host-built)."""

    n_blocks: int
    block_samples: int
    n_tiles: int
    # per-channel tables
    ca2: np.ndarray         # [C, 1023] int8  chips +-1
    bits: np.ndarray        # [C, 1800] int8  nav bits +-1
    # per-(block, channel)
    active: np.ndarray      # [M, C] bool
    u: np.ndarray           # [M, C] f64   carrier cycles/sample
    v: np.ndarray           # [M, C] f64   code chips/sample
    c0: np.ndarray          # [M, C] f64   carrier phase at block start
    cp0: np.ndarray         # [M, C] f64   code phase (chips) at block start
    b0: np.ndarray          # [M, C] int32 word*30+bit index
    ic0: np.ndarray         # [M, C] int32 code-period counter
    gain: np.ndarray        # [M, C] f64 signal gain (for in-kernel LUTs)
    qcos_pm: np.ndarray     # [M, C, 1024] int32  +-trunc(cos*gain)
    qsin_pm: np.ndarray     # [M, C, 1024] int32
    # tiled-path NCO levels (per channel) and per-tile f64-exact anchors
    v_q12: np.ndarray       # [M, C] int32  floor(v*4096)         Q12/sample
    r24: np.ndarray         # [M, C] int32  Q24 code step/sample
    r36: np.ndarray         # [M, C] int32  Q36 code step/sample
    rrr: np.ndarray         # [M, C] f32    Q36 fourth-level residual/sample
    step_u32: np.ndarray    # [M, C] int32  carrier u32 step/sample
    sr12: np.ndarray        # [M, C] int32  floor(step residual * 4096)
    srem: np.ndarray        # [M, C] f32    its [0,1) remainder
    code_q12: np.ndarray    # [M, C, nt] int32  floor(P*4096) at tile start
    code_q24: np.ndarray    # [M, C, nt] int32  Q24 fraction at tile start
    code_q36: np.ndarray    # [M, C, nt] int32  Q36 fraction at tile start
    carr_u32: np.ndarray    # [M, C, nt] int32  floor u32 phase at tile start
    carr_q12: np.ndarray    # [M, C, nt] int32  its sub-unit Q12 digit


def pack_plan(plan, tile: int = TILE, tables: bool = True) -> DevicePlan:
    """Convert a runtime.scheduler.SuperframePlan into device arrays.

    tables=False skips the tiled/precise-path LUTs and per-tile anchors
    (~15 MB of f64 work per 300-block superframe); the fused path
    scales the LUT on device and never reads them."""
    M, C = plan.n_blocks, MAX_CHAN
    N = plan.block_samples
    act = plan.active

    u = np.where(act, plan.f_carr * plan.delt, 0.0)
    v = np.where(act, plan.f_code * plan.delt, 0.0)
    c0 = np.where(act, plan.carr_phase, 0.0)
    cp0 = np.where(act, plan.code_phase, 0.0)
    b0 = np.where(act, plan.iword * 30 + plan.ibit, 0).astype(np.int32)
    ic0 = np.where(act, plan.icode, 0).astype(np.int32)
    gain = np.where(act, plan.gain, 0.0)

    nt = -(-N // tile)
    if tables:
        # +-truncated gain LUTs, f64 exact (C's (int)(table*gain))
        qcos = np.trunc(COS_TABLE_512[None, None, :] * gain[..., None])
        qsin = np.trunc(SIN_TABLE_512[None, None, :] * gain[..., None])
        qcos_pm = np.concatenate([qcos, -qcos], axis=-1).astype(np.int32)
        qsin_pm = np.concatenate([qsin, -qsin], axis=-1).astype(np.int32)

        # per-tile anchors (f64 on host; in-tile device math f32/int32)
        tj = (np.arange(nt, dtype=np.float64) * tile)[None, None, :]
        P_t = cp0[..., None] + v[..., None] * tj
        pq = P_t * 4096.0
        code_q12 = np.floor(pq)
        f12 = (pq - code_q12) * 4096.0
        code_q24 = np.floor(f12)
        code_q36 = np.floor((f12 - code_q24) * 4096.0).astype(np.int32)
        code_q24 = code_q24.astype(np.int32)
        code_q12 = code_q12.astype(np.int32)
        # FLOOR anchors + the sub-unit Q12 digit seeding the residual
        # cascade: a round()ed anchor is off by up to 0.5 u32 units, which
        # flips the 9-bit LUT index whenever the true phase sits within
        # that offset of a boundary (~124 components per 990-block run);
        # floor + seed makes the integer phase an exact floor of the f64
        # phase down to the f32 trunc level (2^-12 units, the precise
        # path's own f64 rounding class — window 2^-34, ~0.03/990 blocks)
        carr_t = c0[..., None] + u[..., None] * tj
        carr_f = (carr_t - np.floor(carr_t)) * 2.0**32   # exact: 2^32 scale
        carr_anchor = np.floor(carr_f)
        carr_q12 = np.floor((carr_f - carr_anchor) * 4096.0).astype(np.int32)
        carr_u32 = (carr_anchor.astype(np.int64) & 0xFFFFFFFF)
        carr_u32 = carr_u32.astype(np.uint32).view(np.int32)
    else:
        z = np.zeros((M, C, 0), np.int32)
        qcos_pm = qsin_pm = z
        code_q12 = code_q24 = code_q36 = carr_u32 = carr_q12 = z

    v_q12 = np.floor(v * 4096.0).astype(np.int32)
    r4 = v * 4096.0 - v_q12                    # Q12 residual per sample
    r24 = np.floor(r4 * 4096.0)
    r4b = r4 * 4096.0 - r24                    # Q24 fraction in [0, 1)
    r36 = np.floor(r4b * 4096.0)
    rrr = ((r4b - r36 / 4096.0) * 4096.0).astype(np.float32)
    r24 = r24.astype(np.int32)
    r36 = r36.astype(np.int32)

    step_exact = (u - np.floor(u)) * 2.0**32
    step = np.round(step_exact).astype(np.int64)
    step_u32 = (step & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    # two-level carrier step residual (ops.params._F_SR12 rationale):
    # a single f32 trunc level (error +-1 u32 unit) lets Doppler-resonant
    # blocks collect adjacent-LUT picks; the Q12 level puts the ramp
    # error at 2^-12 units — the f64 closed form's own rounding class
    sres = (step_exact - step) * 4096.0
    sr12 = np.floor(sres).astype(np.int32)
    srem = (sres - sr12).astype(np.float32)

    # Q12 int32 overflow guard: chips*4096 must stay below 2^31 (a 0.1 s
    # block is always ~102.3k chips, so this holds at any fs)
    assert float((cp0 + np.abs(v) * N).max(initial=0.0)) * 4096 < 2**31, \
        "block spans too many chips for the Q12 code NCO"

    return DevicePlan(
        n_blocks=M, block_samples=N, n_tiles=nt,
        ca2=plan.ca2, bits=plan.bits, active=act,
        u=u, v=v, c0=c0, cp0=cp0, b0=b0, ic0=ic0, gain=gain,
        qcos_pm=qcos_pm, qsin_pm=qsin_pm,
        v_q12=v_q12, r24=r24, r36=r36, rrr=rrr,
        step_u32=step_u32, sr12=sr12, srem=srem,
        code_q12=code_q12, code_q24=code_q24, code_q36=code_q36,
        carr_u32=carr_u32, carr_q12=carr_q12,
    )


def split_plan(dp: DevicePlan, max_samples: int) -> DevicePlan:
    """Split every block of a (tables=False) DevicePlan into K equal
    sub-blocks of <= max_samples samples, with re-anchored closed-form
    parameters — this is what lifts the fused path's Q24 range cap
    (params.MAX_BLOCK_SAMPLES, fs <= 5.24 MHz at 0.1 s blocks) to ANY
    sample rate: the reference accepts any -s >= 1 MHz
    (plutogpssim.c:2326-2329), and sub-blocks are just shorter rows of
    the block axis.

    Sub-block k of block m starts at sample offset k*sub and carries:
      carrier   c0' = c0 + u*(k*sub)          (f64; frac'd at pack time)
      code      total chips t = cp0 + v*(k*sub), re-based into a code
                period: cp0' = t - 1023*w, ic0' = ic0 + w (w = whole
                periods since block start) so the Q12 plane stays far
                inside int32 at any fs and the nav-bit index
                q = (ic0' + w')//20 reconstructs the absolute period
                count exactly
    The last sub-block extrapolates past the true block end (K*sub >=
    N); consumers trim the reassembled [M, K*sub] row to N samples
    (IqStream does).  Re-anchoring rounds once in f64 (~1e-10 chips),
    the same class as the closed form's own floor — the split-precise
    vs unsplit-precise residual is a rare chip-edge straddle, orders
    below the reference A/B gates.  Plans already inside the cap pass
    through unchanged."""
    N = dp.block_samples
    if N <= max_samples:
        return dp
    K = -(-N // max_samples)
    sub = -(-N // K)
    M, C = dp.active.shape
    offs = np.arange(K, dtype=np.float64) * sub            # [K] exact ints

    # Re-anchor with a Dekker-split two-term product: a plain
    # c0 + u*(k*sub) rounds once at magnitude ~|u|*K*sub (~500 carrier
    # cycles at fs=10 MHz), i.e. ~2.4e-4 u32 units — enough for ~24
    # adjacent-LUT straddles per 96M samples on the compiled gate.
    # Splitting u = u_hi + u_lo (26-bit u_hi) makes u_hi*T exact
    # (26+20 < 53 bits), its frac extraction exact, and the remaining
    # sum |c0 + frac| <= 2 rounds at ~4e-6 units — the same class as
    # the unsplit path's own f64 floor.  Same trick for the code
    # anchor, with the exact multiple of 1023 peeled off u_hi*T by an
    # exact fmod so the rebase error sits at ~1e-12 chips (below the
    # kernel's 1.5e-11 Q36 truncation).
    def dekker_hi(x):
        c = x * (2.0 ** 27 + 1.0)
        hi = c - (c - x)
        return hi

    u = dp.u[:, None, :]
    u_hi = dekker_hi(u)
    p1 = u_hi * offs[None, :, None]                        # exact
    c0 = dp.c0[:, None, :] + (p1 - np.floor(p1)) \
        + (u - u_hi) * offs[None, :, None]

    v = dp.v[:, None, :]
    v_hi = dekker_hi(v)
    q1 = v_hi * offs[None, :, None]                        # exact
    m1 = np.fmod(q1, float(CA_SEQ_LEN))                    # exact
    w1 = (q1 - m1) / CA_SEQ_LEN                            # exact integer
    rest = dp.cp0[:, None, :] + m1 + (v - v_hi) * offs[None, :, None]
    w2 = np.floor(rest / CA_SEQ_LEN)
    cp0 = rest - CA_SEQ_LEN * w2                           # [M, K, C]
    ic0 = dp.ic0[:, None, :] + (w1 + w2).astype(np.int32)

    def rep(a):
        """[M, C, ...] -> [M*K, C, ...] with each row repeated K times."""
        return np.repeat(a, K, axis=0)

    # per-sub-block gain LUTs repeat (gain is per block); the tiled
    # path's per-tile anchors would need recomputation and the tiled
    # path has no range cap to lift, so they come back empty — split
    # plans feed the fused and precise paths only
    z = np.zeros((M * K, C, 0), np.int32)
    return DevicePlan(
        n_blocks=M * K, block_samples=sub, n_tiles=-(-sub // TILE),
        ca2=dp.ca2, bits=dp.bits,
        active=rep(dp.active), u=rep(dp.u), v=rep(dp.v),
        c0=c0.reshape(M * K, C), cp0=cp0.reshape(M * K, C),
        b0=rep(dp.b0), ic0=ic0.reshape(M * K, C).astype(np.int32),
        gain=rep(dp.gain),
        qcos_pm=rep(dp.qcos_pm) if dp.qcos_pm.size else z,
        qsin_pm=rep(dp.qsin_pm) if dp.qsin_pm.size else z,
        v_q12=rep(dp.v_q12), r24=rep(dp.r24), r36=rep(dp.r36),
        rrr=rep(dp.rrr), step_u32=rep(dp.step_u32), sr12=rep(dp.sr12),
        srem=rep(dp.srem),
        code_q12=z, code_q24=z, code_q36=z, carr_u32=z, carr_q12=z,
    )


def _mix_gather(s: jnp.ndarray, itab: jnp.ndarray, qcos_pm: jnp.ndarray,
                qsin_pm: jnp.ndarray):
    """Fold the +-1 spreading sign into the LUT index and gather I/Q."""
    idx = itab + jnp.where(s < 0, 512, 0)
    ival = jnp.take(qcos_pm, idx, axis=0)
    qval = jnp.take(qsin_pm, idx, axis=0)
    return ival, qval


# ---------------------------------------------------------------------------
# precise (f64) path — CPU golden reference
# ---------------------------------------------------------------------------

def _synth_block_precise(args, n, ca2, bits):
    """One block, all channels, f64 ramps.  n: [N] f64 sample index."""
    u, v, c0, cp0, b0, ic0, qcos_pm, qsin_pm = args

    def chan(u_c, v_c, c0_c, cp0_c, b0_c, ic0_c, qc, qs, ca2_c, bits_c):
        ph = c0_c + u_c * n
        ph = ph - jnp.floor(ph)
        itab = (ph * 512.0).astype(jnp.int32)

        P = cp0_c + v_c * n
        chip = jnp.floor(P).astype(jnp.int32)
        w = chip // CA_SEQ_LEN
        cidx = chip - w * CA_SEQ_LEN
        bidx = b0_c + (ic0_c + w) // 20
        s = (ca2_c[cidx] * bits_c[bidx]).astype(jnp.int32)
        return _mix_gather(s, itab, qc, qs)

    ivals, qvals = jax.vmap(chan)(u, v, c0, cp0, b0, ic0, qcos_pm, qsin_pm,
                                  ca2, bits)
    i_acc = jnp.sum(ivals, axis=0)
    q_acc = jnp.sum(qvals, axis=0)
    return jnp.stack([i_acc, q_acc], axis=-1).astype(jnp.int16)


def synth_superframe_precise(dp: DevicePlan) -> np.ndarray:
    """f64 golden synthesis -> int16 [M, N, 2].  Run on CPU only."""
    n = jnp.arange(dp.block_samples, dtype=jnp.float64)
    ca2 = jnp.asarray(dp.ca2, jnp.int32)
    bits = jnp.asarray(dp.bits, jnp.int32)

    def one(args):
        return _synth_block_precise(args, n, ca2, bits)

    args = (jnp.asarray(dp.u), jnp.asarray(dp.v), jnp.asarray(dp.c0),
            jnp.asarray(dp.cp0), jnp.asarray(dp.b0), jnp.asarray(dp.ic0),
            jnp.asarray(dp.qcos_pm), jnp.asarray(dp.qsin_pm))
    out = jax.lax.map(one, args)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# tiled (f32/int32) path — the on-device XLA reference
# ---------------------------------------------------------------------------

@functools.cache
def make_synth_tiled(n_blocks: int, block_samples: int, n_tiles: int,
                     tile: int = TILE):
    """Build a jitted superframe synthesizer for fixed shapes (one per
    shape for the process's lifetime, so a stream compiles once).

    Returns fn(ca2, bits, v_q12, r24, r36, rrr, step_u32, sr12, srem,
               b0, ic0, code_q12, code_q24, code_q36, carr_u32,
               carr_q12, qcos_pm, qsin_pm) -> int16 [M, N, 2].

    NCOs are the fused path's multi-level scheme (ops.synth_fused) on
    per-tile f64-exact anchors, so in-tile n <= tile keeps every level
    far inside its range: carrier = floor u32 anchor + two-level (Q12 +
    f32) step residual seeded with the anchor's sub-unit Q12 digit (the
    integer phase is then an exact floor of the f64 phase down to the
    f32 trunc level, 2^-12 u32 units — the f64 closed form's own
    rounding class), code = Q12 + Q24 + Q36 integer ramps + f32 fourth
    level (truncation 2^-36 chips = 1.5e-11, the f64 closed form's own
    rounding floor; chip-boundary jitter vanishes).
    """
    jf = jnp.arange(tile, dtype=jnp.float32)
    ji = jnp.arange(tile, dtype=jnp.int32)
    shr = jax.lax.shift_right_logical

    def chan_tile(vq, r24, r36, rrr, su32, sr12, srem, b0, ic0, cq12,
                  cq24, cq36, cu32, cuq12, ca2_c, bits_c, qc, qs):
        # carrier: floor u32 NCO (int32 wraparound) + Q12-seeded
        # two-level residual (arithmetic >> 12 keeps floor semantics
        # for negative sr12); logical shift leaves exactly 9 index
        # bits (c:2697 semantics)
        ph = cu32 + su32 * ji + \
            ((sr12 * ji + cuq12 + (srem * jf).astype(jnp.int32)) >> 12)
        itab = shr(ph, jnp.int32(23))

        # code: Q12 + Q24 + Q36 integer ramps + f32 fourth-level residual
        rq36 = cq36 + r36 * ji + (rrr * jf).astype(jnp.int32)
        rq24 = cq24 + r24 * ji + shr(rq36, jnp.int32(12))
        tq = cq12 + vq * ji + shr(rq24, jnp.int32(12))
        chip = shr(tq, jnp.int32(12))
        w = chip // CA_SEQ_LEN
        cidx = chip - w * CA_SEQ_LEN
        bidx = b0 + (ic0 + w) // 20
        s = (ca2_c[cidx] * bits_c[bidx]).astype(jnp.int32)
        return _mix_gather(s, itab, qc, qs)

    # vmap over tiles, then channels
    tiles_chan = jax.vmap(chan_tile,
                          in_axes=(None, None, None, None, None, None,
                                   None, None, None, 0, 0, 0, 0, 0,
                                   None, None, None, None))

    def block(vq, r24, r36, rrr, su32, sr12, srem, b0, ic0, cq12, cq24,
              cq36, cu32, cuq12, ca2, bits, qc, qs):
        def chan(vq_c, r24_c, r36_c, rrr_c, su_c, s12_c, srm_c, b0_c,
                 ic0_c, cq12_c, cq24_c, cq36_c, cu_c, cuq_c, ca2_c,
                 bits_c, qc_c, qs_c):
            return tiles_chan(vq_c, r24_c, r36_c, rrr_c, su_c, s12_c,
                              srm_c, b0_c, ic0_c, cq12_c, cq24_c, cq36_c,
                              cu_c, cuq_c, ca2_c, bits_c, qc_c, qs_c)
        ivals, qvals = jax.vmap(chan)(vq, r24, r36, rrr, su32, sr12,
                                      srem, b0, ic0, cq12, cq24, cq36,
                                      cu32, cuq12, ca2, bits, qc, qs)
        # [C, nt, tile] -> sum channels -> [nt*tile] -> [N]
        i_acc = jnp.sum(ivals, axis=0).reshape(-1)[:block_samples]
        q_acc = jnp.sum(qvals, axis=0).reshape(-1)[:block_samples]
        return jnp.stack([i_acc, q_acc], axis=-1).astype(jnp.int16)

    def superframe(ca2, bits, v_q12, r24, r36, rrr, step_u32, sr12,
                   srem, b0, ic0, code_q12, code_q24, code_q36,
                   carr_u32, carr_q12, qcos_pm, qsin_pm):
        def one(args):
            (vq, r24_, r36_, rrr_, su, s12, srm, b0_, ic0_, c12, c24,
             c36, cu, cuq, qc, qs) = args
            return block(vq, r24_, r36_, rrr_, su, s12, srm, b0_, ic0_,
                         c12, c24, c36, cu, cuq, ca2, bits, qc, qs)
        return jax.lax.map(one, (v_q12, r24, r36, rrr, step_u32, sr12,
                                 srem, b0, ic0, code_q12, code_q24,
                                 code_q36, carr_u32, carr_q12, qcos_pm,
                                 qsin_pm))

    return jax.jit(superframe)


def synth_superframe_tiled(dp: DevicePlan, device=None) -> np.ndarray:
    """Tiled-path synthesis -> int16 [M, N, 2] (any backend)."""
    return np.asarray(synth_superframe_tiled_async(dp, device=device))


def synth_superframe_tiled_async(dp: DevicePlan, device=None):
    """Tiled-path synthesis, returned as an asynchronously-computing
    device array (jax dispatch is async; np.asarray blocks on it)."""
    fn = make_synth_tiled(dp.n_blocks, dp.block_samples, dp.n_tiles)
    args = [jnp.asarray(dp.ca2, jnp.int32), jnp.asarray(dp.bits, jnp.int32),
            jnp.asarray(dp.v_q12), jnp.asarray(dp.r24),
            jnp.asarray(dp.r36), jnp.asarray(dp.rrr),
            jnp.asarray(dp.step_u32), jnp.asarray(dp.sr12),
            jnp.asarray(dp.srem),
            jnp.asarray(dp.b0), jnp.asarray(dp.ic0),
            jnp.asarray(dp.code_q12), jnp.asarray(dp.code_q24),
            jnp.asarray(dp.code_q36), jnp.asarray(dp.carr_u32),
            jnp.asarray(dp.carr_q12),
            jnp.asarray(dp.qcos_pm), jnp.asarray(dp.qsin_pm)]
    if device is not None:
        args = [jax.device_put(a, device) for a in args]
    return fn(*args)
