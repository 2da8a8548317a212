"""Fused composite GPS L1 C/A IQ synthesis: the production path.

One jitted function replaces the reference's entire per-sample hot loop
(plutogpssim.c:2690-2756).  Per (block, sample) it evaluates, for all 12
channel slots, closed-form NCOs and mixes into packed int16 IQ.  The
per-sample chain (_chan_terms) runs two ways, bit-identically: as the
Pallas kernel through Triton on a GPU (ops.synth_triton; kernel_for
picks it from the device's platform) and as plain XLA elsewhere, which
is also the reference the kernel is held to.  Then the rows that carry
gain-trunc patch words get their corrections (patch_packed).

  carrier   floor uint32 NCO + Q12-seeded step-quantization residual:
            phase = floor_u32(phase0) + step_u32*n
                  + ((sr12*n + cq12 + trunc(srem*n)) >> 12)
            (sr12 = floor(stepres*4096), srem its remainder, cq12 the
            floored anchor's sub-unit Q12 digit); LUT index =
            phase >> 23 replicates floor(carr_phase*512) (c:2697) as an
            exact floor of the f64 phase down to the f32 trunc level
            (2^-12 u32 units, the f64 closed form's own rounding class).
            History: one f32 level (error +-1 unit) let Doppler-resonant
            blocks collect ~2k adjacent-LUT picks; a round()ed anchor
            without the cq12 seed sat up to 0.5 units off and flipped
            ~124 boundary-straddling samples per 990 blocks
  code      four-level integer NCO:
            chips*4096 = cp0_q12 + v_q12*n + ((res0_q24 + r24*n
                       + ((res0_q36 + r36*n + trunc(rrr*n)) >> 12)) >> 12)
            Q12 + Q24 + Q36 exact integer ramps + f32 fourth-level
            residual; truncation sits at 2^-36 chips = 1.5e-11, the
            f64 closed form's own rounding floor (Q24-level truncation
            at 6e-8 chips still flipped a chip-edge sample ~0.03x per
            block — a full-amplitude error worth ~30 dB on that block)
  nav bits  folded into a per-(block,channel) 32-bit mask indexed by
            q = (icode0 + code_periods)//20 (c:2732)
  C/A chips bit-packed, 32 words per channel; one word gather + variable
            shift (c:2737)
  mixing    one gather per channel per sample from the 512-entry packed
            (cos, sin) pair table; gain scaling is per sample,
            iv = trunc(f32(T)*f32(gain)).  Gain can exceed 1.0
            (path_loss = 20200000/d tops 1.0 whenever the geometric
            range is under 20,200 km, routine near zenith), up to 2
            (asserted at pack time), so |iv| <= 1024 and the 12-channel
            sum fits int16.  The spreading sign (chip XOR nav bit)
            negates the truncated product — C's
            `(int)(dataBit*codeCA*table*gain)` reproduced exactly as
            sign * trunc(table*gain) (c:2701-2702)
  output    packs (I & 0xffff) | (Q << 16) int32 — memory-identical to
            the reference's interleaved little-endian int16 stream
            (c:2754)

Zero-gain channel slots contribute exactly 0, so rise/set never changes
shapes.  Multiple 30 s superframes batch into one call: each block reads
its C/A tables through the block->superframe map.

Precision: there is no matrix product (no TF32), and no f32 addition
follows an f32 multiply before its conversion to int (srem*n, rrr*n,
chip*(1/1023), T*gain), so FMA contraction cannot change a result; the
u32 carrier ramp relies on int32 two's-complement wraparound, which XLA
defines.  The output is bit-identical on every backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CA_SEQ_LEN, MAX_CHAN
from . import params as pp
from .params import (_F_CQ12, _F_GAIN, _F_RRR, _F_SR12, _F_SREM, _N_PATCH,
                     _P_CP0Q, _P_IC0, _P_NBM, _P_PHASE0, _P_R24, _P_R36,
                     _P_RES0Q24, _P_RES0Q36, _P_STEP, _P_VQ, _SLOT_F,
                     _SLOT_F_W, _SLOT_I, _SLOT_I_W, _SLOT_WORD, PLANE_HALF)

__all__ = ["synth_blocks", "main_pass", "patch_packed", "patch_args",
           "pack_iq", "unpack_packed", "kernel_for", "compile_synth"]

_C = MAX_CHAN
_WORDS = 32                     # bit-packed C/A words per channel table

# 1/1023 rounded UP in f32: trunc(chip * _INV1023) == chip // 1023 exactly
# for 0 <= chip < 600_000 (verified exhaustively; max chip under
# MAX_BLOCK_SAMPLES is ~537k)
_INV1023 = np.float32(np.nextafter(np.float32(1.0 / 1023.0),
                                   np.float32(np.inf)))

# the Q36 residual ramp res0 + r*n + trunc(rrr*n) (each term <= 4095,
# 4095*n, n-1) stays inside int32 only for n <= (2^31-1-4095)/4096
_MAX_RAMP_SAMPLES = 524_288

# smallest patch-row bucket: a dispatch with 1..8 patched rows compiles
# one variant
_MIN_PATCH_ROWS = 8

# rows per step of the XLA main pass's block loop: XLA's GPU fusion keeps
# the per-channel LUT gathers in device memory (7.5 GB of temporaries for
# a whole K=8 group at fs=2.6 MHz, 3x its output); 48-row steps hold them
# near 150 MB at the same speed (H100 80GB HBM3, 700 W)
_REF_CHUNK = 48

_shr = jax.lax.shift_right_logical


def _chan_terms(n, nf, geti, getf, ca_word, lut_pair):
    """Per-sample chain for one channel over sample indices n.

    geti/getf map a parameter column base to that channel's value
    (broadcastable against n); ca_word(i) gathers the channel's i-th
    bit-packed C/A word and lut_pair(i) the packed (cos, sin) pair of
    LUT entry i.  Returns (tc, ts, neg): the signed LUT pair and the 0/1
    spreading sign (chip XOR nav bit)."""
    # carrier NCO: floor u32 anchor + two-level step residual seeded with
    # the anchor's sub-unit Q12 digit (arithmetic >> 12 keeps floor
    # semantics for negative sr12)
    sr12 = getf(_F_SR12).astype(jnp.int32)
    cq12 = getf(_F_CQ12).astype(jnp.int32)
    resc = (sr12 * n + cq12 + (getf(_F_SREM) * nf).astype(jnp.int32)) >> 12
    phase = geti(_P_PHASE0) + geti(_P_STEP) * n + resc
    # logical shift of the u32 phase leaves exactly 9 index bits
    itab = _shr(phase, jnp.int32(23))

    # code NCO: Q12 + Q24 + Q36 integer ramps + f32 fourth-level residual
    rq36 = geti(_P_RES0Q36) + geti(_P_R36) * n \
        + (getf(_F_RRR) * nf).astype(jnp.int32)
    rq24 = geti(_P_RES0Q24) + geti(_P_R24) * n + _shr(rq36, jnp.int32(12))
    tq = geti(_P_CP0Q) + geti(_P_VQ) * n + _shr(rq24, jnp.int32(12))
    chip = _shr(tq, jnp.int32(12))
    # chip // 1023 via the exact f32 reciprocal (chip < 600k)
    w = (chip.astype(jnp.float32) * _INV1023).astype(jnp.int32)
    cidx = chip - w * jnp.int32(CA_SEQ_LEN)

    # nav bit from the per-block mask; // 20 via magic multiply (exact
    # for u < 4096; q < 32 under the block-length cap, asserted at pack
    # time)
    q = _shr((geti(_P_IC0) + w) * jnp.int32(3277), jnp.int32(16))
    nbit = _shr(geti(_P_NBM), q) & jnp.int32(1)

    word = ca_word(_shr(cidx, jnp.int32(5)))
    cbit = _shr(word, cidx & jnp.int32(31)) & jnp.int32(1)

    pair = lut_pair(itab)
    tc = (pair & jnp.int32(0xFFFF)) - jnp.int32(512)
    ts = _shr(pair, jnp.int32(16)) - jnp.int32(512)
    return tc, ts, cbit ^ nbit


def _gathers(ca_tables, ca_base):
    """(ca_word, lut_pair) gathers for _chan_terms over device arrays."""
    ca_flat = ca_tables.reshape(-1)
    pair = jnp.asarray(pp.PAIR_TABLE)
    return (lambda i: jnp.take(ca_flat, ca_base + i, mode="clip"),
            lambda i: jnp.take(pair, i, mode="clip"))


def _ramps(n_samples: int):
    n = jax.lax.broadcasted_iota(jnp.int32, (1, n_samples), 1)
    return n, n.astype(jnp.float32)


def _main_pass(prmi, prmf, ca_tables, sf_map, n_samples: int):
    """Composite I and Q sums, int32 [M, n_samples] each.

    prmi/prmf: the per-channel half of the parameter planes ([M, >=128]);
    ca_tables: [NS, C, 32] bit-packed C/A words; sf_map: [M] int32."""
    n, nf = _ramps(n_samples)
    sf_base = sf_map[:, None] * jnp.int32(_C * _WORDS)
    i_acc = q_acc = jnp.zeros((), jnp.int32)
    for c in range(_C):
        def geti(col, c=c):
            return prmi[:, col + c:col + c + 1]

        def getf(col, c=c):
            return prmf[:, col + c:col + c + 1]

        tc, ts, neg = _chan_terms(
            n, nf, geti, getf,
            *_gathers(ca_tables, sf_base + jnp.int32(c * _WORDS)))
        g = getf(_F_GAIN)
        iv = (tc.astype(jnp.float32) * g).astype(jnp.int32)
        qv = (ts.astype(jnp.float32) * g).astype(jnp.int32)
        neg = neg.astype(bool)
        i_acc = i_acc + jnp.where(neg, -iv, iv)
        q_acc = q_acc + jnp.where(neg, -qv, qv)
    return i_acc, q_acc


def main_pass(prmi, prmf, ca_tables, sf_map, n_samples: int,
              kernel: str = "xla"):
    """Packed composite IQ [M, n_samples] of the patch-free main pass.

    kernel="triton" runs the GPU kernel (ops.synth_triton); "xla" runs
    the plain jnp version, which walks the blocks _REF_CHUNK rows at a
    time so its per-channel temporaries stay small."""
    if kernel == "triton":
        from . import synth_triton
        return synth_triton.main_pass(prmi, prmf, ca_tables, sf_map,
                                      n_samples)
    m = prmi.shape[0]
    if m <= _REF_CHUNK:
        return pack_iq(*_main_pass(prmi, prmf, ca_tables, sf_map,
                                   n_samples))
    n_chunks = -(-m // _REF_CHUNK)
    pad = n_chunks * _REF_CHUNK - m

    def rows(a):
        # padded rows carry zero gain and synthesize silence
        a = jnp.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
        return a.reshape((n_chunks, _REF_CHUNK) + a.shape[1:])

    out = jax.lax.map(
        lambda a: pack_iq(*_main_pass(a[0], a[1], ca_tables, a[2],
                                      n_samples)),
        (rows(prmi), rows(prmf), rows(sf_map)))
    out = out.reshape(n_chunks * _REF_CHUNK, n_samples)
    return out[:m] if pad else out


def patch_terms(n_samples: int, slot_i, slot_f, sf_rows, ca_tables):
    """Gain-trunc patch corrections (dI, dQ), int32 [R, n_samples], for
    R rows: slot_i/slot_f [R, 128] are the patch half of those rows'
    parameter planes and sf_rows [R] their superframe indices.  Each
    word moves one LUT entry's truncated product by +-1 wherever the
    channel picks it, signed like the sample itself; an empty slot
    (word 0) contributes nothing."""
    n, nf = _ramps(n_samples)
    d_i = d_q = jnp.zeros((), jnp.int32)
    for k in range(_N_PATCH):
        wk = slot_f[:, _SLOT_F_W * k + _SLOT_WORD][:, None].astype(jnp.int32)
        c = _shr(wk, jnp.int32(2)) & jnp.int32(15)
        mag = _shr(wk, jnp.int32(6))
        half = _shr(wk, jnp.int32(1)) & jnp.int32(1)
        sgn = wk & jnp.int32(1)

        def geti(col, k=k):
            j = _SLOT_I_W * k + _SLOT_I[col]
            return slot_i[:, j:j + 1]

        def getf(col, k=k):
            j = _SLOT_F_W * k + _SLOT_F[col]
            return slot_f[:, j:j + 1]

        base = (sf_rows[:, None] * jnp.int32(_C) + c) * jnp.int32(_WORDS)
        tc, ts, neg = _chan_terms(n, nf, geti, getf,
                                  *_gathers(ca_tables, base))
        # +-1 exactly at the patched magnitude's two signed values (trunc
        # is odd, so the mirrored entry gets the mirrored correction);
        # mag = 0 makes both compares identical, so p = 0
        a = jnp.where(sgn == 0, mag, -mag)
        tgt = jnp.where(half == 0, tc, ts)
        p = (tgt == a).astype(jnp.int32) - (tgt == -a).astype(jnp.int32)
        term = jnp.where(neg.astype(bool), -p, p)
        d_i = d_i + jnp.where(half == 0, term, 0)
        d_q = d_q + jnp.where(half == 1, term, 0)
    return d_i, d_q


def patch_packed(packed, rows, slot_i, slot_f, sf_rows, ca_tables,
                 row_offset=0):
    """Apply patch_terms to the listed rows of a packed [M, S] array.

    rows are global block indices; row_offset is the global index of
    packed's first row, and rows outside [row_offset, row_offset + M)
    are left alone (so each time shard of a mesh patches its own
    rows).  Only the R listed rows are evaluated; duplicate rows must
    carry identical slot data."""
    m = packed.shape[0]
    local = rows - row_offset
    local = jnp.where((local >= 0) & (local < m), local, m)
    i_acc, q_acc = unpack_packed(packed[jnp.minimum(local, m - 1)])
    d_i, d_q = patch_terms(packed.shape[1], slot_i, slot_f, sf_rows,
                           ca_tables)
    return packed.at[local].set(pack_iq(i_acc + d_i, q_acc + d_q),
                                mode="drop")


def unpack_packed(packed):
    """Inverse of pack_iq on device: (I, Q) int32."""
    i_acc = ((packed & jnp.int32(0xFFFF)) ^ jnp.int32(0x8000)) \
        - jnp.int32(0x8000)
    return i_acc, packed >> 16


def pack_iq(i_acc, q_acc):
    """(I & 0xffff) | (Q << 16) per sample, int32."""
    return (i_acc & jnp.int32(0xFFFF)) | jax.lax.shift_left(
        q_acc, jnp.int32(16))


def patch_rows(prmf: np.ndarray) -> np.ndarray:
    """Indices of the blocks whose float plane carries any patch word."""
    if prmf.shape[1] <= PLANE_HALF:
        return np.zeros(0, np.int64)
    lanes = [pp.patch_word_lane(k) for k in range(_N_PATCH)]
    return np.flatnonzero(np.any(prmf[:, lanes] != 0.0, axis=1))


def patch_args(prmi: np.ndarray, prmf: np.ndarray, sf_map: np.ndarray,
               force: bool = False):
    """(rows, slot_i, slot_f, sf_rows) for patch_packed, or None when the
    dispatch carries no patch words and force is off (the pass then
    compiles out).  The row count is bucketed to a power of two >= 8 so
    dispatches with a few patched rows share one compiled variant;
    padding repeats the last patched row (identical data, so duplicate
    writes agree) or, with no words at all, block 0 with empty slots."""
    rows = patch_rows(prmf)
    if rows.size == 0 and not force:
        return None
    n_rows = max(_MIN_PATCH_ROWS, 1 << (int(rows.size) - 1).bit_length())
    slot_i = np.zeros((n_rows, PLANE_HALF), np.int32)
    slot_f = np.zeros((n_rows, PLANE_HALF), np.float32)
    if rows.size:
        rows = np.concatenate(
            [rows, np.full(n_rows - rows.size, rows[-1])])
        slot_i[:] = prmi[rows, PLANE_HALF:]
        slot_f[:] = prmf[rows, PLANE_HALF:]
    else:
        rows = np.zeros(n_rows, np.int64)
    return (rows.astype(np.int32), slot_i, slot_f,
            np.asarray(sf_map, np.int32)[rows])


def kernel_for(device) -> str:
    """The main-pass implementation for a device: the Triton kernel on
    a GPU, the plain XLA version elsewhere."""
    return "triton" if device.platform == "gpu" else "xla"


def _synth(prmi, prmf, ca_tables, sf_map, patches, *, n_samples: int,
           kernel: str):
    packed = main_pass(prmi, prmf, ca_tables, sf_map, n_samples, kernel)
    if patches is not None:
        packed = patch_packed(packed, *patches, ca_tables)
    return packed


_synth_jit = jax.jit(_synth, static_argnames=("n_samples", "kernel"))


def synth_blocks(prm, ca2_tables: np.ndarray, sf_map: np.ndarray,
                 block_samples: int, device=None,
                 force_patches: bool = False, reference: bool = False):
    """Synthesize packed int32 IQ [M, block_samples] on `device`
    (default: runtime.device.synthesis_device()).

    prm: build_block_params output (BlockParams, or any sequence whose
    first two elements are the [M,256] int and float parameter planes);
    ca2_tables: [NS, C, 32] pack_ca_tables output; sf_map: [M] int32
    block->superframe map.  The main pass runs kernel_for(device);
    reference=True runs the plain XLA version instead (the comparison
    baseline for the kernel).  Patch-free dispatches compile the patch
    pass out; force_patches=True keeps it (on an empty dummy row) so a
    long-lived stream can latch ONE variant after its first patched
    group instead of flip-flopping shapes (runtime.stream.IqStream).
    Returns a device array; params.unpack_iq turns it into interleaved
    int16."""
    if device is None:
        from ..runtime.device import synthesis_device
        device = synthesis_device()
    prmi, prmf = np.asarray(prm[0]), np.asarray(prm[1])
    # sample indices run 0..block_samples-1 (see _MAX_RAMP_SAMPLES)
    assert 0 < block_samples <= _MAX_RAMP_SAMPLES, \
        f"block ({block_samples} samples) exceeds the Q24/Q36 ramp range"
    args = jax.device_put(
        (np.ascontiguousarray(prmi[:, :PLANE_HALF]),
         np.ascontiguousarray(prmf[:, :PLANE_HALF]),
         np.asarray(ca2_tables, np.int32), np.asarray(sf_map, np.int32),
         patch_args(prmi, prmf, sf_map, force_patches)), device)
    kernel = "xla" if reference else kernel_for(device)
    # all device dtypes are 32-bit; x64 (needed by the epoch path) must
    # be off during tracing or index arithmetic promotes to int64
    with jax.enable_x64(False):
        return _synth_jit(*args, n_samples=int(block_samples),
                          kernel=kernel)


def compile_synth(n_blocks: int, block_samples: int, n_sf: int, device,
                  reference: bool = False):
    """Ahead-of-time compile of a patch-free synth_blocks call at one
    shape (no data), for memory analysis and compile-time accounting."""
    sharding = jax.sharding.SingleDeviceSharding(device)

    def s(shape, dt):
        return jax.ShapeDtypeStruct(shape, dt, sharding=sharding)

    kernel = "xla" if reference else kernel_for(device)
    with jax.enable_x64(False):
        return _synth_jit.lower(
            s((n_blocks, PLANE_HALF), jnp.int32),
            s((n_blocks, PLANE_HALF), jnp.float32),
            s((n_sf, _C, _WORDS), jnp.int32), s((n_blocks,), jnp.int32),
            None, n_samples=int(block_samples), kernel=kernel).compile()
