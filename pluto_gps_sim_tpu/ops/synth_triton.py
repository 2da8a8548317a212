"""The synthesis main pass as a Pallas kernel through Triton (GPU).

The same per-sample body as ops.synth_fused (its _chan_terms), written
for one program per (block, 1024-sample tile): the block's parameters
are scalar loads, the 12-channel sum stays in registers, channels with
zero gain are skipped, and the C/A and LUT lookups are gathered loads.
XLA's version of the same body spills the LUT gathers to device memory
and computes every channel slot; at the production group shape this
kernel takes 13.6 ms where XLA takes 29.8 ms (K=8 superframes at
fs=2.6 MHz, 2400 x 260000 samples, ~7 active channels; 21.1 vs 29.8 ms
with all 12 active; H100 80GB HBM3, 700 W).  Gain-trunc patches are
applied afterwards by synth_fused.patch_packed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import MAX_CHAN
from . import params as pp
from . import synth_fused as sf
from .params import _F_GAIN

__all__ = ["main_pass", "TILE"]

_C = MAX_CHAN
TILE = 1024          # samples per program (a power of two for Triton)


def _kernel(prmi_ref, prmf_ref, ca_ref, sf_ref, pair_ref, out_ref, *,
            n_samples: int):
    m = pl.program_id(0)
    n = pl.program_id(1) * TILE + jnp.arange(TILE, dtype=jnp.int32)
    nf = n.astype(jnp.float32)
    sf_base = sf_ref[m] * jnp.int32(_C * 32)

    def channel(c, acc):
        def geti(col):
            return prmi_ref[m, col + c]

        def getf(col):
            return prmf_ref[m, col + c]

        base = sf_base + c * jnp.int32(32)

        def active(acc):
            tc, ts, neg = sf._chan_terms(
                n, nf, geti, getf,
                lambda i: plgpu.load(ca_ref.at[base + i]),
                lambda i: plgpu.load(pair_ref.at[i]))
            g = getf(_F_GAIN)
            iv = (tc.astype(jnp.float32) * g).astype(jnp.int32)
            qv = (ts.astype(jnp.float32) * g).astype(jnp.int32)
            neg = neg != 0
            return (acc[0] + jnp.where(neg, -iv, iv),
                    acc[1] + jnp.where(neg, -qv, qv))

        # zero-gain slots contribute exactly 0: skip their work
        return jax.lax.cond(getf(_F_GAIN) != 0.0, active, lambda a: a, acc)

    zero = jnp.zeros((TILE,), jnp.int32)
    i_acc, q_acc = jax.lax.fori_loop(0, _C, channel, (zero, zero))
    plgpu.store(out_ref.at[m, n], sf.pack_iq(i_acc, q_acc),
                mask=n < n_samples)


@functools.cache
def _call(n_blocks: int, n_samples: int, interpret: bool):
    return pl.pallas_call(
        functools.partial(_kernel, n_samples=n_samples),
        out_shape=jax.ShapeDtypeStruct((n_blocks, n_samples), jnp.int32),
        grid=(n_blocks, pl.cdiv(n_samples, TILE)),
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret, name="gps_synth_main")


def main_pass(prmi, prmf, ca_tables, sf_map, n_samples: int,
              interpret: bool = False):
    """Packed int32 IQ [M, n_samples] (traceable; same contract as
    synth_fused.main_pass).  interpret=True runs the kernel through the
    Pallas interpreter, for tests on hosts without a GPU."""
    return _call(prmi.shape[0], int(n_samples), interpret)(
        prmi, prmf, ca_tables.reshape(-1), sf_map,
        jnp.asarray(pp.PAIR_TABLE))
