"""Sharded composite synthesis over a ("time", "chan") device mesh.

Maps the fused synthesis main pass (ops.synth_fused) over the mesh with
jax.shard_map:

  * blocks shard over "time" (no communication — phase parameters are
    closed-form per block);
  * channel slots shard over "chan" only when a mesh asks for it: each
    shard synthesizes its subset (others masked to zero gain) and the
    partial I/Q sums meet in a psum — the reference's cross-satellite
    accumulator (plutogpssim.c:2705-2706) turned into a collective.
    make_mesh puts every device on "time" by default, where the
    composite needs no communication at all.

Each shard runs the same main pass as a single device (the Triton kernel
on GPUs, the plain XLA version elsewhere); gain-trunc patch words are
applied after the composite, each time shard patching its own rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import MAX_CHAN
from ..ops import synth_fused as sf
from ..ops.params import _F_GAIN, PLANE_HALF

__all__ = ["synth_sharded"]


def pad_time_shards(prmi: np.ndarray, prmf: np.ndarray, sf_map: np.ndarray,
                    n_time: int):
    """Zero-pad the block axis to a multiple of the mesh's time shards.

    Padded blocks have zero gain everywhere, so they synthesize silence
    and are sliced off by the caller."""
    m = prmi.shape[0]
    pad = (-m) % n_time
    if pad:
        prmi = np.concatenate(
            [prmi, np.zeros((pad,) + prmi.shape[1:], prmi.dtype)])
        prmf = np.concatenate(
            [prmf, np.zeros((pad,) + prmf.shape[1:], prmf.dtype)])
        sf_map = np.concatenate([sf_map, np.zeros(pad, np.int32)])
    return prmi, prmf, sf_map


def shard_channel_params(prmf: np.ndarray, n_chan_shards: int) -> np.ndarray:
    """Replicate the per-channel float plane per channel shard, zeroing
    the gain of channels owned by other shards -> [n_shards, M, 128]."""
    out = np.repeat(prmf[None, :, :PLANE_HALF], n_chan_shards, axis=0)
    bounds = np.linspace(0, MAX_CHAN, n_chan_shards + 1).astype(int)
    for s in range(n_chan_shards):
        lo, hi = bounds[s], bounds[s + 1]
        for c in range(MAX_CHAN):
            if not (lo <= c < hi):
                out[s, :, _F_GAIN + c] = 0.0
    return out


@functools.lru_cache(maxsize=64)
def _sharded_fn(mesh: Mesh, block_samples: int, patched: bool):
    """Build-and-jit ONCE per (mesh, block size, patch variant):
    rebuilding the shard_map closure per call would retrace and lower
    it every time."""
    kernel = sf.kernel_for(mesh.devices.flat[0])
    n_chan = mesh.shape["chan"]

    def local(prmi_l, prmf_l, ca2, sf_l, patches):
        packed = sf.main_pass(prmi_l, prmf_l[0], ca2, sf_l, block_samples,
                              kernel)
        if n_chan > 1:
            i_acc, q_acc = sf.unpack_packed(packed)
            packed = sf.pack_iq(jax.lax.psum(i_acc, "chan"),
                                jax.lax.psum(q_acc, "chan"))
        if patched:
            offset = jax.lax.axis_index("time") * prmi_l.shape[0]
            packed = sf.patch_packed(packed, *patches, ca2,
                                     row_offset=offset)
        return packed

    return jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("time", None), P("chan", "time", None),
                  P(None, None, None), P("time"), P()),
        out_specs=P("time", None),
        check_vma=False,  # the Triton pallas_call carries no vma info
    ))


def synth_sharded(mesh: Mesh, prmi: np.ndarray, prmf: np.ndarray,
                  ca2_tables: np.ndarray, sf_map: np.ndarray,
                  block_samples: int):
    """Run the sharded synthesis over `mesh` -> packed int32 IQ
    [M, block_samples].

    prmi/prmf: the [M, 256] parameter planes (build_group_params);
    ca2_tables replicated; sf_map [M] int32.  Blocks pad up to a
    multiple of the time shards (silence, sliced off again)."""
    m = prmi.shape[0]
    prmi, prmf, sf_map = pad_time_shards(prmi, prmf, sf_map,
                                         mesh.shape["time"])
    patches = sf.patch_args(prmi, prmf, sf_map)
    fn = _sharded_fn(mesh, int(block_samples), patches is not None)
    with jax.enable_x64(False):
        out = fn(jnp.asarray(np.ascontiguousarray(prmi[:, :PLANE_HALF])),
                 jnp.asarray(shard_channel_params(prmf, mesh.shape["chan"])),
                 jnp.asarray(ca2_tables), jnp.asarray(sf_map, jnp.int32),
                 patches)
    return out[:m] if out.shape[0] != m else out
