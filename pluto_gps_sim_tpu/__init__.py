"""pluto_gps_sim_tpu — a GPS L1 C/A baseband signal synthesizer in JAX.

A from-scratch JAX framework with capability parity with the reference C
simulator (Mictronics/pluto-gps-sim): RINEX v2/v3 ingest,
broadcast-ephemeris orbit propagation, LNAV message synthesis, and
real-time-scale composite IQ generation — redesigned for an accelerator:

  * epoch solves (Kepler, Klobuchar, pseudorange/Doppler) are vectorized
    f64 host math over (epoch, satellite);
  * the per-sample hot loop becomes closed-form phase ramps evaluated by
    one fused synthesis over (block, sample) — a Pallas/Triton kernel on
    GPUs, plain XLA elsewhere;
  * time blocks shard across devices and hosts with analytic phase
    continuity (channels can shard too, with a psum composite).

The epoch/geodesy path needs float64; enable x64 before any tracing.
"""

from jax import config as _config

_config.update("jax_enable_x64", True)

__version__ = "0.1.0"
