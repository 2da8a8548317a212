from .mesh import factor_devices, make_mesh
from .montecarlo import MonteCarloBatch
from .shard import synth_sharded

__all__ = ["MonteCarloBatch", "factor_devices", "make_mesh", "synth_sharded"]
