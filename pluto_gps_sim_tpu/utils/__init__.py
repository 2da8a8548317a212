# Host-side utilities: native ring-writer bindings (utils.native), the
# software GPS receiver (utils.receiver/acquisition/lnav_decode).
#
# utils.hostjax (cpu_jit/cpu_device) was removed in round 5: the entire
# f64 control plane (models/geodesy, models/orbits, ops/epoch) is pure
# numpy now — host numpy both guarantees
# f64 exactness and drops the per-call jit dispatch the pipelined
# stream's host-bound critical path was paying.
