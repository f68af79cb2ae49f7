"""Hand-written Hopper kernels of the port, each beside its plain version.

  * fed3r_stats — the fused statistics (A, b) = (ZᵀZ, ZᵀY), CUDA C++ for
                  sm_90a (``csrc/fed3r_stats.cu``), bound with ctypes.

Call them through :mod:`repro_torch.kernels.ops`.  Nothing is compiled at
import: a kernel is built at its first launch.
"""
