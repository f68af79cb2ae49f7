"""Hand-written Hopper kernels of the port, each beside its plain version.

  * fed3r_stats   — the fused statistics (A, b) = (ZᵀZ, ZᵀY)
                    (``csrc/fed3r_stats.cu``);
  * rff_transform — the fused random-features map √(2/D)·cos(ZΩ + β)
                    (``csrc/rff.cu``);
  * chol_gram     — the fused Cholesky-Gram update (L Lᵀ + ZᵀZ, ZᵀY)
                    (``csrc/chol_gram.cu``), and its batch over K heads,
                    batched_chol_gram (``csrc/batched_chol_gram.cu``);
  * quantize_tiles / dequant_accumulate — the compressed uplink's per-tile
                    absmax int8 quantization and its fused
                    dequantize-accumulate (``csrc/quant.cu``);
  * flash_attention — causal GQA attention with an online softmax and an
                    optional window (``csrc/flash_attention.cu``), launched
                    once a layer by a prefill of the dense backbone; decode
                    and the train / feature forward use the plain attention.

All are CUDA C++ for sm_90a, built by :mod:`repro_torch.kernels.build`
and bound with ctypes.  Call them through :mod:`repro_torch.kernels.ops`.
Nothing is compiled at import: a kernel is built at its first launch.
"""
