"""Public wrappers of the port's kernels.

Each wrapper dispatches on the device of its tensors: a CUDA tensor launches
the hand-written Hopper kernel (or raises), a CPU tensor runs the kernel's
plain PyTorch version from :mod:`repro_torch.kernels.ref`.  Each wrapper
counts its kernel launches in a ``launches`` attribute.

Ported so far: ``fed3r_stats``.  The reference's other kernels (rff,
chol_gram, batched_chol_gram, quantize_tiles, dequant_accumulate,
flash_attention) are later slices of the port (ROADMAP Queue 2).
"""
from repro_torch.kernels.fed3r_stats import fed3r_stats  # noqa: F401
