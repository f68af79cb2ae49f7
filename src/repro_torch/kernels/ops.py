"""Public wrappers of the port's kernels.

Each wrapper dispatches on the device of its tensors: a CUDA tensor launches
the hand-written Hopper kernel (or raises), a CPU tensor runs the kernel's
plain PyTorch version from :mod:`repro_torch.kernels.ref`.  Each wrapper
counts its kernel launches in a ``launches`` attribute.

Ported so far: ``fed3r_stats``, ``rff_transform``, ``chol_gram``,
``batched_chol_gram``, ``quantize_tiles`` and ``dequant_accumulate``.  The
reference's ``flash_attention`` is a later slice of the port (ROADMAP
Queue 2 item 7).
"""
from repro_torch.kernels import chol_update as _chol_update
from repro_torch.kernels import fed3r_stats as _fed3r_stats
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import rff as _rff

batched_chol_gram = _chol_update.batched_chol_gram
chol_gram = _chol_update.chol_gram
dequant_accumulate = _quant.dequant_accumulate
fed3r_stats = _fed3r_stats.fed3r_stats
quantize_tiles = _quant.quantize_tiles
rff_transform = _rff.rff_transform

# every kernel library of the port, to build them all at once
# (repro_torch.kernels.build.build_all)
LIBRARIES = (_fed3r_stats.LIBRARY, _rff.LIBRARY, _chol_update.LIBRARY,
             _chol_update.BATCHED_LIBRARY, _quant.LIBRARY)
