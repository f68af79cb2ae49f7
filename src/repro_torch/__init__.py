"""Fed3R in PyTorch on an NVIDIA Hopper card: the port of the ``repro`` package.

Modules keep the reference package's paths and names (``repro_torch.core.
fed3r`` is the port of ``repro.core.fed3r``, and so on).  This package
imports torch, numpy and the standard library only — never jax and never the
reference package.  Entry points take ``device=`` and default to ``"cuda"``.
"""
