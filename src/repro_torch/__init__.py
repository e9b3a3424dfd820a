"""FusionStitching in PyTorch for NVIDIA Hopper: the port of ``repro``.

Imports ``torch`` only (Triton inside the functions that launch kernels);
the JAX package ``repro`` is the reference it is tested against.
"""
