"""PyTorch/CUDA port of protein_clip_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's module layout. Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel under
``csrc/``, bound in ``kernels/build.py`` and wrapped in ``ops/`` beside its
plain PyTorch version. Imports torch, numpy and the standard library only.
"""
