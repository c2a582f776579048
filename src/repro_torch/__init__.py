"""PyTorch/CUDA port of the compression-aware memory-controller system.

A package beside the JAX reference ``repro``, with the same layout and
names.  It imports torch and NumPy and nothing of JAX or of ``repro``.
The serving main path — ``serving.ContinuousScheduler`` over the paged
backend with bit-plane device KV — runs on an NVIDIA GPU by default, with
its two paged-attention decode kernels written by hand in CUDA C++ for
Hopper (``csrc/paged_attention.cu``); ``device="cpu"`` runs the same path
on their plain PyTorch versions.
"""
