"""C-SAW graph sampling and random walk in PyTorch, with CUDA kernels for Hopper.

The port of ``repro`` (JAX/Pallas): same subpackage layout (``graph``,
``core``, ``kernels``) and function names, so each piece has an obvious
counterpart.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor a kernel wrapper launches its hand-written
kernel, on a CPU tensor it runs the kernel's plain PyTorch version.

This package imports ``torch`` and ``numpy`` only — never ``jax``, never
``repro``.
"""
