"""C-SAW graph sampling and random walk in PyTorch, with CUDA kernels for Hopper.

The port of ``repro`` (JAX/Pallas): same subpackage layout (``graph``,
``core``, ``kernels``, ``serve``, ``shard``) and function names, so each
piece has an obvious counterpart; ``serve`` is the request-serving and
streaming front door over the walk engines, and ``shard`` the walk over a
graph range-sharded across a ``ShardMesh`` of devices (``core.distributed``
splits instances over one instead).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor a kernel wrapper launches its hand-written
kernel, on a CPU tensor it runs the kernel's plain PyTorch version.

This package imports ``torch`` and ``numpy`` only — never ``jax``, never
``repro``.
"""
