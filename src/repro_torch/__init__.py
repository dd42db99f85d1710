"""PyTorch/CUDA port of the Azul sparse-solver reproduction.

The package mirrors ``src/repro/`` module for module (``core/engine.py``,
``kernels/ops.py``, ...) so each piece can be held against its JAX
counterpart.  It imports ``torch``, numpy and scipy only -- never ``jax``
and never the ``repro`` package.  Entry points default to
``device="cuda"``; ``device="cpu"`` runs the plain PyTorch versions of the
kernels (the path the CPU tests take).

Importing the package has no side effects: the CUDA kernels are compiled
and loaded on the first launch (``repro_torch.kernels.build``).
"""
