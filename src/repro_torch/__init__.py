"""DataStates-LLM on PyTorch and CUDA: the port of the ``repro`` package.

The layout mirrors ``repro`` module for module (``core``, ``storage``,
``kernels``, ``obs``, ``analysis``, ``optim``, ``configs``, ``models``), so
each part has an obvious counterpart to be held against. This package
imports ``torch`` and never ``jax`` or ``repro``.
"""
