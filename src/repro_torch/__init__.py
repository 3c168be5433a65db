"""PyTorch / CUDA port of the ``repro`` package, grown slice by slice.

Sub-packages mirror the JAX package's names (``models``, ``configs``,
``kernels``, ``serve``) so each file's counterpart is easy to find.  The port
imports ``torch``, numpy and the standard library only: never ``jax`` and
nothing of ``repro``.  CUDA sources live under ``csrc/`` and are built at
first use (``kernels/build.py``); importing any module needs neither ``nvcc``
nor ``triton``.
"""
