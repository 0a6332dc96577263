"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package under ``src/repro/`` is the reference; this package keeps
its module names so each counterpart is easy to find.  It imports neither
``jax`` nor ``repro``.  Every ``SparseWeight`` product on a CUDA tensor runs
through the hand-written kernels in ``csrc/`` (``kernels/nm_spmm.py``,
``kernels/fused_sparse_linear.py``), as do ``kernels/ops``'s products on the
pipeline's output (``kernels/outlier_spmm.py`` for the outliers alone); on a
CPU tensor the plain PyTorch versions run instead, which is what the parity
tests use.  ``core/`` and ``eval/harness.py`` compress a model with the
paper's pipeline from its own calibration statistics.

Entry points default to ``device="cuda"`` and raise when CUDA is absent
unless the caller passes ``device="cpu"`` (``device.resolve``).
"""
