"""pygcn_tpu_torch — the PyTorch/CUDA port of ``pygcn_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``pygcn_tpu``; host-side NumPy code it needs is
carried over as its own copy. This first slice covers full-graph GCN
training on the hybrid BCSR+ELL layout:

- ``pygcn_tpu_torch.graph``    — graph containers (COO, dense, BCSR), the
  normalizations and the synthetic dataset builders.
- ``pygcn_tpu_torch.ops``      — the sparse engine: ``spmm``/``spmm_t``/``sddmm``
  over dense, segment, ELL, hybrid and BCSR layouts; kernel B1 (BCSR SpMM)
  written in CUDA C++ for ``sm_90a`` under ``ops/cuda`` and ``csrc``.
- ``pygcn_tpu_torch.nn``       — ``GraphConv`` and the reference's init bounds.
- ``pygcn_tpu_torch.train``    — torch Adam with L2 decay and clipping.
- ``pygcn_tpu_torch.parallel`` — host-side locality ordering.
- ``pygcn_tpu_torch.apps``     — the ``train_fullgraph`` CLI.
"""

__version__ = "0.1.0"
