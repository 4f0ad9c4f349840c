"""pygcn_tpu_torch — the PyTorch/CUDA port of ``pygcn_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``pygcn_tpu``; host-side NumPy code it needs is
carried over as its own copy. The slices ported so far cover full-graph GCN
and GAT training on the hybrid BCSR+ELL layout:

- ``pygcn_tpu_torch.graph``    — graph containers (COO, dense, BCSR), the
  normalizations and the synthetic dataset builders.
- ``pygcn_tpu_torch.ops``      — the sparse engine: ``spmm``/``spmm_t``/``sddmm``
  over dense, segment, ELL, hybrid and BCSR layouts, and GAT attention
  (``ops/gat.py``: COO, ELL and hybrid paths); kernels B1 (BCSR SpMM) and
  B3/B5/B6 (GAT tile attention) written in CUDA C++ for ``sm_90a`` under
  ``ops/cuda`` and ``csrc``.
- ``pygcn_tpu_torch.nn``       — ``GraphConv``, ``GATConv``/``GAT`` and the
  reference's init bounds.
- ``pygcn_tpu_torch.train``    — torch Adam with L2 decay and clipping.
- ``pygcn_tpu_torch.parallel`` — host-side locality ordering.
- ``pygcn_tpu_torch.sim``      — the metapopulation epidemic simulator (visit
  products, exact draws, paged visits, policy batches) and its policies.
- ``pygcn_tpu_torch.data``     — feature helpers (``standardize``).
- ``pygcn_tpu_torch.apps``     — the ``train_fullgraph`` CLI (``--model gcn|gat``)
  and its profiler; the Cora CLI; the simulator's ``gt_gen``,
  ``no_vac_baseline`` and ``export_dynalearn``.
"""

__version__ = "0.1.0"
