"""pygcn_tpu_torch — the PyTorch/CUDA port of ``pygcn_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and never ``jax`` or ``pygcn_tpu``; host-side NumPy code it needs is
carried over as its own copy. The slices ported so far cover full-graph GNN
training on the hybrid BCSR+ELL layout, the Cora CLI, the epidemic simulator,
the surrogate evaluator, the policy generators and the evaluator's server:

- ``pygcn_tpu_torch.graph``    — graph containers (COO, dense, BCSR), the
  normalizations and the synthetic dataset builders.
- ``pygcn_tpu_torch.ops``      — the sparse engine: ``spmm``/``spmm_t``/``sddmm``
  over dense, segment, ELL, hybrid and BCSR layouts, and GAT attention
  (``ops/gat.py``: COO, ELL and hybrid paths); kernels B1 (BCSR SpMM) and
  B3/B5/B6 (GAT tile attention) written in CUDA C++ for ``sm_90a`` under
  ``ops/cuda`` and ``csrc``.
- ``pygcn_tpu_torch.nn``       — ``GraphConv``, the dense stacks and pooling,
  ``GATConv``/``GAT``, SAGE, GIN, APPNP, the evaluator's models
  (``GCN3``, ``GCNOverMLP``), the policy generators, ``get_model`` and the
  reference's init bounds.
- ``pygcn_tpu_torch.train``    — torch Adam with L2 decay and clipping, the
  plateau scheduler, early stopping, metrics, checkpoints that any NumPy
  process reads, the preemption guard, grid sweeps and ``torch.export``
  serving artifacts.
- ``pygcn_tpu_torch.policy``   — the top-K generator's step against a frozen
  evaluator, REINFORCE (Gumbel-top-k sampling, the replay buffer, the greedy
  policy) and the simulation memo-cache.
- ``pygcn_tpu_torch.parallel`` — host-side locality ordering.
- ``pygcn_tpu_torch.sim``      — the metapopulation epidemic simulator (visit
  products, exact draws, paged visits, policy batches) and its policies.
- ``pygcn_tpu_torch.data``     — ground-truth CSVs, loaders, centralities and
  the evaluator's feature assembly, the census loaders (no pandas, no
  networkx).
- ``pygcn_tpu_torch.utils``    — graphkit bindings, CUDA-event timing, the
  CLIs' device rule, metrics logging, ``Config`` and the plot helpers.
- ``pygcn_tpu_torch.apps``     — the ``train_fullgraph`` CLI and its tools;
  the Cora CLI; the simulator's ``gt_gen``, ``no_vac_baseline`` and
  ``export_dynalearn``; the evaluator's ``train_evaluator``, ``baselines``,
  ``train_legacy`` and ``sweep``; the policy generators' ``train_generator``
  and ``train_rl``; the server ``predict``.
"""

__version__ = "0.1.0"
