"""Graph-, data- and model-parallel training over ``torch.distributed``.

The port of ``pygcn_tpu/parallel``: the mesh, the launcher, the partition
plan with its halo exchange, the distributed SpMM and the distributed GCN,
SAGE, APPNP and GAT/GATv2 models (queue A item 8a); the evaluator over a
graph×data mesh and data-parallel sampled training (item 8b); the model
axes (item 8c): the tensor-parallel GCN over graph×model, the GPipe
pipeline and the expert-parallel MoE, with the five-axis dry run
(``dryrun.py``). The models are imported when first named, as in the JAX
package.
"""

from pygcn_tpu_torch.parallel.dist_spmm import make_dist_spmm
from pygcn_tpu_torch.parallel.mesh import make_mesh
from pygcn_tpu_torch.parallel.partition import DistPlan, build_dist_plan

__all__ = [
    "make_mesh",
    "DistPlan",
    "build_dist_plan",
    "make_dist_spmm",
    "DistGCN",
    "DistGCNOverMLP",
    "TPDistGCN",
    "PipelinedDeepGCN",
    "ExpertParallelMLP",
    "DistGAT",
    "DistSAGE",
    "DistAPPNP",
]

_LAZY = {"DistGCN": "dist_gcn", "DistGCNOverMLP": "dist_evaluator", "DistGAT": "dist_gat",
         "DistSAGE": "dist_sage", "DistAPPNP": "dist_sage", "TPDistGCN": "tp_gcn",
         "PipelinedDeepGCN": "pipeline", "ExpertParallelMLP": "moe"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f"pygcn_tpu_torch.parallel.{_LAZY[name]}"), name)
    raise AttributeError(name)
