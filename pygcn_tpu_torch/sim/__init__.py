"""The metapopulation epidemic simulator and its policy helpers."""

from pygcn_tpu_torch.sim.dist import simulate_policy_batch
from pygcn_tpu_torch.sim.model import (
    EpidemicParams,
    HostVisitSeq,
    VisitSeq,
    simulate,
    simulate_paged,
)

__all__ = [
    "EpidemicParams", "HostVisitSeq", "VisitSeq", "simulate", "simulate_paged",
    "simulate_policy_batch",
]
