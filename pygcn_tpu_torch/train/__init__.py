"""Optimizers, training loops, metrics, checkpoints, preemption and sweeps.

``DistCheckpointer`` (``checkpoint_dist.py``, the counterpart of the JAX
package's ``OrbaxCheckpointer``) is imported when first named: it pulls in
``torch.distributed.checkpoint``."""

__all__ = ["DistCheckpointer"]


def __getattr__(name):
    if name == "DistCheckpointer":
        from pygcn_tpu_torch.train.checkpoint_dist import DistCheckpointer

        return DistCheckpointer
    raise AttributeError(name)
