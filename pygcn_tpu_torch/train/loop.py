"""Training-loop utilities: early stopping and the classifier's steps.

The port of ``pygcn_tpu/train/loop.py``. ``EarlyStopping`` is the
reference's ``pytorchtools.EarlyStopping`` (``pygcn/pytorchtools.py:4-51``):
a patience counter on minus the validation loss with a minimum delta.
``make_classifier_steps`` builds the full-batch train and eval steps of a
log-softmax node classifier (the KipfGCN/Cora workload): the masked mean
NLL, one forward, backward and optimizer update per train step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class EarlyStopping:
    patience: int = 7
    delta: float = 0.0
    verbose: bool = False

    counter: int = 0
    best_score: Optional[float] = None
    early_stop: bool = False

    def __call__(self, val_loss: float) -> bool:
        score = -float(val_loss)
        if self.best_score is None:
            self.best_score = score
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.counter = 0
        return self.early_stop

    def state_dict(self) -> dict:
        return {
            "counter": self.counter,
            "best_score": self.best_score,
            "early_stop": self.early_stop,
        }

    def load_state_dict(self, state: dict) -> None:
        self.counter = int(state["counter"])
        self.best_score = state["best_score"]
        self.early_stop = bool(state["early_stop"])


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the given nodes (``labels`` int [M])."""
    return -log_probs.gather(1, labels[:, None].long()).mean()


def masked_nll(logp: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the nodes where the float ``mask`` is 1."""
    per_node = -logp.gather(1, labels[:, None].long())[:, 0]
    return (per_node * mask).sum() / mask.sum()


def make_classifier_steps(model: torch.nn.Module, optimizer: torch.optim.Optimizer, graph):
    """``train_step(x, labels, mask, generator=None) -> loss`` and
    ``eval_step(x, labels, mask) -> (loss, accuracy)`` for a log-softmax node
    classifier called as ``model(x, graph, dropout_generator=...)``.

    ``mask`` is a float ``[N]`` tensor (:func:`bool_mask`); the loss is the
    masked mean NLL. The train step puts the model in training mode, passes
    ``generator`` on for dropout and updates the weights in place; it
    returns the loss before the update, as the JAX step does. The eval step
    runs in eval mode without gradients.
    """

    def train_step(x, labels, mask, generator: Optional[torch.Generator] = None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = masked_nll(model(x, graph, dropout_generator=generator), labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, labels, mask):
        model.eval()
        logp = model(x, graph)
        loss = masked_nll(logp, labels, mask)
        correct = (logp.argmax(dim=1) == labels).float() * mask
        return loss, correct.sum() / mask.sum()

    return train_step, eval_step


def bool_mask(idx, n: int) -> torch.Tensor:
    """A float32 ``[n]`` mask, 1 at ``idx``."""
    m = np.zeros(n, np.float32)
    m[np.asarray(idx)] = 1.0
    return torch.from_numpy(m)
