"""Differentiable policy optimization against a frozen surrogate evaluator.

The port of ``pygcn_tpu/policy/topk.py``, the training core of the
reference's ``policy-generator.py`` / ``hierarchical-policy-generator.py``:
the generator emits a (straight-through) top-K vaccination flag, the flag is
spliced into the evaluator's feature layout, and the frozen evaluator's
scalar prediction *is* the loss — gradients flow through the frozen
evaluator's input into the generator
(reference ``pygcn/policy-generator.py:384-428``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def make_generator_train_step(generator, evaluator, optimizer: torch.optim.Optimizer, graph,
                              eval_base_feats: torch.Tensor):
    """Returns ``step(gen_feats) -> (loss, vac_flag)``, both on the device:
    the evaluator's prediction for the generator's flag (before the update)
    and that flag ``[N, 1]``, after one step of ``optimizer`` over the
    generator's parameters.

    The evaluator (a :class:`~pygcn_tpu_torch.nn.models.GCNOverMLP`) is
    frozen here: its parameters stop requiring gradients
    (``requires_grad_(False)``), while its head still runs with autograd, so
    the gradient reaches the generator through the evaluator's input. The
    flag lies past the evaluator's GCN inputs (``dim_touched``), so the GCN
    sees only the constant base: its output is computed once, here, and
    each step runs the head on it and the flag. The values are those of
    ``evaluator([base, flag])``, as JAX's step computes them.

    ``eval_base_feats``: [N, F_eval - 1] — the evaluator feature block minus
    the trailing vac flag (the duplicated demographics+centrality layout the
    reference assembles at ``policy-generator.py:398-399``).
    """
    evaluator.requires_grad_(False)
    d = evaluator.dim_touched
    if d > eval_base_feats.shape[1]:
        raise ValueError(f"the evaluator's GCN reads {d} features, the flag's column among them")
    with torch.no_grad():
        gcn_out = evaluator.gcn(eval_base_feats[None, :, :d], graph)
    untouched = eval_base_feats[None, :, d:]

    def step(gen_feats):
        optimizer.zero_grad(set_to_none=True)
        vac_flag = generator(gen_feats, graph)  # [N, 1]
        pred = evaluator.head(gcn_out, torch.cat([untouched, vac_flag[None]], dim=2))
        loss = pred.sum()
        loss.backward()
        optimizer.step()
        return loss.detach(), vac_flag.detach()

    return step


def extract_policy(vac_flag) -> Tuple[int, ...]:
    """Nonzero-flag node indices as a hashable policy key
    (reference ``policy-generator.py:389``)."""
    flag = vac_flag.detach().cpu().numpy() if torch.is_tensor(vac_flag) else np.asarray(vac_flag)
    return tuple(np.nonzero(flag.ravel())[0].tolist())


def policy_to_vaccination_vector(
    policy, n_cbgs: int, num_vaccines_per_cbg: float
) -> np.ndarray:
    """Policy indices → per-CBG vaccine counts
    (reference ``traditional_evaluate``, ``policy-generator.py:210-221``)."""
    v = np.zeros(n_cbgs)
    v[np.asarray(policy, np.int64)] = num_vaccines_per_cbg
    return v
