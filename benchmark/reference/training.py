"""The reference's full-graph training: masked mean NLL and Adam with L2
decay added to the gradient (``torch.optim.Adam``'s update, written out),
followed for a few steps from the benchmark's initial parameters."""

from __future__ import annotations

import torch


def masked_nll(logp: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    per_node = -logp.gather(1, labels[:, None])[:, 0]
    return (per_node * mask).sum() / mask.sum()


def follow(model, config: dict, params0: dict, adj, x, labels, mask, steps: int,
           matmul=torch.matmul) -> dict:
    """``steps`` training steps of ``model`` (a reference module with
    ``forward(config, params, adj, x, matmul)``) from ``params0``; returns
    the first step's log-probabilities (``logp``), the loss before each
    update (``losses``), the first step's gradient by
    leaf as Adam takes it, the decay added (``grad1``), and the leaves after
    the last update (``params``)."""
    lr, wd = config["lr"], config["weight_decay"]
    b1, b2 = config["adam_betas"]
    eps = config["adam_eps"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad1, logp = [], None, None
    for t in range(1, steps + 1):
        out = model.forward(config, params, adj, x, matmul)
        logp = out.detach() if logp is None else logp
        loss = masked_nll(out, labels, mask)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = [g + wd * p if wd else g for p, g in zip(params.values(), grads)]
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(params, grads)}
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k] / (1 - b2 ** t)).sqrt() + eps
                p.sub_(lr / (1 - b1 ** t) * m[k] / denom)
    return {"logp": logp, "losses": losses, "grad1": grad1,
            "params": {k: p.detach() for k, p in params.items()}}
