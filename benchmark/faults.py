"""Faults planted under a run's timed path, to show that the check catches
them (``tests/test_bench_faults.py``) and to read their gaps on the card
(``calibrate.py``). Each takes a driver's run before its ``start``.

- ``unchanged``: the optimizer's step returns its state unchanged;
- ``half_batch``: half of the training nodes left out of the loss, the
  mean taken over the rest;
- ``answer_altered``: one 128-row block of the first layer's output lost
  (zero) where the layer produces it, as a tile kernel that skipped a block
  row would leave it.
"""

from __future__ import annotations

import torch


def unchanged(run) -> None:
    run.opt.step = lambda closure=None: None


def half_batch(run) -> None:
    kept = torch.nonzero(run.mask).flatten()
    mask = run.mask.clone()
    mask[kept[: kept.numel() // 2]] = 0.0
    run.mask = mask


def answer_altered(run) -> None:
    first = next(run.model.children())
    first = first[0] if isinstance(first, torch.nn.ModuleList) else first

    def lose_block(module, inputs, out):
        out = out.clone()
        out[:128] = 0.0
        return out

    first.register_forward_hook(lose_block)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "answer_altered": answer_altered}
