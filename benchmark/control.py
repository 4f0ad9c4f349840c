"""The control of the check: the plain reference put in the program's place
and computed in TF32, the precision below the configurations' float32 with
TF32 off. The check has to find it not correct (``calibrate.py`` reads it
on the card; ``tests/test_bench_faults.py`` holds it against the limits)."""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control(run) -> dict:
    """The reference's first steps of the driver's ``run``, in float32 with
    every dense product, forward and backward, in TF32: cuBLAS with TF32
    allowed on a card, the operands rounded to TF32 (:class:`_TF32MatMul`)
    on a host without one."""
    if run.device.type != "cuda":
        return run.reference(torch.float32, _TF32MatMul.apply)
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    try:
        for f in flags:
            f.allow_tf32 = True
        return run.reference(torch.float32)
    finally:
        for f in flags:
            f.allow_tf32 = False


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with every product's operands rounded to TF32, forward and
    backward, as cuBLAS computes with TF32 on."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.T, ra.T @ rg
