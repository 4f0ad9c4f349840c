"""``gemm_ms``: device ms a step of the cuBLAS GEMMs (the ``gemm`` group of
the kernel-name groups)."""

from benchmark.trace import group_of


def read(ctx):
    return ctx.trace.ms_per_step(lambda name: group_of(name) == "gemm")
