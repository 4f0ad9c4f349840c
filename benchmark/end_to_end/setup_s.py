"""``setup_s``: from the start of the benchmark's process to the first timed
step: importing torch, loading the kernel libraries, generating the data,
the host pipeline, the upload and the warm-up."""


def read(ctx):
    return ctx.setup_s
