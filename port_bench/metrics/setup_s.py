"""Process start to the first timed iteration (host clock): imports, the
CUDA context, the kernels' build on a checkout's first run, the weights,
the traffic pool, the model and the first (checked) steps."""


def read(ctx):
    return ctx.setup_s
