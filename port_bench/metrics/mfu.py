"""Model FLOPs per sample (counts/model_flops.py, over the first checked
batch) times the traced window's samples per second on the host's clock,
over the H100's bf16 dense peak (989 TFLOP/s, the configurations' compute
dtype) times the chips, in percent."""

from port_bench.counts import model_flops

BF16_PEAK = 989e12


def read(ctx):
    if ctx.trace is None:
        return None
    flops = model_flops.flops_per_sample(ctx.spec, ctx.mix, ctx.reference,
                                         ctx.batches[0], ctx.device)
    if not flops:
        return None
    rate = ctx.samples / ctx.window_s
    return 100.0 * flops * rate / (BF16_PEAK * ctx.chips)
