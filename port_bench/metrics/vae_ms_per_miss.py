"""Device time of the operations launched inside the feature cache's
``cache/vae`` ranges (the true misses' images to the device, the frozen
VAE over them, their slots written) over the window's true misses (the
cache's own ``misses``), in ms: the VAE's cost per image, apart from the
hit rate."""


def read(ctx):
    tr, c = ctx.trace, ctx.cache_window
    if tr is None or not c or not c["misses"] or not tr.count("cache/vae"):
        return None
    return tr.device_s("cache/vae") * 1e3 / c["misses"]
