"""The feature cache's hit rate over the window, from its own counters:
(hits + host-tier hits) / (hits + host-tier hits + misses), in percent."""


def read(ctx):
    c = ctx.cache_window
    if not c:
        return None
    total = c["hits"] + c["l2_hits"] + c["misses"]
    return 100.0 * (c["hits"] + c["l2_hits"]) / total if total else None
