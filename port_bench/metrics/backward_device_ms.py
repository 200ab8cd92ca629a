"""Device time of the operations launched inside the program's
``step/backward`` range, per ``bench/step``, over the traced window. The
``backward/<region>`` ranges inside it split the same time by region for
the ledger's breakdown (they hold all but 0.01% of it)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.count("bench/step") or not tr.count(
            "step/backward"):
        return None
    return tr.device_s("step/backward") * 1e3 / tr.count("bench/step")
