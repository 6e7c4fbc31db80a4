"""Of the card's idle time over the traced jobs, the share that no program
span names: the idle gaps whose innermost range is the harness's own job
range or none (``DeviceTrace.idle_us`` keys whose range part, before the
first ``/``, is ``gpubench.job`` or ``outside any range``). A card never
idle leaves nothing unnamed: 0."""

from gpubench.devtrace import JOB_RANGE

UNSPANNED = (JOB_RANGE, "outside any range")


def read(ctx):
    if ctx.trace is None:
        return None
    idle = sum(ctx.trace.idle_us.values())
    if idle <= 0:
        return 0.0
    unspanned = sum(us for name, us in ctx.trace.idle_us.items()
                    if name.split("/", 1)[0] in UNSPANNED)
    return 100.0 * unspanned / idle
