"""Mean of the program's root span ``epilogue`` per job: the geometry
ledger, the conformance pairs, the rows emitted (``emit``), the I/O report
and the stage report."""

from gpubench.stats import mean


def read(ctx):
    spans = [j.spans["epilogue"] for j in ctx.jobs if "epilogue" in j.spans]
    return mean(spans) * 1e3 if spans else None
