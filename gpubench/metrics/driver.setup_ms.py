"""Mean of the program's root span ``setup`` per job: from the entry of
``run_pipeline`` through the source, the ingest's resolution and the
driver's construction (its ``callsets`` search among it)."""

from gpubench.stats import mean


def read(ctx):
    spans = [j.spans["setup"] for j in ctx.jobs if "setup" in j.spans]
    return mean(spans) * 1e3 if spans else None
