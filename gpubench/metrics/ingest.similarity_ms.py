"""Mean of the program's synchronised ``ingest+similarity`` span per job."""

from gpubench.stats import mean


def read(ctx):
    spans = [j.spans["ingest+similarity"] for j in ctx.jobs if "ingest+similarity" in j.spans]
    return mean(spans) * 1e3 if spans else None
