"""Mean host time of a job outside its two synchronised stage spans
(``ingest+similarity``, ``center+pca``): the driver's construction, the
rows' emission and the I/O report."""

from gpubench.stats import mean

STAGES = ("ingest+similarity", "center+pca")


def read(ctx):
    jobs = [j for j in ctx.jobs if all(s in j.spans for s in STAGES)]
    if not jobs:
        return None
    return mean([j.wall_s - sum(j.spans[s] for s in STAGES) for j in jobs]) * 1e3
