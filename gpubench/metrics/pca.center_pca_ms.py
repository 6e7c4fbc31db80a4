"""Mean of the program's synchronised ``center+pca`` span per job."""

from gpubench.stats import mean


def read(ctx):
    spans = [j.spans["center+pca"] for j in ctx.jobs if "center+pca" in j.spans]
    return mean(spans) * 1e3 if spans else None
