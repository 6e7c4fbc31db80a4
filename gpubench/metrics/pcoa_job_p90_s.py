"""The 90th percentile (nearest rank) of the walls of every job completed
in the window; each wall ends with the fetch of the job's emitted rows."""

from gpubench.stats import percentile


def read(ctx):
    return percentile([job.wall_s for job in ctx.jobs], 90)
