"""Candidate sites of every job completed in the window over the window's
length (host clock, to the end of its last job)."""


def read(ctx):
    return sum(job.sites for job in ctx.jobs) / ctx.window_s
