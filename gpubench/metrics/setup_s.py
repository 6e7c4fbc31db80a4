"""Set-up: from the process's start (before torch is imported) to the end
of the warm jobs, kernel builds and loads included."""


def read(ctx):
    return ctx.setup_s
