"""The program's device memory peak over the window's jobs, in GiB:
``torch.cuda.max_memory_allocated`` over each job after
``reset_peak_memory_stats``, less the one Gramian the harness holds back
for the verdict."""


def read(ctx):
    if ctx.peak_bytes <= 0:
        return None
    return ctx.peak_bytes / 2**30
