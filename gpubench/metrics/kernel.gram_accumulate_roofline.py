"""``gram_accumulate``'s share of its roofline over the traced jobs: the
least time the card could take for their products (``roofline.py``:
int8 operations of the symmetric half over each job's kept sites, or the
bytes of Xᵀ and G) over the summed device time of the kernel."""

from gpubench.roofline import gram_least_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.op_seconds("gram_accumulate")
    if device_s <= 0:
        return None
    least = sum(gram_least_seconds(ctx.num_samples, kept) for kept in ctx.traced_kept_sites)
    return 100.0 * least / device_s
