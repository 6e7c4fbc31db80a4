"""``gen_genotypes``' summed device time over the traced jobs per million
candidate sites they scanned."""


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = ctx.trace.op_seconds("gen_genotypes")
    if device_s <= 0:
        return None
    return device_s * 1e3 / (sum(j.sites for j in ctx.traced_jobs) / 1e6)
