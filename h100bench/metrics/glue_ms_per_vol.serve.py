"""Device ms a served volume spends in elementwise, copy / layout and
reduction kernels: the passes around the convolutions."""

GLUE = ("elementwise", "copy_and_layout", "reduction")


def read(ctx):
    n = ctx.driver.volumes_done
    sec = sum(ctx.trace.kernels_of(c)[1] for c in GLUE)
    if not n or sec <= 0:
        return None
    return 1e3 * sec / n
