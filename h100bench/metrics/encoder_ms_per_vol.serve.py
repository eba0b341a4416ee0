"""Device ms a served volume of the kernels and copies launched inside the
program's ``rehrseg.segnet.encoder`` span: the encoder of every packed
forward (stem, convs, norms, and the residual arch's pools, projections
and adds), in device time."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.volumes_done
    host, ops = spans.events(ctx.trace)
    if not n or "rehrseg.segnet.encoder" not in host:
        return None
    inside = spans.union(host["rehrseg.segnet.encoder"])
    return 1e3 * sum(t - s for s, t, at in ops
                     if at is not None and spans.covers(inside, at)) / n
