"""Device ms a served volume of the kernels and copies launched inside the
program's ``rehrseg.segnet.norm_act`` spans: every ConvNormAct's tail
after its conv (bias, instance norm, affine, leaky ReLU, rim), whichever
route it takes, in device time. A program without the span gives None."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.volumes_done
    host, ops = spans.events(ctx.trace)
    if not n or "rehrseg.segnet.norm_act" not in host:
        return None
    inside = spans.union(host["rehrseg.segnet.norm_act"])
    return 1e3 * sum(t - s for s, t, at in ops
                     if at is not None and spans.covers(inside, at)) / n
