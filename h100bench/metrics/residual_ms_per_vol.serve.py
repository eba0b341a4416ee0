"""Device ms a served volume of the kernels and copies launched inside the
program's ``rehrseg.segnet.residual`` spans: each BasicBlockD's skip
branch (average pool, 1x1x1 projection and its norm, the re-pack) and its
add and leaky ReLU, the residual mechanism's own non-conv cost."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.volumes_done
    host, ops = spans.events(ctx.trace)
    if not n or "rehrseg.segnet.residual" not in host:
        return None
    inside = spans.union(host["rehrseg.segnet.residual"])
    return 1e3 * sum(t - s for s, t, at in ops
                     if at is not None and spans.covers(inside, at)) / n
