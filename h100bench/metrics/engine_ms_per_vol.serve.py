"""Device ms a served volume of the kernels and copies launched inside
``rehrseg.segment`` and outside every ``rehrseg.segment.forward``: the
Engine's device work (upload, mirror, unmirror, gaussian weighting,
accumulation, argmax, label fetch), apart from the packed forward's."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.volumes_done
    host, ops = spans.events(ctx.trace)
    engine = spans.outside(host, "rehrseg.segment", "rehrseg.segment.forward")
    if not n or engine is None:
        return None
    return 1e3 * sum(t - s for s, t, at in ops
                     if at is not None and spans.covers(engine, at)) / n
