"""Device-idle ms a served volume under a ``rehrseg.segment`` span and
outside its ``rehrseg.segment.tile`` spans: the idle that the request's
prep, upload, argmax, fetch and crop leave on the card."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.volumes_done
    host, _ = spans.events(ctx.trace)
    between = spans.outside(host, "rehrseg.segment", "rehrseg.segment.tile")
    if not n or between is None:
        return None
    return 1e3 * spans.total(spans.intersect(ctx.trace.gaps(), between)) / n
