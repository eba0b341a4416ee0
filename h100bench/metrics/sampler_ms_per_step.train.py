"""Host ms a step inside the program's ``rehrseg.sampler.next`` span: the
stage-1 sampler's own time, the twin of ``data_wait_ms_per_step.train``
(the benchmark's span around the same call)."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.steps_done
    sec = spans.seconds_in(ctx.trace, "rehrseg.sampler.next")
    if not n or sec is None:
        return None
    return 1e3 * sec / n
