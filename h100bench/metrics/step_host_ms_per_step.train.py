"""Host ms a step inside the program's ``rehrseg.sr_step`` span (forward,
backward and update enqueued). Beside the device's busy ms a step: where
the two meet, the host paces the step."""

from h100bench import spans


def read(ctx):
    n = ctx.driver.steps_done
    sec = spans.seconds_in(ctx.trace, "rehrseg.sr_step")
    if not n or sec is None:
        return None
    return 1e3 * sec / n
