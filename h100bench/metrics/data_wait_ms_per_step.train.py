"""Host ms a step spent blocked in the loader's or sampler's ``next``
(the benchmark's own span around the call)."""


def read(ctx):
    d = ctx.driver
    if not d.steps_done:
        return None
    return 1e3 * d.data_wait_s / d.steps_done
