"""The training step's share of the chip's bf16 peak: three times the
trained model's forward convolutions (forward, and the two products of
the backward) of every step in the traced window, counted on the
benchmark's reference model, over the window."""

from h100bench import count


def read(ctx):
    d, t = ctx.driver, ctx.trace
    if not d.steps_done or t.window_s <= 0:
        return None
    return (100.0 * d.steps_done * d.step_flops() / t.window_s
            / count.BF16_FLOPS)
