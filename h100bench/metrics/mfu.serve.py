"""The served path's share of the chip's bf16 peak: the convolutions of
every tile of the volumes served in the traced window (each tile 8
mirror-TTA forwards of the patch; the SR head only where the HR mask is
served), counted on the benchmark's reference model, over the window."""

from h100bench import count


def read(ctx):
    d, t = ctx.driver, ctx.trace
    if not d.volumes_done or t.window_s <= 0:
        return None
    flops = d.volumes_done * d.tiles_per_volume * d.tile_flops()
    return 100.0 * flops / t.window_s / count.BF16_FLOPS
