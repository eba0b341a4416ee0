"""K2's share of its roofline, pooled over the LR and HR heads: the bytes
every tile of the volumes served in the traced window needs accumulated
(``count.k2_launch_bytes`` of each head) over the memory's bandwidth, over
K2's summed kernel time."""

from h100bench import count


def read(ctx):
    d = ctx.driver
    k, sec = ctx.trace.kernels_of("k2_accumulate_tta_tile")
    if not k or sec <= 0 or not d.volumes_done:
        return None
    nbytes = d.volumes_done * d.tiles_per_volume * d.k2_bytes_per_tile()
    return 100.0 * count.bound_s(0, nbytes) / sec
