"""K1's share of its roofline: the launches in the traced window times the
least time one launch at the served tile's shape could take
(``count.k1_launch``), over K1's summed kernel time."""

from h100bench import count


def read(ctx):
    d = ctx.driver
    k, sec = ctx.trace.kernels_of("k1_pconv_pad11_cat")
    if not k or sec <= 0:
        return None
    w = count.k1_launch(d.arch, d.patch)
    return 100.0 * k * count.bound_s(w["flops"], w["bytes"]) / sec
