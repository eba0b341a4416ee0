"""Spatial (H-sharded) execution over a group of devices: what XLA's SPMD
partitioner inserts for the JAX package's ``'spatial'`` mesh axis, done by
hand.

One process drives the devices of a mesh row (a *group*). A channels-last
tensor (B, D, H, W, C) sharded over H is an :class:`HBlocks`: a list of
contiguous row blocks, block j on ``group[j]``, with the global row where
each starts. The ops of a forward take an HBlocks where they took a tensor:

  - :func:`conv` runs an H-coupled op (a conv, or any op whose output row i
    reads input rows ``s*i - lo .. s*i - lo + k - 1``, zeros outside) block
    by block: each block gathers the input rows its output rows read (its
    own, plus ``lo`` rows of its upper neighbour and the rows of its lower
    one: the halo, moved by ``Tensor.to(dev)``), runs the op unchanged on
    them with the op's own padding, and keeps its rows of the result; at the
    outer edges the op's own zero padding applies, as on the whole tensor.
    Output blocks split the output's H evenly (:func:`partition`);
  - :func:`local` maps an H-local op (elementwise, pointwise, channel
    concat, a kernel == stride transposed conv) over the blocks;
  - :func:`total` sums a per-block reduction (an instance norm's moments,
    in fp32) on the group's first device; the result goes back to each
    block's device;
  - :func:`gather` concatenates the blocks on the group's first device.

Where a level's H cannot give every device a block of at least the op's
halo, :func:`conv` runs that level gathered on the group's first device (a
one-block HBlocks); the next conv whose level is large enough splits it
again. Every step is a differentiable op or copy inside one process, so
autograd gives the backward of the halo exchange, of the moment sums and
of the weights' copies to each block's device (whose gradients it adds
into the leaf). :data:`RECORD` lists each conv's output rows per block,
which tests and ``chip_smoke.py`` read to see which levels ran sharded.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.pack2d import stats_dtype

# (tag, output rows of each block) of every conv run on an HBlocks, in
# order; one entry holds one number where the level ran gathered
RECORD: list = []


def reset_record() -> None:
    RECORD.clear()


def partition(h: int, n: int) -> list:
    """Even block starts of ``h`` rows over ``n`` devices, and ``h``."""
    return [j * h // n for j in range(n)] + [h]


class HBlocks:
    """A (B, D, H, W, C) tensor split along H (dim 2) into blocks:
    ``parts[j]`` holds rows ``starts[j]:starts[j + 1]`` on ``group[j]``.
    One part on ``group[0]`` is the gathered form of a level too small to
    split."""

    def __init__(self, parts, starts, group):
        self.parts = list(parts)
        self.starts = list(starts)
        self.group = list(group)
        assert len(self.starts) == len(self.parts) + 1
        assert len(self.parts) in (1, len(self.group))

    @property
    def h(self) -> int:
        return self.starts[-1]

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[2] = self.h
        return torch.Size(s)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    @property
    def sharded(self) -> bool:
        return len(self.parts) > 1

    def to(self, dtype) -> "HBlocks":
        """The blocks cast to ``dtype`` (a dtype only: blocks keep their
        devices)."""
        return HBlocks([p.to(dtype) for p in self.parts], self.starts,
                       self.group)

    def __repr__(self):
        return (f"HBlocks(shape={tuple(self.shape)}, starts={self.starts}, "
                f"group={self.group})")


def _on(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


def split(x: torch.Tensor, group) -> HBlocks:
    """``x`` split along H into even blocks, block j copied to
    ``group[j]``."""
    group = [torch.device(d) for d in group]
    starts = partition(x.shape[2], len(group))
    return HBlocks([x[:, :, a:b].to(dev) for a, b, dev in
                    zip(starts, starts[1:], group)], starts, group)


def rows(x: HBlocks, g0: int, g1: int, dev) -> torch.Tensor:
    """Global rows [g0, g1) of ``x`` on ``dev`` (slices of every block that
    holds some, copied there and concatenated)."""
    pieces = []
    for p, a, b in zip(x.parts, x.starts, x.starts[1:]):
        lo, hi = max(a, g0), min(b, g1)
        if lo < hi:
            pieces.append(p[:, :, lo - a:hi - a].to(dev))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


def gather(x):
    """The whole tensor on the group's first device (a tensor as it is)."""
    if not isinstance(x, HBlocks):
        return x
    if not x.sharded:
        return x.parts[0]
    return rows(x, 0, x.h, x.group[0])


def reshard(x: HBlocks, starts) -> HBlocks:
    """``x`` moved to the block starts ``starts`` (one block per device of
    its group, or one on the first device)."""
    if list(starts) == x.starts:
        return x
    return HBlocks([rows(x, a, b, dev) for a, b, dev in
                    zip(starts, starts[1:], x.group)], starts, x.group)


def conv(fn: Callable, x, *tensors, k: int, s: int = 1, pad=(0, 0),
         tag: str = "conv"):
    """``fn(x, *tensors)`` for an op along H with kernel extent ``k``,
    stride ``s`` and zero padding ``pad = (lo, hi)``. ``x`` is a tensor
    (then this is ``fn`` itself), an :class:`HBlocks`, or a tuple of
    HBlocks read alike (fn then takes a tuple); ``tensors`` (weights, or
    None) go to each block's device. Each output block runs ``fn`` on the
    input rows its rows read, with fn's own padding, and keeps its rows; a
    level too small for every device to hold the halo runs gathered."""
    xs = x if isinstance(x, tuple) else (x,)
    if not isinstance(xs[0], HBlocks):
        return fn(x, *tensors)
    lo, hi = pad
    group = xs[0].group
    n = len(group)
    h_in = xs[0].h
    h_out = (h_in + lo + hi - k) // s + 1
    halo = max(lo, k - 1 - lo, 1)
    if n == 1 or h_in // n < halo or h_out // n < 1:
        ins = tuple(gather(t) for t in xs)
        y = fn(ins if isinstance(x, tuple) else ins[0], *tensors)
        RECORD.append((tag, [h_out]))
        return HBlocks([y], [0, h_out], group)
    starts = partition(h_out, n)
    parts = []
    for o0, o1, dev in zip(starts, starts[1:], group):
        g0 = max(0, s * o0 - lo) // s * s
        g1 = min(h_in, s * (o1 - 1) - lo + k)
        ins = tuple(rows(t, g0, g1, dev) for t in xs)
        y = fn(ins if isinstance(x, tuple) else ins[0],
               *[_on(t, dev) for t in tensors])
        parts.append(y.narrow(2, o0 - g0 // s, o1 - o0))
    RECORD.append((tag, [b - a for a, b in zip(starts, starts[1:])]))
    return HBlocks(parts, starts, group)


def local(fn: Callable, *args, scale: int = 1, **kw):
    """``fn`` over the blocks of the HBlocks among ``args`` (brought to the
    starts of the first one that is split, else of the first), each call
    with the other tensors on that block's device. ``scale``: output rows per input row (a depth-to-space, a
    transposed conv whose kernel equals its stride). Without an HBlocks,
    ``fn(*args)``."""
    first = next((a for a in args if isinstance(a, HBlocks)), None)
    if first is None:
        return fn(*args, **kw)
    ref = next((a for a in args if isinstance(a, HBlocks) and a.sharded),
               first)
    args = [reshard(a, ref.starts) if isinstance(a, HBlocks) else a
            for a in args]
    parts = []
    for j, dev in enumerate(ref.group[:len(ref.parts)]):
        parts.append(fn(*[a.parts[j] if isinstance(a, HBlocks)
                          else _on(a, dev) for a in args], **kw))
    return HBlocks(parts, [scale * v for v in ref.starts], ref.group)


def local_rows(fn: Callable, x):
    """``fn(block, r0, r1)`` for each block holding global rows [r0, r1)
    (an op that depends on the global row, as the offset rim mask does);
    ``fn(x, 0, H)`` for a tensor."""
    if not isinstance(x, HBlocks):
        return fn(x, 0, x.shape[2])
    return HBlocks([fn(p, a, b) for p, a, b in
                    zip(x.parts, x.starts, x.starts[1:])], x.starts, x.group)


def total(x: HBlocks, fn: Callable) -> torch.Tensor:
    """The sum over blocks of ``fn(block)`` (a small reduction, e.g. an
    instance norm's moment sums), on the group's first device."""
    home = x.group[0]
    out = None
    for p in x.parts:
        r = fn(p).to(home)
        out = r if out is None else out + r
    return out


# ------------------------------------------------------------ instance norms
#
# The sharded forms of the packed forward's two norms (ops.pack2d.
# instance_norm_packed and models.segnet_packed._instance_norm): the same
# fp32 (fp64 for fp64 input) moments, summed over blocks by total(), and
# the same normalize in the input's dtype.


def instance_norm(x: HBlocks, scale, bias, eps: float) -> HBlocks:
    """Instance norm of an unpacked HBlocks over (D, H, W), two-pass."""
    count = x.shape[1] * x.h * x.shape[3]
    m = total(x, lambda t: stats_dtype(t).sum((1, 2, 3), keepdim=True)) / count
    v = total(x, lambda t: (stats_dtype(t) - m.to(t.device)).square().sum(
        (1, 2, 3), keepdim=True)) / count
    k = torch.rsqrt(v + eps)

    def apply(t, m_, k_, s_, b_):
        y = (t - m_.to(t.dtype)) * k_.to(t.dtype)
        return y * s_ + b_ if s_ is not None else y
    return local(apply, x, m, k, scale, bias)


def instance_norm_packed(x: HBlocks, scale, bias, eps: float = 1e-5,
                         offset_parity: bool = False,
                         true_w: int | None = None) -> HBlocks:
    """:func:`..ops.pack2d.instance_norm_packed` of a packed HBlocks: the
    four (dy, dx) groups' moments averaged, over the true pixels only
    (offset parity: rim masked to zero beforehand, (H-1)(W-1) pixels per
    group, E[x^2] - E[x]^2; aligned: two-pass)."""
    b_, d, h, w, c4 = x.shape
    c = c4 // 4

    def group_mean(t):
        return t.reshape(b_, 4, c).mean(1).repeat(1, 4)

    if offset_parity:
        n = d * (h - 1) * ((true_w if true_w is not None else w) - 1)
        m1 = group_mean(total(x, lambda t: stats_dtype(t).sum((1, 2, 3))) / n)
        m2 = group_mean(total(x, lambda t: stats_dtype(t).square().sum(
            (1, 2, 3))) / n)
        v = m2 - m1.square()
    else:
        n = d * h * w
        m1 = group_mean(total(x, lambda t: stats_dtype(t).sum((1, 2, 3))) / n)
        v = group_mean(total(x, lambda t: (
            stats_dtype(t) - m1.to(t.device)[:, None, None, None, :]).square()
            .sum((1, 2, 3))) / n)
    k = torch.rsqrt(v + eps)
    s4 = scale.repeat(4) if scale is not None else None
    b4 = bias.repeat(4) if scale is not None else None

    def apply(t, m_, k_, s_, b_):
        y = (t - m_[:, None, None, None, :].to(t.dtype)) \
            * k_[:, None, None, None, :].to(t.dtype)
        return y * s_ + b_ if s_ is not None else y
    return local(apply, x, m1, k, s4, b4)
