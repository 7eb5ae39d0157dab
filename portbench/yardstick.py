"""The yardstick: the card's peaks, the least time a kernel's work could
take, the model's operations, and the device's busy time from a trace.

Frozen here so that the program cannot move them. The bound functions count
every input read once and every output written once, whatever a kernel
reads again, and the operations at the data sheet's peak; the larger of the
two times is the bound.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense rates at its full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ITEM = {"float32": 4, "bfloat16": 2}


def bound_s(nbytes: float, flop_s: float) -> float:
    """The larger of the bytes over the HBM rate and ``flop_s``."""
    return max(nbytes / HBM_BYTES_PER_S, flop_s)


def k5_bound_s(kernel: str, b: int, c: int, f: int, h: int, w: int,
               dtype: str) -> float:
    """The whole resnet block ("fwd") or its whole backward ("bwd"),
    whatever kernels compute it. fwd: x, td, w1, w2 (and w3) in, y out;
    conv_1, conv_2 (and the 1x1 w3 where C != F). bwd: x, td, w1, w2 (w3)
    and g in, dx, d_td, dw1, dw2 (dw3) out; conv_1 again, conv_2's and
    conv_1's dx and weight gradients (and w3's two)."""
    item, hw = ITEM[dtype], h * w
    conv1, conv2 = 9 * c * f, 9 * f * f
    one = c * f if c != f else 0
    if kernel == "fwd":
        flops = 2 * b * hw * (conv1 + conv2 + one)
        nbytes = item * (b * c * hw + b * f + conv1 + conv2 + one
                         + b * f * hw)
    else:
        flops = 2 * b * hw * (3 * conv1 + 2 * conv2 + 2 * one)
        nbytes = item * (2 * (b * c * hw + b * f + conv1 + conv2 + one)
                         + b * f * hw)
    return bound_s(nbytes, flops / PEAK_FLOPS[dtype])


def forward_flops(cfg: dict, batch: int = 1) -> int:
    """Operations (2 per multiply-add) of the U-Net's forward: every conv,
    the time denses and the attention's products; no elementwise work."""
    d1, d2, d3, d4 = cfg["embed_dims"]
    s, c, k = cfg["image_size"], cfg["in_channels"], cfg["kernel_size"]
    t, kd = cfg["time_embed_dim"], cfg["key_dim"]

    def conv(h, cin, cout, kk=k):
        return 2 * h * h * cout * cin * kk * kk

    def block(h, cin, cout):
        return (conv(h, cin, cout) + conv(h, cout, cout) + 2 * t * cout
                + (conv(h, cin, cout, 1) if cin != cout else 0))

    def attn(h, ch):
        n = h * h
        return 2 * n * ch * kd * 4 + 4 * n * n * kd

    def up(h, cin, cout):
        return conv(h, cin, cout) if cin != cout else 0

    total = (block(s, c, d1) + block(s, d1, d1) + conv(s // 2, d1, d2)
             + 2 * block(s // 2, d2, d2) + 2 * attn(s // 2, d2)
             + conv(s // 4, d2, d3) + 2 * block(s // 4, d3, d3)
             + conv(s // 8, d3, d4) + 2 * block(s // 8, d4, d4)
             + 2 * block(s // 8, d4, d4) + attn(s // 8, d4)
             + block(s // 8, 2 * d4, d4) + block(s // 8, d4, d4)
             + up(s // 4, d4, d3)
             + block(s // 4, 2 * d3, d3) + block(s // 4, d3, d3)
             + up(s // 2, d3, d2)
             + block(s // 2, 2 * d2, d2) + block(s // 2, d2, d2)
             + 2 * attn(s // 2, d2) + up(s, d2, d1)
             + block(s, 2 * d1, d1) + block(s, d1, d1) + conv(s, d1, c))
    return batch * total


def union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: time in which
    something ran, however many streams overlapped."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] outside the union of ``intervals``."""
    out, cursor = [], lo
    for start, end in sorted(intervals):
        if start > cursor:
            out.append((cursor, min(start, hi)))
        cursor = max(cursor, end)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]
