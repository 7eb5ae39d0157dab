"""The yardstick of the ADM cell: the model's operations and the least time
of its flash attention, on the card's peaks (``yardstick.py``'s, frozen
there)."""

from __future__ import annotations

from portbench.reference_adm import layout
from portbench.yardstick import ITEM, PEAK_FLOPS, bound_s


def adm_forward_flops(cfg: dict, batch: int = 1) -> int:
    """Operations (2 per multiply-add) of the ADM U-Net's forward: every
    conv, the time MLP and the blocks' embedding denses, the attention's
    qkv and output projections and its two products (QKᵀ and AV); no
    elementwise work, normalization or loss."""
    mc, s = cfg["num_channels"], cfg["image_size"]
    emb = 4 * mc
    c0 = cfg["channel_mult"][0] * mc

    def conv(side, cin, cout, k=3):
        return 2 * side * side * cin * cout * k * k

    total = 2 * (mc * emb + emb * emb)  # the time MLP
    total += conv(s, cfg["in_channels"], c0) + conv(s, c0,
                                                    2 * cfg["in_channels"])
    inp, mid, out = layout(cfg)
    for blk in inp + mid + out:
        side, cin, cout = blk["res"], blk["cin"], blk["cout"]
        if blk["type"] == "attn":
            n = side * side
            total += 2 * n * cin * 4 * cin + 4 * n * n * cin
            continue
        after = {"down": side // 2, "up": side * 2}.get(blk["resample"],
                                                        side)
        total += (conv(after, cin, cout) + conv(after, cout, cout)
                  + 2 * emb * 2 * cout
                  + (conv(after, cin, cout, 1) if cin != cout else 0))
    return batch * total


def flash_sites(cfg: dict, batch: int):
    """(B·heads, N, head dim) of every attention block that takes flash
    (N ≥ 1024 tokens, the port's dispatch threshold)."""
    inp, mid, out = layout(cfg)
    d = cfg["num_head_channels"]
    return [(batch * (blk["cin"] // d), blk["res"] ** 2, d)
            for blk in inp + mid + out
            if blk["type"] == "attn" and blk["res"] ** 2 >= 1024]


def flash_bound_s(kind: str, bh: int, n: int, d: int, dtype: str) -> float:
    """The least time of flash attention at (B·H, N, d), whatever kernels
    compute it. fwd: q, k, v in, o and the f32 lse out; 4·N²·d·BH
    operations (QKᵀ and PV). bwd: q, k, v, o, dO and the lse in, dq, dk,
    dv out; 10·N²·d·BH operations (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q)."""
    item, maps, lse = ITEM[dtype], bh * n * d, 4 * bh * n
    if kind == "fwd":
        nbytes, flops = item * 4 * maps + lse, 4 * n * n * d * bh
    else:
        nbytes, flops = item * 8 * maps + lse, 10 * n * n * d * bh
    return bound_s(nbytes, flops / PEAK_FLOPS[dtype])
