"""k1_warp_roofline: K1's uint8 warp (``warp_kernel<1, ...>`` for luma,
``warp_kernel<2, ...>`` for the two chroma planes, ``csrc/warp.cu``) as a
share of its roofline: the least time of the window's launches at the
published peaks (``portbench/k1_bound.py``; each launch a batch of
``warp_batch`` frames of the configuration's clip warped to its stock
output) over their device time, summed by kernel name from the trace."""

from portbench import k1_bound


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    w = ctx.warp
    n = ctx.warp_batch
    luma_s, luma_n = t.op_seconds(r"warp_kernel<1,")
    chroma_s, chroma_n = t.op_seconds(r"warp_kernel<2,")
    if not luma_n or not chroma_n:
        return None
    ih, iw = ctx.clip.height, ctx.clip.width
    bound = (luma_n * k1_bound.launch_bound_s(n, 1, (ih, iw), (w.out_h, w.out_w), True)
             + chroma_n * k1_bound.launch_bound_s(n, 2, (ih // 2, iw // 2),
                                                  (w.out_h // 2, w.out_w // 2), True))
    return 100.0 * bound / (luma_s + chroma_s)
