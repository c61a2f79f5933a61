"""train.mfu: the convolutions' operations of every training step the
traced window completed (`benchmark.flops.stage1_flops` or `stage2_flops`
at each image's own size, on the support-pruned geometry), over the
window, as a share (%) of the H100's dense bf16 peak."""

from benchmark.bounds import PEAK_BF16_FLOP_S


def read(t):
    ops = t.work.get("flops")
    if not ops or t.window_s <= 0:
        return None
    return 100.0 * ops / (t.window_s * PEAK_BF16_FLOP_S)
