"""serve.fc6_roofline: fc6's operations (the `flops` of the port's
`model.fc6` spans: 2 x B x Ho x Wo x Cout x Cin x 49 at the shapes it is
given, padding included) over the H100's dense bf16 peak, as a share (%)
of the spans' device time (CUDA events around the product), over the
requests whose whole `serve.request` span lies in the traced window."""

from benchmark.bounds import PEAK_BF16_FLOP_S


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    roots = {r.id for r in recs
             if r.parent is None and r.name == "serve.request"}
    fc6 = [r for r in recs if r.trace in roots and r.name == "model.fc6"]
    if not fc6 or any(r.device_ms is None for r in fc6):
        return None
    sec = sum(r.device_ms for r in fc6) * 1e-3
    if sec <= 0:
        return None
    return 100.0 * sum(r.work["flops"] for r in fc6) / (
        PEAK_BF16_FLOP_S * sec)
