"""serve.ringpad_kernel_share: the share (%) of the port's `model.ringpad`
spans, over the requests whose whole `serve.request` span lies in the
traced window, that ran on the ring-pad kernel (the span's `kernel` work is
1) rather than on the plain concatenation (0). A program whose spans do not
say (no `kernel` work) gives nothing."""


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    roots = {r.id for r in recs
             if r.parent is None and r.name == "serve.request"}
    pads = [r for r in recs if r.trace in roots and r.name == "model.ringpad"]
    if not pads or any("kernel" not in r.work for r in pads):
        return None
    return 100.0 * sum(r.work["kernel"] for r in pads) / len(pads)
