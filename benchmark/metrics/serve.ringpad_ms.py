"""serve.ringpad_ms: the device ms of the ring pads (the port's
`model.ringpad` spans, CUDA events around each constant-ring
concatenation of the support-pruned blocks) per `serve.request` span
whose whole request lies in the traced window."""


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
    if not roots or not pads or any(r.device_ms is None for r in pads):
        return None
    return sum(r.device_ms for r in pads) / len(roots)
