"""serve.host_ms: the host's own work a request puts in series with the
device in the closed loop, `predict_arrays`' bucket pad and crop: the host
ms of the `serve.pad` and `serve.crop` spans (the port's
`utils.profiling`) per `serve.request` span whose whole request lies in
the traced window."""

PARTS = ("serve.pad", "serve.crop")


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    roots = {r.id for r in recs
             if r.parent is None and r.name == "serve.request"}
    if not roots:
        return None
    return sum(r.host_ms for r in recs
               if r.trace in roots and r.name in PARTS) / len(roots)
