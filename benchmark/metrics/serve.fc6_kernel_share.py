"""serve.fc6_kernel_share: the share (%) of the port's `model.fc6` spans,
over the requests whose whole `serve.request` span lies in the traced
window, that ran fc6's forward on the implicit-GEMM kernel (the span's
`igemm` work is 1) rather than on the library convolution (0). A program
whose spans do not say (no `igemm` work) gives nothing."""


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
    if not fc6 or any("igemm" not in r.work for r in fc6):
        return None
    return 100.0 * sum(r.work["igemm"] for r in fc6) / len(fc6)
