"""serve.pixel_yield: the images' own pixels over the pixels computed
(the static batch of bucket-sized images), in %, summed over the
`serve.request` spans (the port's `utils.profiling`: work `real_px`,
`computed_px`) that lie whole in the traced window."""


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    roots = [r for r in spans(t.start, t.end)
             if r.parent is None and r.name == "serve.request"]
    computed = sum(r.work["computed_px"] for r in roots)
    if not computed:
        return None
    return 100.0 * sum(r.work["real_px"] for r in roots) / computed
