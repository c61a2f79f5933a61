"""serve.aspp_roofline: DeepLab-v2's ASPP heads against their bound, in %:
the sum over the port's `model.aspp` spans (of the requests whose whole
`serve.request` span lies in the traced window) of
`bounds.bound_s(bytes, ops, PEAK_BF16_FLOP_S)`, over the spans' device
time (CUDA events around the four branches and their sum). At the batch B
and 1/8 sides (h, w) a span records, with Cin the last stage's channels
(2048), Cout both heads' channels (20 + 2) and R rates (4)
(`benchmark.flops_r101.aspp_ops_bytes`):

    ops   = R * 2 * B * h * w * Cin * Cout * 9
    bytes = R * 2 * (B * h * w * Cin + Cout * Cin * 9 + B * h * w * Cout)

the bf16 input read once a rate, the bf16 weights, and the bf16 output of
each rate written once. A program without the spans, or a configuration
without the driver's `model_cfg`, gives nothing."""

from benchmark.bounds import PEAK_BF16_FLOP_S, bound_s
from benchmark.flops_r101 import aspp_ops_bytes


def read(t):
    cfg = t.work.get("model_cfg")
    if cfg is None:
        return None
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    roots = {r.id for r in recs
             if r.parent is None and r.name == "serve.request"}
    recs = [r for r in recs if r.trace in roots and r.name == "model.aspp"]
    if not recs or any(r.device_ms is None or "h" not in r.work
                       for r in recs):
        return None
    sec = sum(r.device_ms for r in recs) * 1e-3
    if sec <= 0:
        return None
    bound = 0.0
    for r in recs:
        ops, nbytes = aspp_ops_bytes(cfg, r.work["batch"], r.work["h"],
                                     r.work["w"])
        bound += bound_s(nbytes, ops, PEAK_BF16_FLOP_S)
    return 100.0 * bound / sec
