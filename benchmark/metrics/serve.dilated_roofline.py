"""serve.dilated_roofline: the operations of DeepLab-v2's dilated stages
(`benchmark.flops_r101.stage_flops` of the port's `model.layer3` and
`model.layer4` spans, at the batch and output sides each records) over the
H100's dense bf16 peak, as a share (%) of those spans' device time (CUDA
events around each stage), over the requests whose whole `serve.request`
span lies in the traced window. A program without the spans, or a
configuration without the driver's `model_cfg`, gives nothing."""

from benchmark.bounds import PEAK_BF16_FLOP_S
from benchmark.flops_r101 import stage_flops

STAGES = {"model.layer3": 2, "model.layer4": 3}


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
    recs = [r for r in recs if r.trace in roots and r.name in STAGES]
    if not recs or any(r.device_ms is None or "h" not in r.work
                       for r in recs):
        return None
    sec = sum(r.device_ms for r in recs) * 1e-3
    if sec <= 0:
        return None
    ops = sum(stage_flops(cfg, STAGES[r.name], r.work["batch"], r.work["h"],
                          r.work["w"]) for r in recs)
    return 100.0 * ops / (PEAK_BF16_FLOP_S * sec)
