"""serve.conv_fused_share: the share (%) of the port's `model.conv` spans
(each `ops.conv_relu.conv_bias_relu` call of the FCN trunk) inside the
`model.forward` spans that lie whole in the traced window that made the
one cuDNN conv + bias + ReLU call (the span's `fused` work is 1) rather
than the three ops (0). A route check, not a cost: a forward on the card
that records no backward takes the fused call, so serving reads 100 there
and 0 on the CPU. A program without such spans gives nothing."""


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    by_id = {r.id: r for r in recs}
    forwards = {r.id for r in recs if r.name == "model.forward"}

    def in_forward(r):
        while r.parent is not None and r.parent in by_id:
            if r.parent in forwards:
                return True
            r = by_id[r.parent]
        return False

    convs = [r for r in recs if r.name == "model.conv" and in_forward(r)]
    if not convs or any("fused" not in r.work for r in convs):
        return None
    return 100.0 * sum(r.work["fused"] for r in convs) / len(convs)
