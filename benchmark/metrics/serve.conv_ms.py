"""serve.conv_ms: the device ms of the FCN trunk's 3x3 convolutions with
their bias and ReLU (the port's `model.conv` spans, CUDA events around
each `ops.conv_relu.conv_bias_relu` call: blocks 2-5 and the frame probe)
per `model.forward` span that lies whole in the traced window. Read per
forward, not per request, so a cell whose requests have no
`serve.request` span reads it too."""


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
    if not convs or any(r.device_ms is None for r in convs):
        return None
    return sum(r.device_ms for r in convs) / len(forwards)
