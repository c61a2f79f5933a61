"""train.feed_wait_ms: the host's wait for the next batch (the port's
`train.feed` spans: the loader's queue, then the copy's start) in ms per
training step (`train.step` spans with `images`) over the steps whose
whole span lies in the traced window. The wait that finds an epoch's feed
exhausted ends a step span of its own and counts, without a step."""


def read(t):
    try:
        from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
            spans)
    except ImportError:  # a program without spans
        return None
    recs = spans(t.start, t.end)
    roots = {r.id: r for r in recs
             if r.parent is None and r.name == "train.step"}
    steps = sum(1 for r in roots.values() if r.work.get("images"))
    if not steps:
        return None
    return sum(r.host_ms for r in recs
               if r.trace in roots and r.name == "train.feed") / steps
