"""Closed-loop serving with the inputs resident on the card: pipelines that
decode frames onto the device (nvJPEG, video) and segment a batch at a
time, with no host round trip for the inputs.

`serve_closed`'s images and sample, but each request's batch is padded to
the bucket and copied to the device once, at set-up. A timed request calls
the `make_szn_predictor` predictor on the device uint8 batch and ends at
`torch.cuda.synchronize()`: no host pad, copy or crop is timed, and the
labels stay on the device. The sampled requests' labels are copied back
and cropped to each image after the window, for the check (the same as
`serve_closed`'s).
"""

from __future__ import annotations

import torch

from benchmark.traffic import serve_closed


class Driver(serve_closed.Driver):
    def __init__(self, ctx):
        super().__init__(ctx)
        self.batches = [torch.from_numpy(serve_closed.pad_batch(
            r, self.bucket, self.batch)).to(ctx.device)
            for r in self.requests]

    def _serve(self, i: int):
        labels = self.predict(self.batches[i])
        self.ctx.sync()
        return labels

    def free(self) -> None:
        super().free()
        self.batches = None

    def sample(self) -> list:
        """The checked requests' labels, each image's cropped on the
        host."""
        out = []
        for i, labels in super().sample():
            labels = labels.cpu().numpy()
            out.append((i, [lb[:im.shape[0], :im.shape[1]]
                            for im, lb in zip(self.requests[i], labels)]))
        return out
