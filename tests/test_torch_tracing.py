"""The port's spans (`utils.profiling.span`) on the CPU: silent without a
profiler, nested as the code is under one, on the profiler's clock, and
kept in a bounded log."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zeroshotsemanticsegmentation_tpu_torch import configs, data
from zeroshotsemanticsegmentation_tpu_torch.cli.predict import predict_arrays
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor
from zeroshotsemanticsegmentation_tpu_torch.train import (
    FCNTrainer, SeenmaskTrainer, make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger, profiling
from zeroshotsemanticsegmentation_tpu_torch.utils.profiling import (
    clear_spans, force_tracing, span, spans)

torch.set_num_threads(2)

C, HW, SCALE = 20, 64, 1 / 32
CFG = dict(mode="train", dataset="pascal", embed_dim=C, fcn_epochs=1,
           fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam", seenmask_epochs=1,
           seenmask_lr=1e-3, train_unseen=(1, 13), val_unseen=(6, 7, 10),
           batch_size=2, eval_batch_size=2, bucket=(HW, HW),
           compute_dtype="float32", channel_scale=SCALE, num_viz=0,
           log_flush_steps=2)
EVERYTHING = (0, 2 ** 63 - 1)
SERVE_CHILDREN = {"serve.pad", "serve.h2d", "model.forward", "serve.labels",
                  "serve.d2h", "serve.crop"}


@pytest.fixture
def model():
    torch.manual_seed(0)
    return FCN32s(C, channel_scale=SCALE, dropout_rate=0.0, device="cpu")


@pytest.fixture(scope="module")
def embed():
    r = np.random.RandomState(0).randn(21, C).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


def _images(n, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (rng.randint(40, HW + 1),
                                 rng.randint(40, HW + 1), 3), np.uint8)
            for _ in range(n)]


def _serve(model, embed, images, batch_size=2):
    predict = make_szn_predictor(model, None, embed, [1, 13],
                                 upscore_trained=False, device="cpu")
    return predict_arrays(predict, images, bucket=(HW, HW),
                          batch_size=batch_size)


def _train(model, embed, tmp_path, stage=1):
    cfg = configs.Config(**CFG)
    loader = data.BatchLoader(data.SyntheticDataset(
        num_images=5, num_classes=21, size_range=(40, HW), seed=3), 2,
        bucket_hw=(HW, HW), compact=True, num_threads=2)
    log = RunLogger(str(tmp_path / f"s{stage}"), tensorboard=False,
                    verbose=False)
    if stage == 1:
        trainer = FCNTrainer(
            cfg=cfg, model=model,
            optimizer=make_fcn_optimizer(model, optim="adam", lr=1e-5),
            train_loader=loader, val_loader=loader, logger=log,
            embeddings=embed, upscore_trained=False)
    else:
        trainer = SeenmaskTrainer(
            cfg=cfg, model=model,
            optimizer=make_seenmask_optimizer(model, lr=1e-3),
            train_loader=loader, val_loader=loader, logger=log)
    trainer.train_epoch()
    log.close()
    return len(loader)


def _by_id(records):
    return {r.id: r for r in records}


def test_without_a_profiler_nothing_is_recorded_and_no_cuda_is_touched(
        model, embed, tmp_path, monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("touched while tracing is off")

    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        forbidden)
    assert span("x", device=True, flops=1) is span("y")
    _serve(model, embed, _images(3))
    _train(model, embed, tmp_path)
    assert spans(*EVERYTHING) == []


def test_request_spans_nest_as_the_code_does(model, embed):
    images = _images(5)
    with profile(activities=[ProfilerActivity.CPU]):
        labels = _serve(model, embed, images)
    assert [lb.shape for lb in labels] == [im.shape[:2] for im in images]
    recs = spans(*EVERYTHING)
    ids = _by_id(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["serve.request"] * 3
    for k, root in enumerate(roots):
        chunk = images[2 * k:2 * k + 2]
        assert root.trace == root.id
        assert root.work == {
            "images": len(chunk),
            "real_px": sum(im.shape[0] * im.shape[1] for im in chunk),
            "computed_px": 2 * HW * HW}
        mine = [r for r in recs if r.trace == root.id]
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
                   for r in mine)
        assert {r.name for r in mine if r.parent == root.id} == \
            SERVE_CHILDREN
        fc6 = [r for r in mine if r.name == "model.fc6"]
        pads = [r for r in mine if r.name == "model.ringpad"]
        assert len(fc6) == 1 and pads
        for r in fc6 + pads:
            assert ids[r.parent].name == "model.forward"
            assert r.device_ms is None  # no card
        # fc6: 7x7 over the pool5 grid, padding included
        w = model.fc6.weight
        assert fc6[0].work["flops"] % (2 * 2 * w.numel()) == 0
        assert all(r.work["bytes"] > 0 for r in pads)
    assert len({r.trace for r in recs}) == 3


def test_step_spans_nest_as_the_code_does(model, embed, tmp_path):
    for stage in (1, 2):
        clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            batches = _train(model, embed, tmp_path, stage)
        recs = spans(*EVERYTHING)
        steps = [r for r in recs if r.name == "train.step"]
        assert all(r.parent is None and r.trace == r.id for r in steps)
        # one a batch, and the wait that found the feed exhausted
        assert [r.work.get("images") for r in steps] == [2] * batches + [
            None]
        for s in steps:
            feed = [r for r in recs if r.parent == s.id
                    and r.name == "train.feed"]
            assert len(feed) == 1 and feed[0].trace == s.id
        # a step's log read back every second step, the rest after the last
        ids = _by_id(recs)
        flush = [r.parent and ids[r.parent].name for r in recs
                 if r.name == "train.log_flush"]
        assert flush == ["train.step"] * (batches // 2) + [None] * (
            batches % 2)
        if stage == 1:
            assert {r.name for r in recs} >= {"model.fc6", "model.ringpad"}


def test_records_sit_on_the_profilers_clock(model, embed):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, embed, _images(4))
    events = {}
    for e in prof.profiler.kineto_results.events():
        # host ranges, none of them a user annotation (which would add a
        # range on the device's timeline)
        assert e.activity_type() == "cpu_op" or not e.name().startswith(
            ("serve.", "model.")), e.name()
        events.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = spans(*EVERYTHING)
    assert recs
    for name in {r.name for r in recs}:
        mine = [(r.start_ns, r.end_ns) for r in recs if r.name == name]
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert abs(s - ks) < 1_000_000 and abs(e - ke) < 1_000_000, name


def test_the_log_stays_at_its_bound_and_clear_empties_it():
    with force_tracing():
        for i in range(profiling.MAX_SPANS + 5):
            with span("s", i=i):
                pass
    recs = spans(*EVERYTHING)
    assert len(recs) == profiling.MAX_SPANS
    assert recs[0].work == {"i": 5}
    assert recs[-1].work == {"i": profiling.MAX_SPANS + 4}
    clear_spans()
    assert spans(*EVERYTHING) == []


def test_forcing_records_without_a_profiler_and_the_window_filters():
    assert span("off") is span("off")
    with force_tracing():
        with span("a", n=1) as a:
            with span("b") as b:
                pass
        with span("c") as c:
            assert isinstance(c, profiling.Span)
    assert span("off") is span("off")
    assert [r.name for r in spans(*EVERYTHING)] == ["a", "b", "c"]
    assert (b.parent, b.trace, c.parent, c.trace) == (a.id, a.id, None, c.id)
    assert a.host_ms >= b.host_ms >= 0
    assert [r.name for r in spans(a.start_ns, a.end_ns)] == ["a", "b"]
    assert [r.name for r in spans(b.start_ns, c.end_ns)] == ["b", "c"]
    assert spans(a.start_ns + 1, c.end_ns)[0].name == "b"


def test_device_spans_resolve_their_events_when_read(monkeypatch):
    made = []

    class FakeEvent:
        clock = 0.0

        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None
            made.append(self)

        def record(self):
            FakeEvent.clock += 1.25
            self.at = FakeEvent.clock

        def synchronize(self):
            assert self.at is not None

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    with force_tracing():
        with span("dev", device=True) as d:
            with span("host") as h:
                pass
    assert len(made) == 2 and d.events is not None
    recs = spans(*EVERYTHING)
    assert recs[0] is d and d.device_ms == 1.25 and d.events is None
    assert h.device_ms is None
