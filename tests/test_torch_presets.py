"""The port's presets, validation and run names vs the JAX package's."""

import dataclasses
import datetime

import pytest
import torch

from zeroshotsemanticsegmentation_tpu.configs import presets as jp
from zeroshotsemanticsegmentation_tpu_torch.configs import presets as pp

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", sorted(jp.PRESETS))
def test_presets_equal_jax_field_for_field(preset):
    want = dataclasses.asdict(jp.PRESETS[preset])
    got = dataclasses.asdict(pp.PRESETS[preset])
    assert got == want
    for prop in ("num_classes", "head_channels", "early_stop_images"):
        assert getattr(pp.PRESETS[preset], prop) == \
            getattr(jp.PRESETS[preset], prop)


def test_field_names_and_defaults_equal_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(pp.Config)] == \
        [(f.name, f.default) for f in dataclasses.fields(jp.Config)]


@pytest.mark.parametrize("preset", [14, 18])
def test_get_config_overrides_equal_jax(preset):
    kw = dict(batch_size=8, eval_batch_size=4, fcn_epochs=2,
              bucket=(64, 64), channel_scale=0.5, compute_dtype="float32")
    assert dataclasses.asdict(pp.get_config(preset, **kw)) == \
        dataclasses.asdict(jp.get_config(preset, **kw))


BAD = {
    "one-hot-dim": (2, dict(one_hot_embed=True, embed_dim=20)),
    "test-without-path": (15, dict(load_fcn_path="")),
    "placeholder-15": (15, {}),
    "placeholder-17": (17, {}),
    "placeholder-19": (19, {}),
    "seenmask-without-unseen": (14, dict(train_unseen=())),
    "embed-loss-without-dim": (1, dict(fcn_loss="cos")),
    "mode": (14, dict(mode="eval")),
    "dataset": (14, dict(dataset="coco")),
    "loss": (14, dict(fcn_loss="l1")),
    "optim": (14, dict(fcn_optim="rmsprop")),
    "arch": (14, dict(arch="unet")),
    "no-epochs": (4, dict(fcn_epochs=0)),
    "mesh-axis": (14, dict(data_parallel=0)),
    "batch-divides": (14, dict(batch_size=3, data_parallel=2)),
    "echo": (14, dict(data_echo="on")),
    "context-classes": (18, dict(context_classes=40)),
    "pascal-context-classes": (14, dict(context_classes=59)),
    "echo-factor": (14, dict(data_echo_max_factor=1.0)),
    "flush": (14, dict(log_flush_steps=-1)),
    "fused-block1": (14, dict(fused_block1="yes")),
    "bucket": (14, dict(bucket=(0, 64))),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_validate_config_rejects_what_jax_rejects(case):
    preset, kw = BAD[case]
    with pytest.raises(ValueError) as jerr:
        jp.validate_config(jp.PRESETS[preset].replace(**kw))
    with pytest.raises(ValueError) as perr:
        pp.validate_config(pp.PRESETS[preset].replace(**kw))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(data_parallel=2, batch_size=2,
                                     eval_batch_size=2),
                                dict(model_parallel=2)])
def test_mesh_axes_above_one_are_not_ported(kw):
    jp.validate_config(jp.PRESETS[14].replace(**kw))  # the JAX mesh path
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        pp.validate_config(pp.PRESETS[14].replace(**kw))


@pytest.mark.parametrize("preset,kw", [
    (14, {}), (18, dict(context_classes=59)), (4, dict(one_hot_embed=False)),
    (2, dict(one_hot_embed=True, forced_unseen=True)),
])
def test_run_name_equals_jax_at_a_fixed_time(preset, kw):
    now = datetime.datetime(2026, 1, 2, 3, 4, 5)
    want = jp.run_name(preset, jp.PRESETS[preset].replace(**kw), name="x",
                       now=now)
    assert pp.run_name(preset, pp.PRESETS[preset].replace(**kw), name="x",
                       now=now) == want
