"""Experiment configuration: the dataclass and the reference's 9 presets
(the JAX package's configs/presets.py, field for field).

Preset ids and hyperparameters mirror reference configs.py (ids 1, 2, 4,
14-19); validation mirrors train.py:232-251, the run name train.py:253-286.

One reading differs from the JAX package, about the device: `fused_block1`
and `fused_eval` keep their values, but "auto" means "the model is on a
CUDA device" (the card's kernels), where the JAX package reads "the backend
is a TPU". `data_parallel` x `model_parallel` above 1 is a mesh run, one
process per rank (`cli/train.py`, `parallel/mesh.py`). `arch` also takes
"deeplabv2_r101" (DeepLab-v2 ResNet-101, `models/deeplab.py`), which the
JAX package lacks: the predict CLI serves it, the trainers refuse it.
"""

from __future__ import annotations

import dataclasses
import datetime
from zoneinfo import ZoneInfo

# reference trainer_fcn.py:303,305
EARLY_STOP_IMAGES = {"pascal": 425_000, "context": 247_000}


@dataclasses.dataclass
class Config:
    # reference fields (configs.py)
    mode: str = "train"                    # train | test_fcn | test_all
    dataset: str = "pascal"                # pascal | context
    train_unseen: tuple = ()
    val_unseen: tuple = ()
    embed_dim: int = 0                     # 0 => 21-way softmax baseline
    fcn_epochs: int = 30
    fcn_lr: float = 1e-10
    fcn_loss: str = "cross_entropy"        # cos | mse | cross_entropy
    fcn_optim: str = "sgd"                 # sgd | adam
    seenmask_epochs: int = 0
    seenmask_lr: float = 1e-3
    one_hot_embed: bool = False
    forced_unseen: bool = False
    load_fcn_path: str = ""
    # extensions of the JAX package (no reference equivalent)
    arch: str = "fcn32s"             # fcn32s | fcn8s | deeplabv2_r101
    batch_size: int = 1
    eval_batch_size: int = 1
    bucket: tuple = (512, 512)
    compute_dtype: str = "bfloat16"        # bfloat16 | float32
    data_parallel: int = 1
    model_parallel: int = 1
    seed: int = 1337                       # reference train.py:62
    log_interval: int = 1
    # logged steps whose metrics are read back in one copy: a read per step
    # would make the host wait for the device after every step. 1 = the
    # reference's immediate logging; 0 = read only at the epoch's end
    log_flush_steps: int = 16
    max_train_images: int = 0              # 0 => dataset default budget
    num_viz: int = 25                      # reference trainer_fcn.py:204
    channel_scale: float = 1.0             # <1: thin model (tests only)
    remat: bool = False                    # rematerialized conv blocks
    prune_pad: bool = True                 # support-pruned pad-100 blocks
    chunked_loss: bool = False             # per-sample loss (big batches)
    grad_accum: int = 1                    # microbatches per step
    fused_eval: str = "auto"               # K1 in validation: auto|on|off
    fused_block1: str = "auto"             # K2-K4 for block 1: auto|on|off
    compact_feed: bool = True              # uint8/int8 host feed
    # "auto": re-serve resident batches while the host-to-device copy
    # cannot keep up (trainer_fcn.echo_feed); "off" = the reference's
    # sample schedule
    data_echo: str = "off"
    data_echo_max_factor: float = 4.0
    profile_steps: int = 0                 # >0: torch.profiler over N steps
    # context label vocabulary: 33 (reference parity) or 59 (extension)
    context_classes: int = 33

    @property
    def num_classes(self) -> int:
        return 21 if self.dataset == "pascal" else self.context_classes

    @property
    def head_channels(self) -> int:
        return self.embed_dim if self.embed_dim else self.num_classes

    @property
    def early_stop_images(self) -> int:
        return self.max_train_images or EARLY_STOP_IMAGES[self.dataset]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _p(**kw) -> Config:
    return Config(**kw)


PRESETS: dict[int, Config] = {
    # fcn baseline with softmax inference (reference configs.py:4-16)
    1: _p(mode="train", dataset="pascal", embed_dim=0, fcn_epochs=30,
          fcn_lr=1e-10, fcn_loss="cross_entropy", fcn_optim="sgd"),
    # one-hot (configs.py:19-32)
    2: _p(mode="train", dataset="pascal", embed_dim=21, fcn_epochs=30,
          fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam"),
    # 20D pascal (configs.py:35-47)
    4: _p(mode="train", dataset="pascal", embed_dim=20, fcn_epochs=30,
          fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam"),
    # train seenmask: 20D 8/2/10 pascal zeroshot (configs.py:50-62)
    14: _p(mode="train", dataset="pascal", train_unseen=(1, 13),
           val_unseen=(6, 7, 10, 14, 15, 16, 17, 18, 19, 20), embed_dim=20,
           fcn_epochs=90, fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam",
           seenmask_epochs=10),
    # test: 20D 8/2/10 pascal zeroshot (configs.py:65-78)
    15: _p(mode="test_all", dataset="pascal", train_unseen=(1, 13),
           val_unseen=(6, 7, 10, 14, 15, 16, 17, 18, 19, 20), embed_dim=20,
           fcn_epochs=0, fcn_lr=1e-5, fcn_loss="cos", fcn_optim="adam",
           load_fcn_path="<set to cfg-14 run dir>"),
    # train: 20D 16/2/2 pascal zeroshot (configs.py:82-94)
    16: _p(mode="train", dataset="pascal", train_unseen=(1, 13),
           val_unseen=(17, 19), embed_dim=20, fcn_epochs=36, fcn_lr=1e-5,
           fcn_loss="cos", fcn_optim="adam", seenmask_epochs=10),
    # test: 20D 16/2/2 pascal zeroshot (configs.py:97-111)
    17: _p(mode="test_all", dataset="pascal", train_unseen=(1, 13),
           val_unseen=(17, 19), embed_dim=20, fcn_epochs=0, fcn_lr=1e-5,
           fcn_loss="cos", fcn_optim="adam",
           load_fcn_path="<set to cfg-16 run dir>"),
    # train: 20D 31/2/2 context zeroshot (configs.py:114-126)
    18: _p(mode="train", dataset="context", train_unseen=(0, 12),
           val_unseen=(16, 18), embed_dim=20, fcn_epochs=59, fcn_lr=1e-5,
           fcn_loss="cos", fcn_optim="adam", seenmask_epochs=10),
    # test: 20D 31/2/2 context zeroshot (configs.py:129-142)
    19: _p(mode="test_all", dataset="context", train_unseen=(0, 12),
           val_unseen=(16, 18), embed_dim=20, fcn_epochs=0, fcn_lr=1e-5,
           fcn_loss="cos", fcn_optim="adam",
           load_fcn_path="<set to cfg-18 run dir>"),
}


def get_config(preset: int, **overrides) -> Config:
    cfg = PRESETS[preset].replace(**overrides)
    validate_config(cfg)
    return cfg


def check_world_size(cfg: Config, world_size: int) -> None:
    """A run takes one process per rank of its data x model mesh: the
    world size must equal data_parallel x model_parallel."""
    need = cfg.data_parallel * cfg.model_parallel
    if world_size != need:
        raise ValueError(
            f"data_parallel={cfg.data_parallel} x model_parallel="
            f"{cfg.model_parallel} needs {need} processes, the run has "
            f"{world_size} (start one per rank, e.g. torchrun "
            f"--nproc_per_node {need})")


def validate_config(cfg: Config) -> None:
    """Cross-field rules, mirroring reference train.py:232-251."""
    if cfg.mode not in ("train", "test_fcn", "test_all"):
        raise ValueError(f"unknown mode {cfg.mode!r}")
    if cfg.dataset not in ("pascal", "context"):
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    if cfg.fcn_loss not in ("cos", "mse", "cross_entropy"):
        raise ValueError(f"unknown fcn_loss {cfg.fcn_loss!r}")
    if cfg.fcn_optim not in ("sgd", "adam"):
        raise ValueError(f"unknown fcn_optim {cfg.fcn_optim!r}")
    if cfg.arch not in ("fcn32s", "fcn8s", "deeplabv2_r101"):
        raise ValueError(f"unknown arch {cfg.arch!r}")
    if cfg.one_hot_embed and cfg.embed_dim != cfg.num_classes:
        raise ValueError(
            "joint-embedding space must be size of one-hot embedding space")
    if cfg.mode in ("test_fcn", "test_all") and not cfg.load_fcn_path:
        raise ValueError("must set load_fcn_path for test modes")
    if cfg.load_fcn_path and cfg.load_fcn_path.startswith("<"):
        # presets 15/17/19 ship a placeholder: loadable, not runnable until
        # pointed at a trained run
        raise ValueError(
            f"load_fcn_path is the placeholder {cfg.load_fcn_path!r} — "
            "override it with the run directory of the matching train "
            "preset (CLI: -r <run dir of the train preset>)")
    if cfg.fcn_epochs < 1 and not cfg.load_fcn_path:
        raise ValueError("fcn_epochs < 1 requires load_fcn_path")
    if cfg.seenmask_epochs > 0 and not cfg.train_unseen:
        raise ValueError(
            "can't train the seenmask classifier without train_unseen")
    if cfg.embed_dim == 0 and cfg.fcn_loss in ("cos", "mse"):
        raise ValueError(
            "embedding losses require embed_dim > 0")
    if cfg.data_parallel < 1 or cfg.model_parallel < 1:
        raise ValueError("mesh axes must be >= 1")
    if cfg.batch_size % cfg.data_parallel or cfg.eval_batch_size % cfg.data_parallel:
        raise ValueError("batch sizes must divide by data_parallel")
    if cfg.data_echo not in ("off", "auto"):
        raise ValueError(f"unknown data_echo {cfg.data_echo!r}")
    if cfg.context_classes not in (33, 59):
        raise ValueError("context_classes must be 33 (reference parity) or "
                         f"59 (extension), got {cfg.context_classes}")
    if cfg.dataset == "pascal" and cfg.context_classes != 33:
        raise ValueError("context_classes applies to the context dataset")
    if cfg.data_echo_max_factor <= 1.0:
        raise ValueError("data_echo_max_factor must be > 1 (1 = no echo; "
                         "use data_echo='off' instead)")
    if cfg.log_flush_steps < 0:
        raise ValueError("log_flush_steps must be >= 0 (0 = epoch-end only)")
    if cfg.fused_block1 not in ("off", "on", "auto"):
        raise ValueError(f"unknown fused_block1 {cfg.fused_block1!r}")
    if len(cfg.bucket) != 2 or min(cfg.bucket) < 1:
        raise ValueError(f"bucket must be two positive ints, got {cfg.bucket}")


def run_name(preset: int, cfg: Config, *, name: str | None = None,
             now: datetime.datetime | None = None) -> str:
    """Log-dir name encoding (reference train.py:253-286 format)."""
    parts = []
    if name:
        parts.append(name)
    parts.append(f"CFG_{int(preset)}")
    parts.append(f"MODE_{cfg.mode}")
    parts.append(f"DATASET_{cfg.dataset}")
    parts.append(f"TRAIN_UNSEEN_{bool(cfg.train_unseen)}")
    parts.append(f"VAL_UNSEEN_{bool(cfg.val_unseen)}")
    parts.append(f"EMBED_DIM_{cfg.embed_dim}")
    parts.append(f"FCN_EPOCHS_{cfg.fcn_epochs}")
    parts.append(f"FCN_LR_{cfg.fcn_lr}")
    parts.append(f"FCN_LOSS_{cfg.fcn_loss}")
    parts.append(f"FCN_OPTIM_{cfg.fcn_optim}")
    parts.append(f"SEENMASK_EPOCHS_{cfg.seenmask_epochs}")
    parts.append(f"SEENMASK_LR_{cfg.seenmask_lr}")
    if cfg.one_hot_embed:
        parts.append("ONE_HOT_EMBED_True")
    if cfg.forced_unseen:
        parts.append("FORCED_UNSEEN_True")
    if cfg.dataset == "context" and cfg.context_classes != 33:
        # extension field: 33-class run names stay byte-identical to the
        # reference format
        parts.append(f"CONTEXT_CLASSES_{cfg.context_classes}")
    now = now or datetime.datetime.now(ZoneInfo("America/New_York"))
    parts.append(f"TIME_{now.strftime('%Y%m%d-%H%M%S')}")
    return "_".join(parts) + "_"
