"""Experiment runner: config -> data -> model -> two-stage training / testing
(the JAX package's cli/train.py).

CLI-compatible with the reference entry point (train.py:16-200):
``python -m zeroshotsemanticsegmentation_tpu_torch.cli.train -c 14`` runs
the 8/2/10 PASCAL zero-shot SZN pipeline end to end on the card (FCN stage,
then seenmask stage, checkpoints, CSV/TB logs); ``--synthetic -ve 1 -se 1``
is a smoke run without datasets. ``--device cpu`` runs the kernels' plain
versions on the CPU; without a card and without it, the run raises.

Not ported: fetching datasets and VGG16 weights (the JAX package's
data/download.py and models/pretrained.py): a missing dataset raises its
constructor's error, and a fresh run without VGG16 weights starts from a
random backbone with a warning.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os.path as osp

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.configs import (
    PRESETS, get_config, run_name)
from zeroshotsemanticsegmentation_tpu_torch.configs.presets import (
    require_one_device)
from zeroshotsemanticsegmentation_tpu_torch.data import (
    BatchLoader, PascalContext, PascalVOC, SyntheticDataset,
    load_class_embeddings)
from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.vgg_import import (
    load_vgg16_into_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    FCNTrainer, SeenmaskTrainer, make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger


def _build_datasets(cfg, *, data_dir, synthetic):
    if synthetic:
        hi = min(cfg.bucket)
        mk = lambda n, seed: SyntheticDataset(  # noqa: E731
            num_images=n, num_classes=cfg.num_classes,
            size_range=(min(64, hi), hi), seed=seed)
        return mk(8, 0), mk(6, 1), mk(4, 2)
    cls = PascalVOC if cfg.dataset == "pascal" else PascalContext
    kw = dict(data_dir=data_dir, val_unseen=list(cfg.val_unseen))
    if cfg.dataset == "context":
        kw["n_classes"] = cfg.context_classes
    train = cls("train", **kw)
    train_seen = cls("train_seen", train_unseen=list(cfg.train_unseen), **kw)
    val = cls("val", **kw)
    return train, train_seen, val


def run_experiment(cfg, *, preset: int = 0, name: str | None = None,
                   data_dir: str = "data", tb_dir: str | None = None,
                   log_dir: str | None = None, synthetic: bool = False,
                   vgg16_path: str | None = None, resume: str = "",
                   verbose: bool = True, device: str = "cuda") -> dict:
    """Build and run one experiment on `device`; returns a summary dict.

    Mirrors reference main() wiring: FCN trains on the *train_seen* loader,
    the seenmask stage on the *train* loader (train.py:144,185 — the
    asymmetry is the method); test modes only validate.
    """
    dev = resolve_device(device)
    require_one_device(cfg)
    if cfg.arch != "fcn32s":
        raise NotImplementedError(
            f"arch={cfg.arch!r}: FCN-8s is not ported yet (ROADMAP.md queue "
            "1 item 6)")
    if cfg.remat:
        raise NotImplementedError("remat: rematerialization is not ported")
    if cfg.num_viz > 0 and importlib.util.find_spec("PIL") is None:
        # fail before training, not at the first validation
        raise RuntimeError(
            f"num_viz={cfg.num_viz}: the viz tiles are written with Pillow, "
            "which is not installed; install it or set num_viz=0")
    log_dir = log_dir or osp.join(data_dir, "logs",
                                  run_name(preset, cfg, name=name))
    logger = RunLogger(log_dir, tb_dir=tb_dir, verbose=verbose)
    logger.dump_config(dataclasses.asdict(cfg))

    # 1. data
    train_ds, train_seen_ds, val_ds = _build_datasets(
        cfg, data_dir=data_dir, synthetic=synthetic)
    mk_loader = lambda ds, bs, sh: BatchLoader(  # noqa: E731
        ds, bs, bucket_hw=tuple(cfg.bucket), shuffle=sh, seed=cfg.seed,
        compact=cfg.compact_feed)
    train_loader = mk_loader(train_ds, cfg.batch_size, True)
    train_seen_loader = mk_loader(train_seen_ds, cfg.batch_size, True)
    val_loader = mk_loader(val_ds, cfg.eval_batch_size, False)

    counts = [str(len(train_seen_ds)), str(len(train_ds) - len(train_seen_ds)),
              str(len(val_ds))]
    logger.csv_append("counts.csv", ["train_seen", "train_unseen", "val"],
                      counts)
    for tag, v in zip(["num/train_seen", "num/train_unseen", "num/val"],
                      counts):
        logger.text(tag, v)

    # 2. embeddings (NNE always uses the word2vec matrix; regression targets
    # use one-hot when cfg.one_hot_embed — reference trainer_fcn.py:49)
    embeddings = target_embeddings = None
    if cfg.embed_dim:
        if synthetic:
            r = np.random.RandomState(0).randn(
                cfg.num_classes, cfg.embed_dim).astype(np.float32)
            embeddings = r / np.linalg.norm(r, axis=1, keepdims=True)
        else:
            embeddings = load_class_embeddings(cfg.dataset, cfg.embed_dim,
                                               n_classes=cfg.num_classes)
        target_embeddings = embeddings
        if cfg.one_hot_embed:
            target_embeddings = (np.eye(cfg.num_classes, dtype=np.float32)
                                 if synthetic else
                                 load_class_embeddings(
                                     cfg.dataset, cfg.embed_dim,
                                     one_hot=True,
                                     n_classes=cfg.num_classes))

    # 3. model + init: weights from `cfg.seed`; block 1's kernels ("auto")
    # wherever the model is on the card
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    fb1 = cfg.fused_block1 == "on" or (cfg.fused_block1 == "auto"
                                       and dev.type == "cuda")
    model = FCN32s(cfg.head_channels, dtype=dtype,
                   channel_scale=cfg.channel_scale, prune_pad=cfg.prune_pad,
                   fused_block1=fb1,
                   generator=torch.Generator().manual_seed(cfg.seed),
                   device=dev)

    start_epoch = start_iteration = 0
    best_mean_iu = 0.0
    # a fresh init leaves `seenmask_upscore` at its bilinear init; a loaded
    # checkpoint says whether stage 2 trained it
    upscore_trained = False
    load_path = resume or cfg.load_fcn_path
    checkpoint = None
    if load_path:
        ckpt_path = load_path if ckpt.checkpoint_exists(load_path) else \
            osp.join(data_dir, "logs", load_path, "best")
        checkpoint = ckpt.restore_checkpoint(ckpt_path)
        model.load_state_dict(_merge_params(model.state_dict(),
                                            checkpoint["params"], logger))
        logger.stdout(
            f"loaded checkpoint {ckpt_path} (epoch {checkpoint['epoch']}, "
            f"upscore_trained={checkpoint['upscore_trained']})")
        if checkpoint["skipped_keys"]:
            logger.stdout("  skipped unknown checkpoint keys: "
                          + ", ".join(checkpoint["skipped_keys"]))
        upscore_trained = checkpoint["upscore_trained"]
        # checkpoint['epoch'] is the last *completed* epoch; training resumes
        # after it (the reference re-runs every epoch on resume — train.py:295
        # ignores the restored counter — which we treat as a bug, not parity)
        start_epoch = int(checkpoint["epoch"]) + 1
        start_iteration = int(checkpoint["iteration"])
        best_mean_iu = float(checkpoint["best_mean_iu"])
    elif vgg16_path:
        model.load_state_dict(load_vgg16_into_params(model.state_dict(),
                                                     vgg16_path))
    elif not synthetic and cfg.mode == "train":
        # the reference starts fresh runs from caffe-VGG16
        # (train.py:127-129); the port reads a local copy only
        default_vgg = osp.join(data_dir, "models", "vgg16_from_caffe.pth")
        if osp.exists(default_vgg):
            logger.stdout(f"initializing backbone from {default_vgg}")
            model.load_state_dict(load_vgg16_into_params(
                model.state_dict(), default_vgg))
        else:
            logger.stdout(
                "WARNING: no --vgg16 given and no "
                f"{default_vgg}; the backbone is RANDOMLY INITIALIZED — the "
                "reference always starts from pretrained VGG16 "
                "(train.py:127-129) and results will not be comparable")

    # 4. stage-1 trainer; the reference restores the optimizer state
    # whenever a checkpoint is loaded (train.py:134-135)
    optimizer = make_fcn_optimizer(model, optim=cfg.fcn_optim, lr=cfg.fcn_lr)
    if checkpoint is not None and checkpoint["opt_state"] is not None:
        try:
            optimizer.load_state_dict(checkpoint["opt_state"])
        except ValueError as e:  # another optimizer's layout: fresh state
            logger.stdout("WARNING: checkpoint optimizer state does not "
                          f"match the current optimizer ({e}); "
                          "reinitializing optimizer state")
    fcn_trainer = FCNTrainer(
        cfg=cfg, model=model, optimizer=optimizer,
        train_loader=train_seen_loader, val_loader=val_loader, logger=logger,
        embeddings=embeddings, target_embeddings=target_embeddings,
        start_epoch=start_epoch, start_iteration=start_iteration,
        best_mean_iu=best_mean_iu, upscore_trained=upscore_trained)

    summary = {"log_dir": log_dir}
    if cfg.mode == "train":
        if cfg.fcn_epochs > 0:
            fcn_trainer.train()
        if cfg.seenmask_epochs > 0:
            # stage 2 starts from the best stage-1 weights (train.py:177-179);
            # when this run never wrote a best (fcn_epochs=0 resume into
            # seenmask, or a resumed run that never improved) it falls back
            # to the loaded checkpoint, as the reference's `if not checkpoint`
            best_path = osp.join(log_dir, "best")
            if ckpt.checkpoint_exists(best_path):
                best = ckpt.restore_checkpoint(best_path)
            elif checkpoint is not None:
                best = checkpoint
            else:
                raise FileNotFoundError(
                    f"stage 2 needs a stage-1 checkpoint: no {best_path} and "
                    "no -r/load_fcn_path checkpoint was loaded")
            # stage 1's moments and last gradients go before stage 2 builds
            # its own: the run's peak memory is the larger stage's
            optimizer.state.clear()
            model.zero_grad(set_to_none=True)
            model.load_state_dict(_merge_params(model.state_dict(),
                                                best["params"], logger))
            seenmask_trainer = SeenmaskTrainer(
                cfg=cfg, model=model,
                optimizer=make_seenmask_optimizer(model, lr=cfg.seenmask_lr),
                train_loader=train_loader, val_loader=val_loader,
                logger=logger)
            seenmask_trainer.train(base_checkpoint={
                "epoch": int(best["epoch"]),
                "iteration": int(best["iteration"]),
                "best_mean_iu": float(best["best_mean_iu"]),
                "opt_state": best["opt_state"]})
            summary["seenmask_best_mean_iu"] = seenmask_trainer.best_mean_iu
        summary["best_mean_iu"] = fcn_trainer.best_mean_iu
    elif cfg.mode == "test_fcn":
        summary["mean_iu"] = fcn_trainer.validate(both_fcn_and_seenmask=False)
    elif cfg.mode == "test_all":
        summary["mean_iu"] = fcn_trainer.validate(both_fcn_and_seenmask=True)
    logger.close()
    return summary


def _merge_params(params, loaded, logger=None) -> dict:
    """strict=False load (reference train.py:114): a copy of the state dict
    `params` with every entry of `loaded` whose key and shape match. What
    is not copied is reported through `logger`, so a partial load is never
    silent."""
    out = dict(params)
    skipped = []
    for k, v in loaded.items():
        if k not in out:
            skipped.append(f"{k} (no such key)")
        elif tuple(v.shape) != tuple(out[k].shape):
            skipped.append(f"{k} (shape {tuple(v.shape)} vs "
                           f"{tuple(out[k].shape)})")
        else:
            out[k] = v
    if skipped and logger is not None:
        logger.stdout("WARNING: partial checkpoint load; skipped: "
                      + ", ".join(skipped))
    return out


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-n", "--name", type=str, default=None)
    p.add_argument("-c", "--config", type=int, default=1,
                   choices=sorted(PRESETS.keys()))
    p.add_argument("-dir", "--data_dir", type=str, default="data")
    p.add_argument("-tb", "--tb_dir", type=str, default=None)
    p.add_argument("-m", "--mode", type=str,
                   choices=["train", "test_fcn", "test_all"])
    p.add_argument("-d", "--dataset", type=str, choices=["pascal", "context"])
    p.add_argument("-tu", "--train_unseen", type=str,
                   help="comma-separated unseen class ids for train filtering")
    p.add_argument("-vu", "--val_unseen", type=str)
    p.add_argument("-e", "--embed_dim", type=int,
                   choices=[2, 5, 10, 20, 21, 50, 100, 200, 300])
    p.add_argument("-ve", "--fcn_epochs", type=int)
    p.add_argument("-lr", "--fcn_learning_rate", type=float)
    p.add_argument("-loss", "--fcn_loss", type=str,
                   choices=["cos", "mse", "cross_entropy"])
    p.add_argument("-o", "--fcn_optim", type=str, choices=["sgd", "adam"])
    p.add_argument("-se", "--seenmask_epochs", type=int)
    p.add_argument("-slr", "--seenmask_learning_rate", type=float)
    p.add_argument("-oh", "--one_hot_embed", action="store_true")
    p.add_argument("-fu", "--forced_unseen", action="store_true")
    p.add_argument("-r", "--resume", type=str, default="")
    # extensions of the JAX package
    p.add_argument("--arch", type=str, choices=["fcn32s", "fcn8s"])
    p.add_argument("--batch_size", type=int)
    p.add_argument("--eval_batch_size", type=int)
    p.add_argument("--dtype", type=str, choices=["bfloat16", "float32"])
    p.add_argument("--data_parallel", type=int)
    p.add_argument("--model_parallel", type=int)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (smoke runs without datasets)")
    p.add_argument("--bucket", type=int, default=None,
                   help="static square bucket size (default 512)")
    p.add_argument("--channel_scale", type=float, default=None,
                   help="backbone width multiplier (<1 for smoke tests)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize conv blocks (not ported: raises)")
    p.add_argument("--no_prune_pad", action="store_true",
                   help="disable support-pruned pad-100 blocks (exact fast "
                        "path, on by default)")
    p.add_argument("--chunked_loss", action="store_true",
                   help="per-sample loss memory chunking (larger batches)")
    p.add_argument("--grad_accum", type=int,
                   help="microbatches per train step (larger batches)")
    p.add_argument("--data_echo", type=str, choices=["off", "auto"],
                   help="re-serve resident batches while host-to-device "
                        "copies can't keep up (trainer_fcn.echo_feed; "
                        "default off)")
    p.add_argument("--context_classes", type=int, choices=[33, 59],
                   help="PASCAL-Context label vocabulary: 33 (reference "
                        "parity) or 59 (standard 59-class protocol, "
                        "extension)")
    p.add_argument("--vgg16", type=str, default=None,
                   help="path to a torch VGG16 state dict (.pth)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    import faulthandler
    import signal
    faulthandler.enable()
    if hasattr(signal, "SIGUSR1"):  # live stack dumps: kill -USR1 <pid>
        faulthandler.register(signal.SIGUSR1)
    args = _parse_args(argv)
    overrides = {}
    for src, dst in [("mode", "mode"), ("dataset", "dataset"),
                     ("embed_dim", "embed_dim"), ("fcn_epochs", "fcn_epochs"),
                     ("fcn_learning_rate", "fcn_lr"), ("fcn_loss", "fcn_loss"),
                     ("fcn_optim", "fcn_optim"),
                     ("seenmask_epochs", "seenmask_epochs"),
                     ("seenmask_learning_rate", "seenmask_lr"),
                     ("arch", "arch"),
                     ("batch_size", "batch_size"),
                     ("eval_batch_size", "eval_batch_size"),
                     ("dtype", "compute_dtype"),
                     ("data_parallel", "data_parallel"),
                     ("model_parallel", "model_parallel"),
                     ("channel_scale", "channel_scale"),
                     ("grad_accum", "grad_accum"),
                     ("data_echo", "data_echo"),
                     ("context_classes", "context_classes")]:
        v = getattr(args, src)
        if v is not None:
            overrides[dst] = v
    for flag in ["one_hot_embed", "forced_unseen", "remat", "chunked_loss"]:
        if getattr(args, flag):
            overrides[flag] = True
    if args.no_prune_pad:
        overrides["prune_pad"] = False
    for lst in ["train_unseen", "val_unseen"]:
        v = getattr(args, lst)
        if v:
            overrides[lst] = tuple(int(x) for x in v.split(","))
    if args.bucket is not None:
        overrides["bucket"] = (args.bucket, args.bucket)
    if args.resume:
        overrides["load_fcn_path"] = args.resume

    cfg = get_config(args.config, **overrides)
    return run_experiment(cfg, preset=args.config, name=args.name,
                          data_dir=args.data_dir, tb_dir=args.tb_dir,
                          synthetic=args.synthetic, vgg16_path=args.vgg16,
                          resume=args.resume, device=args.device)


if __name__ == "__main__":
    main()
