"""Experiment runner: config -> data -> model -> two-stage training / testing
(the JAX package's cli/train.py).

CLI-compatible with the reference entry point (train.py:16-200):
``python -m zeroshotsemanticsegmentation_tpu_torch.cli.train -c 14`` runs
the 8/2/10 PASCAL zero-shot SZN pipeline end to end on the card (FCN stage,
then seenmask stage, checkpoints, CSV/TB logs); ``--synthetic -ve 1 -se 1``
is a smoke run without datasets. ``--device cpu`` runs the kernels' plain
versions on the CPU; without a card and without it, the run raises.

With ``--data_parallel`` / ``--model_parallel`` above 1 the run is one
process per rank of that mesh, started by ``torchrun`` (its RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    torchrun --nproc_per_node 2 -m \\
        zeroshotsemanticsegmentation_tpu_torch.cli.train -c 14 --data_parallel 2

Each rank runs on the card LOCAL_RANK names (``--device cuda``, over
nccl), or all on the one ``--device`` given (``cuda:0`` or ``cpu``, over
gloo: nccl refuses two ranks on one card). Rank 0 alone writes logs and
checkpoints.

As the JAX CLI does, a run on real data fetches the missing dataset
archives at startup (`data.download`), and a fresh ``train`` run without
``--vgg16`` fetches the caffe VGG16 into ``<data_dir>/models/``, md5-checked
(`models.pretrained`); on a mesh rank 0 fetches while the others wait. A
failed fetch logs a warning and the run goes on: a missing dataset then
raises its constructor's error, and a missing VGG16 leaves a random backbone
with a warning. Routine checkpoint saves overlap training
(`train.checkpoint`); the run returns with every file on disk.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib.util
import os
import os.path as osp
import time

import numpy as np
import torch
import torch.distributed as dist

from zeroshotsemanticsegmentation_tpu_torch import resolve_device
from zeroshotsemanticsegmentation_tpu_torch.configs import (
    PRESETS, get_config, run_name)
from zeroshotsemanticsegmentation_tpu_torch.configs.presets import (
    check_world_size)
from zeroshotsemanticsegmentation_tpu_torch.data import (
    BatchLoader, PascalContext, PascalVOC, SyntheticDataset,
    load_class_embeddings)
from zeroshotsemanticsegmentation_tpu_torch.data.download import (
    download_context, download_pascal)
from zeroshotsemanticsegmentation_tpu_torch.data.native import NativeLoader
from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.models.pretrained import (
    cached_download_vgg16)
from zeroshotsemanticsegmentation_tpu_torch.models.vgg_import import (
    load_vgg16_into_params)
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    init_distributed, make_mesh, opt_param_names, shard_model,
    shard_opt_state, shard_params)
from zeroshotsemanticsegmentation_tpu_torch.train import (
    FCNTrainer, SeenmaskTrainer, make_fcn_optimizer, make_seenmask_optimizer)
from zeroshotsemanticsegmentation_tpu_torch.train import checkpoint as ckpt
from zeroshotsemanticsegmentation_tpu_torch.utils import RunLogger
from zeroshotsemanticsegmentation_tpu_torch.utils.logging import _TZ


# where a failed fetch sends the user: the README's section on the port's
# datasets and weights
_PROVISIONING = "README.md, 'Datasets and VGG16 weights' in the port's section"


def _fetch(fetch, mesh) -> Exception | None:
    """`fetch()` on rank 0 (every rank waits for it on a mesh); its
    exception, or None."""
    err = None
    if mesh is None or mesh.rank == 0:
        try:
            fetch()
        except Exception as e:  # noqa: BLE001 — logged by the caller
            err = e
    if mesh is not None:
        dist.barrier()
    return err


def _ensure_datasets(cfg, data_dir, logger, mesh=None) -> None:
    """The JAX CLI's startup fetch of missing dataset archives (reference
    train.py:71 calls download(data_dir)); archives already present are
    skipped. A failed fetch is logged and the dataset constructor then
    raises its usual error."""
    fetch = download_pascal if cfg.dataset == "pascal" else download_context
    err = _fetch(lambda: fetch(data_dir), mesh)
    if err is not None:
        logger.stdout(f"WARNING: dataset auto-download failed ({err!r}); "
                      "expecting pre-provisioned data under "
                      f"{osp.join(data_dir, cfg.dataset)} "
                      f"(see {_PROVISIONING})")


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
                   verbose: bool = True, device: str = "cuda",
                   mesh=None) -> dict:
    """Build and run one experiment on `device`; returns a summary dict.

    Mirrors reference main() wiring: FCN trains on the *train_seen* loader,
    the seenmask stage on the *train* loader (train.py:144,185 — the
    asymmetry is the method); test modes only validate.

    `mesh` (`parallel.mesh`, data_parallel x model_parallel ranks): every
    rank calls this; the model is built and loaded whole, then sharded, and
    runs on the mesh's device; rank 0 alone writes the log directory (its
    name, with its time stamp, is rank 0's).
    """
    check_world_size(cfg, 1 if mesh is None else mesh.size)
    dev = resolve_device(device) if mesh is None else mesh.device
    main_rank = mesh is None or mesh.rank == 0
    if cfg.num_viz > 0 and importlib.util.find_spec("PIL") is None:
        # fail before training, not at the first validation
        raise RuntimeError(
            f"num_viz={cfg.num_viz}: the viz tiles are written with Pillow, "
            "which is not installed; install it or set num_viz=0")
    log_dir = log_dir or osp.join(data_dir, "logs", run_name(
        preset, cfg, name=name, now=_start_time(mesh)))
    logger = RunLogger(log_dir, tb_dir=tb_dir, verbose=verbose,
                       enabled=main_rank)
    logger.dump_config(dataclasses.asdict(cfg))

    # 1. data
    if not synthetic:
        _ensure_datasets(cfg, data_dir, logger, mesh)
    train_ds, train_seen_ds, val_ds = _build_datasets(
        cfg, data_dir=data_dir, synthetic=synthetic)
    # the native decoder wherever the dataset has one (the JAX CLI's
    # default); on the card it writes into pinned host memory
    mk_loader = lambda ds, bs, sh: BatchLoader(  # noqa: E731
        ds, bs, bucket_hw=tuple(cfg.bucket), shuffle=sh, seed=cfg.seed,
        compact=cfg.compact_feed, pin_memory=dev.type == "cuda",
        device=dev)
    train_loader = mk_loader(train_ds, cfg.batch_size, True)
    train_seen_loader = mk_loader(train_seen_ds, cfg.batch_size, True)
    val_loader = mk_loader(val_ds, cfg.eval_batch_size, False)
    decoder = f"the {train_loader.decoder} decoder"
    if train_loader.decoder == "native":
        decoder += (f" (zss_loader; JPEG by "
                    f"{NativeLoader.get().build_info()['jpeg']}, PNG and MAT "
                    "by its own readers over zlib)")
    logger.stdout(f"data: {cfg.dataset if not synthetic else 'synthetic'} "
                  f"decoded by {decoder}")

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
    # wherever the model is on the card, on a mesh too: each rank runs them
    # on its own rows (the JAX CLI turns them off under a mesh only because
    # GSPMD cannot partition a Pallas body)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32
    fb1 = cfg.fused_block1 == "on" or (cfg.fused_block1 == "auto"
                                       and dev.type == "cuda")
    model_cls = FCN8s if cfg.arch == "fcn8s" else FCN32s
    model = model_cls(cfg.head_channels, dtype=dtype,
                      channel_scale=cfg.channel_scale, remat=cfg.remat,
                      prune_pad=cfg.prune_pad, fused_block1=fb1,
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
        checkpoint = ckpt.restore_checkpoint(ckpt_path, model.state_dict())
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
        # (train.py:127-129), fetched and md5-checked on first use
        default_vgg = osp.join(data_dir, "models", "vgg16_from_caffe.pth")
        if not osp.exists(default_vgg):
            err = _fetch(lambda: cached_download_vgg16(data_dir), mesh)
            if err is not None:
                logger.stdout(f"WARNING: VGG16 auto-download failed "
                              f"({err!r}; see {_PROVISIONING})")
        if osp.exists(default_vgg):
            logger.stdout(f"initializing backbone from {default_vgg}")
            model.load_state_dict(load_vgg16_into_params(
                model.state_dict(), default_vgg))
        else:
            logger.stdout(
                "WARNING: no --vgg16 given and no cached "
                f"{default_vgg}; the backbone is RANDOMLY INITIALIZED — the "
                "reference always starts from pretrained VGG16 "
                "(train.py:127-129) and results will not be comparable")

    # 4. stage-1 trainer; the reference restores the optimizer state
    # whenever a checkpoint is loaded (train.py:134-135). On a mesh the
    # model loaded whole is sharded first, and the optimizer built on its
    # shards.
    if mesh is not None:
        shard_model(model, mesh)
    optimizer = make_fcn_optimizer(model, optim=cfg.fcn_optim, lr=cfg.fcn_lr)
    if checkpoint is not None and checkpoint["opt_state"] is not None:
        try:
            opt_state = checkpoint["opt_state"]
            if mesh is not None:
                opt_state = shard_opt_state(
                    opt_state, opt_param_names(model, optimizer), mesh)
            optimizer.load_state_dict(opt_state)
        except (ValueError, IndexError) as e:
            # another optimizer's layout: fresh state
            logger.stdout("WARNING: checkpoint optimizer state does not "
                          f"match the current optimizer ({e}); "
                          "reinitializing optimizer state")
    fcn_trainer = FCNTrainer(
        cfg=cfg, model=model, optimizer=optimizer,
        train_loader=train_seen_loader, val_loader=val_loader, logger=logger,
        embeddings=embeddings, target_embeddings=target_embeddings,
        start_epoch=start_epoch, start_iteration=start_iteration,
        best_mean_iu=best_mean_iu, upscore_trained=upscore_trained,
        mesh=mesh)

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
            ckpt.finish_pending(mesh)
            if ckpt.checkpoint_exists(best_path):
                best = ckpt.restore_checkpoint(best_path, model.state_dict(),
                                               mesh=mesh)
            elif checkpoint is not None:
                best = checkpoint
                if mesh is not None:  # loaded whole, before the sharding
                    best = {**best,
                            "params": shard_params(best["params"], mesh)}
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
                logger=logger, mesh=mesh)
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
    # routine saves overlap training; every file is on disk before the run
    # returns (a caller may read or delete the log directory at once)
    ckpt.finish_pending(mesh)
    logger.close()
    return summary


def _start_time(mesh) -> datetime.datetime | None:
    """The run's start time for its log directory's name: on a mesh rank
    0's, broadcast, so every rank names the same directory."""
    if mesh is None:
        return None
    t = torch.tensor([time.time()], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, 0)
    return datetime.datetime.fromtimestamp(t.item(), _TZ)


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
                   help="rematerialize conv blocks (larger train batches)")
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
                        "kernels' plain versions); on a mesh `cuda` is "
                        "each rank's LOCAL_RANK card, and an explicit "
                        "device is shared by every rank (over gloo)")
    return p.parse_args(argv)


# a collective that waits longer fails the run: a full-width gradient
# all-reduce takes seconds over gloo, a rank's validation and checkpoint
# write some more
DIST_TIMEOUT_S = 600.0


def _mesh_from_env(cfg, args):
    """The data_parallel x model_parallel mesh of this torchrun rank (the
    JAX CLI builds its mesh from the same flags)."""
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
    if None in env.values():
        raise RuntimeError(
            f"--data_parallel {cfg.data_parallel} --model_parallel "
            f"{cfg.model_parallel} runs one process per rank: start it "
            f"with torchrun --nproc_per_node "
            f"{cfg.data_parallel * cfg.model_parallel} (RANK / WORLD_SIZE "
            "are not set)")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    check_world_size(cfg, world)
    # one card a rank takes nccl; ranks sharing a device (an explicit
    # `cuda:0` or `cpu`) take gloo, since nccl refuses two ranks on a card
    shared = args.device != "cuda"
    devices = [torch.device(args.device)] * world if shared else None
    init_distributed("gloo" if shared else "nccl", "env://", rank, world,
                     timeout=DIST_TIMEOUT_S)
    return make_mesh(cfg.data_parallel, cfg.model_parallel, devices=devices)


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
    mesh = None
    if cfg.data_parallel * cfg.model_parallel > 1:
        mesh = _mesh_from_env(cfg, args)
    try:
        return run_experiment(cfg, preset=args.config, name=args.name,
                              data_dir=args.data_dir, tb_dir=args.tb_dir,
                              synthetic=args.synthetic,
                              vgg16_path=args.vgg16, resume=args.resume,
                              device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
