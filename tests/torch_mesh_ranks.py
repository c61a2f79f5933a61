"""Rank functions of the port's mesh tests (tests/test_torch_parallel.py and
the card's cases in tests/test_torch_cuda.py).

A spawned process imports the module that defines its target, so this
module imports the port and never JAX. `mesh_jobs` is the rank function
`parallel.dryrun.spawn` runs: it joins the gloo group, lays out the mesh
and runs the named jobs on it in turn; each job also runs without a mesh
(`mesh=None`) in the calling process for the one-device reference.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch
import torch.distributed as dist

from zeroshotsemanticsegmentation_tpu_torch.models import FCN8s, FCN32s
from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    all_reduce_grads, gather_params, init_distributed, make_mesh, make_multislice_mesh,
    shard_model)
from zeroshotsemanticsegmentation_tpu_torch.serving import make_szn_predictor
from zeroshotsemanticsegmentation_tpu_torch.train import (
    TrainState, make_fcn_optimizer, make_fcn_train_step, make_szn_eval_step)

SCALE = 1 / 16  # tests/test_parallel.py's width


def build_model(sd, *, dropout=0.0, mesh=None, device="cpu"):
    """An 8-channel FCN32s holding the full state dict `sd`, sharded over
    `mesh`."""
    model = FCN32s(8, channel_scale=SCALE, dropout_rate=dropout,
                   device=device)
    model.load_state_dict(sd)
    return model if mesh is None else shard_model(model, mesh)


def _gathered(tensors: dict, mesh) -> dict:
    full = tensors if mesh is None else gather_params(tensors, mesh)
    return {k: v.detach().cpu().clone() for k, v in full.items()}


def train_job(mesh, sd, batch, embed, *, fused_tail=False, dropout=0.0,
              steps=2, grad_accum=1, lr=1e-3, device="cpu"):
    """`steps` Adam steps of the stage-1 step (generator seeded 100 + i
    before step i): each step's aux, the parameters after them (full), the
    last step's gradients (full, and this rank's own)."""
    model = build_model(sd, dropout=dropout, mesh=mesh, device=device)
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=lr))
    step = make_fcn_train_step(loss_name="cos", num_classes=embed.shape[0],
                               embeddings=embed, fused_tail=fused_tail,
                               grad_accum=grad_accum, mesh=mesh)
    dev = next(model.parameters()).device
    auxes = []
    for i in range(steps):
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        state, aux = step(state, batch, gen)
        auxes.append({k: v.detach().cpu().numpy() for k, v in aux.items()})
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    return {"aux": auxes, "params": _gathered(model.state_dict(), mesh),
            "grads": _gathered(grads, mesh),
            "local_grads": {k: v.detach().cpu().clone()
                            for k, v in grads.items()}}


def eval_job(mesh, sd, batch, embed, *, unseen, fused=False, device="cpu"):
    """One SZN eval step: loss_sum, hists, score_sum, and pred (this
    rank's rows)."""
    model = build_model(sd, mesh=mesh, device=device)
    step = make_szn_eval_step(loss_name="cos", num_classes=embed.shape[0],
                              embeddings=embed, all_unseen_vec=unseen,
                              val_unseen_vec=unseen, fused=fused, mesh=mesh)
    out = step(model, batch)
    return {k: v.cpu().numpy() for k, v in out.items()}


def serve_job(mesh, sd, batch, embed, *, unseen_classes, device="cpu",
              route="pristine", spatial=False, int8=False, images=None,
              sd8=None, dtype=torch.float32):
    """The predictor's labels for `images` (default the batch's; the
    global batch on every rank). `route`: "pristine" (FCN-32s, the fused
    gate), "trained" (FCN-32s with a seeded perturbation of its seenmask
    upscore: K1 twice and the ConvTranspose) or "fcn8s" (FCN-8s weights
    `sd8`, default seeded ones: the unfused route). `spatial` splits the
    height over 'data'; `int8` takes the int8 forward."""
    if route == "fcn8s":
        model = FCN8s(embed.shape[1], channel_scale=SCALE, device=device,
                      dtype=dtype,
                      generator=torch.Generator().manual_seed(3))
        sd = sd8
    else:
        model = FCN32s(embed.shape[1], channel_scale=SCALE, device=device,
                       dtype=dtype)
    if route == "trained":
        sd = trained_gate(sd)
    predict = make_szn_predictor(model, sd, embed, unseen_classes,
                                 device=device, mesh=mesh, spatial=spatial,
                                 int8=int8)
    return predict(batch["image"] if images is None else images
                   ).cpu().numpy()


def trained_gate(sd):
    """`sd` with a seeded perturbation of its seenmask upscore."""
    up = sd["seenmask_upscore.weight"]
    return {**sd, "seenmask_upscore.weight": up + 0.05 * torch.randn(
        up.shape, generator=torch.Generator().manual_seed(7)).to(up.device)}


def reduce_job(mesh, sd, batch, embed, *, in_place_numel, device="cpu"):
    """`all_reduce_grads` on three parameters whose gradients are
    (data rank + 1) x a fixed pattern (the last one not contiguous): the
    gradients after it."""
    params = []
    for shape in ((5,), (64, 3), (7, 6)):
        p = torch.nn.Parameter(torch.zeros(shape, device=device))
        base = torch.arange(p.numel(), dtype=torch.float32,
                            device=device).reshape(shape) + 0.5
        p.grad = (mesh.data_rank + 1) * base
        params.append(p)
    params[-1].grad = params[-1].grad.t().contiguous().t()
    all_reduce_grads(params, mesh, in_place_numel=in_place_numel)
    return [p.grad.cpu().clone() for p in params]


JOBS = {"train": train_job, "eval": eval_job, "serve": serve_job,
        "reduce": reduce_job}


def mesh_jobs(rank, world, init_method, sizes, devices, sd, batch, embed,
              jobs, backend="gloo"):
    """The rank function: the mesh of `sizes` ((data, model) or (slices,
    data, model)) over `backend`, `devices[r]` rank r's device, then each
    job of `jobs` ({name: (kind, kwargs)}) on this rank's device; returns
    {"coords", "data_rank", "model_rank", name: result}."""
    # full fp32 on a card, as the one-device reference in the caller
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend, init_method, rank, world, timeout=120)
    mesh = (make_multislice_mesh(*sizes, devices=devices) if len(sizes) == 3
            else make_mesh(*sizes, devices=devices))
    out = {"coords": mesh.coords, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank}
    for name, (kind, kw) in jobs.items():
        out[name] = JOBS[kind](mesh, sd, batch, embed,
                               **{"device": mesh.device, **kw})
    dist.barrier()
    dist.destroy_process_group()
    return out


def experiment_job(rank, world, init_method, tmp, sizes):
    """`run_experiment` on a gloo mesh of `sizes` (the JAX package's
    test_run_experiment_end_to_end_on_mesh): two epochs and the seenmask
    stage into `<tmp>/mesh`, then a resume from its checkpoint to a third
    epoch into `<tmp>/mesh2`; returns both summaries."""
    from zeroshotsemanticsegmentation_tpu_torch.cli.train import (
        run_experiment)
    from zeroshotsemanticsegmentation_tpu_torch.configs import Config

    def cfg_with(**kw):
        base = dict(
            mode="train", dataset="pascal", embed_dim=20, fcn_epochs=2,
            fcn_lr=1e-3, fcn_loss="cos", fcn_optim="adam",
            seenmask_epochs=1, train_unseen=(1, 13), val_unseen=(6, 7),
            batch_size=4, eval_batch_size=4, bucket=(64, 64),
            compute_dtype="float32", channel_scale=1 / 32, num_viz=1,
            data_parallel=sizes[0], model_parallel=sizes[1])
        base.update(kw)
        return Config(**base)

    init_distributed("gloo", init_method, rank, world, timeout=120)
    mesh = make_mesh(*sizes, devices=["cpu"] * world)
    first = run_experiment(cfg_with(), preset=0, data_dir=tmp,
                           log_dir=osp.join(tmp, "mesh"), synthetic=True,
                           verbose=False, mesh=mesh, device="cpu")
    second = run_experiment(
        cfg_with(fcn_epochs=3, seenmask_epochs=0), preset=0, data_dir=tmp,
        log_dir=osp.join(tmp, "mesh2"), synthetic=True, verbose=False,
        mesh=mesh, device="cpu", resume=osp.join(tmp, "mesh", "checkpoint"))
    dist.destroy_process_group()
    return {"first": first, "second": second}


def np_batch(rng: np.random.RandomState, batch: int, hw: int = 64,
             classes: int = 8) -> dict:
    """tests/test_parallel.py's `build` batch, as numpy arrays."""
    return {"image": rng.randn(batch, hw, hw, 3).astype(np.float32),
            "label": rng.randint(-1, classes, (batch, hw, hw)).astype(
                np.int32),
            "sizes": np.full((batch, 2), hw, np.int32),
            "num_real": np.int32(batch)}
