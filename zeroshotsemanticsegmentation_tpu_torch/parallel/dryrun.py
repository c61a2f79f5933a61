"""Multi-process dry run: the full-width FCN-32s sharded DP x TP over n CPU
processes (the JAX package's parallel/dryrun.py).

`run(n)` spawns n processes joined over gloo, lays them out as a ('data',
'model') mesh (model 2 where n is even and >= 4), takes ONE Adam step and
one SZN eval step of the full-width model at `channel_scale` 0.5 on a
64x64 bucket, one sample per data shard, and asserts that everything is
finite. A stalled collective fails fast: the process group's timeout, the
bound on the second step's time (`max_step_s`, as in the JAX run) and a
deadline on the whole spawn. `run_all` adds a 2-slice ('slice', 'data',
'model') mesh at `channel_scale` 0.25 and, in place of the JAX package's
compile of the full-width program, `check_full_width`: the channel_scale
1.0 parameters and Adam state built on the `meta` device (no memory) and
sharded for every model rank, each shard's shape held against `TP_RULES`.

    python -m zeroshotsemanticsegmentation_tpu_torch.parallel.dryrun 8

`spawn` is the launcher the dry run, the tests and the GPU smoke script
share: each rank's function gets (rank, world, init_method, *args) and its
return value comes back to the caller.
"""

from __future__ import annotations

import os
import os.path as osp
import sys
import tempfile
import time

import numpy as np
import torch

from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
    TP_RULES, Mesh, shard_model, shard_opt_state, shard_shape)


def _rank_main(rank: int, fn, world: int, tmp: str, args) -> None:
    torch.set_num_threads(1)
    out = fn(rank, world, "file://" + osp.join(tmp, "store"), *args)
    torch.save(out, osp.join(tmp, f"rank{rank}.pt"))


def spawn(fn, world: int, args=(), timeout_s: float = 600.0) -> list:
    """Run `fn(rank, world, init_method, *args)` in `world` fresh processes
    (a `file://` store in a temporary directory for `init_distributed`) and
    return their return values, by rank. A rank that raises fails the
    call; past `timeout_s` every rank is killed and the call fails."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.spawn(_rank_main, args=(fn, world, tmp, tuple(args)),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks still running after {timeout_s:.0f} "
                        "s: a collective has likely stalled")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(osp.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def _layout(n: int, slices: int) -> tuple:
    """(axis names, sizes) of the dry run's mesh for n processes."""
    model = 2 if n % 2 == 0 and n >= 4 else 1
    if slices > 1:
        if n % (slices * model):
            raise ValueError(f"{n} processes can't split into {slices} "
                             f"slices x {model} model")
        return ("slice", "data", "model"), (slices, n // (slices * model),
                                            model)
    return ("data", "model"), (n // model, model)


def _dryrun_rank(rank: int, world: int, init_method: str, sizes: tuple,
                 channel_scale: float, bucket: int, max_step_s: float
                 ) -> dict:
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh, make_multislice_mesh)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step,
        make_szn_eval_step)
    import torch.distributed as dist

    init_distributed("gloo", init_method, rank, world,
                     timeout=max_step_s + 60)
    devices = ["cpu"] * world
    mesh = (make_multislice_mesh(*sizes, devices=devices) if len(sizes) == 3
            else make_mesh(*sizes, devices=devices))
    batch_size = mesh.data_size  # one sample per data shard
    rng = np.random.RandomState(0)
    x = rng.randn(batch_size, bucket, bucket, 3).astype(np.float32) * 40
    label = rng.randint(-1, 21, (batch_size, bucket, bucket)).astype(np.int32)
    embed = rng.randn(21, 20).astype(np.float32)
    embed /= np.linalg.norm(embed, axis=1, keepdims=True)
    batch = {"image": x, "label": label,
             "sizes": np.full((batch_size, 2), bucket, np.int32),
             "num_real": batch_size}
    model = FCN32s(20, channel_scale=channel_scale,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    shard_model(model, mesh)
    state = TrainState.create(model, make_fcn_optimizer(model, optim="adam",
                                                        lr=1e-5))
    step = make_fcn_train_step(loss_name="cos", num_classes=21,
                               embeddings=embed, mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    state, aux = step(state, batch, gen)
    loss = float(aux["loss"])
    assert np.isfinite(loss), f"non-finite train loss {loss}"
    # the second step's time bounds the collectives' health: a stall shows
    # as a fast, attributable failure instead of the spawn's deadline
    t0 = time.perf_counter()
    state, aux = step(state, batch, gen)
    loss = float(aux["loss"])
    step_s = time.perf_counter() - t0
    assert np.isfinite(loss), f"non-finite train loss {loss}"
    assert state.step == 2
    assert step_s < max_step_s, (
        f"a sharded step took {step_s:.0f} s (bound {max_step_s:.0f} s): "
        "collectives are likely stalled")
    uv = unseen_mask_vector(21, [1, 13])
    eval_step = make_szn_eval_step(loss_name="cos", num_classes=21,
                                   embeddings=embed, all_unseen_vec=uv,
                                   val_unseen_vec=uv, mesh=mesh)
    out = eval_step(model, batch)
    eval_loss = float(out["loss_sum"])
    assert np.isfinite(eval_loss), f"non-finite eval loss {eval_loss}"
    result = {"processes": world, "mesh": dict(mesh.shape),
              "train_loss": loss, "eval_loss": eval_loss,
              "step_s": step_s,
              "fc6_shard": tuple(model.fc6.weight.shape),
              "fc7_shard": tuple(model.fc7.weight.shape)}
    dist.destroy_process_group()
    return result


def run(n: int, *, channel_scale: float = 0.5, bucket: int = 64,
        slices: int = 1, max_step_s: float = 300.0) -> dict:
    """One DP x TP Adam step and one SZN eval step over n gloo processes;
    returns rank 0's summary."""
    names, sizes = _layout(n, slices)
    t0 = time.perf_counter()
    results = spawn(_dryrun_rank, n, (sizes, channel_scale, bucket,
                                      max_step_s),
                    timeout_s=4 * max_step_s + 120)
    losses = {r["train_loss"] for r in results}
    assert len(losses) == 1, f"ranks disagree on the step's loss: {losses}"
    result = {**results[0], "axes": names,
              "wall_s": time.perf_counter() - t0}
    print(f"dryrun OK: {result}", flush=True)
    return result


def check_full_width(n: int) -> dict:
    """The full-width (channel_scale 1.0) FCN-32s parameters and Adam
    state on the `meta` device, sharded for each model rank of n processes'
    mesh: every shard's shape is the one `TP_RULES` gives. Returns the
    per-rank parameter and Adam bytes."""
    from zeroshotsemanticsegmentation_tpu_torch.models import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.parallel.mesh import (
        opt_param_names)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        make_fcn_optimizer)

    names, sizes = _layout(n, 1)
    m = sizes[-1]
    full = None
    per_rank = {}
    for mr in range(m):
        with torch.device("meta"):
            model = FCN32s(20, device="meta")
        full = full or {k: tuple(v.shape)
                        for k, v in model.state_dict().items()}
        layout = Mesh(names, sizes, mr, "meta")
        shard_model(model, layout)
        opt = make_fcn_optimizer(model, optim="adam", lr=1e-5)
        pnames = opt_param_names(model, opt)
        params = dict(model.named_parameters())
        # Adam's state as a restore meets it: full moments, then sharded
        state = {"state": {i: {"step": torch.zeros(()),
                               "exp_avg": torch.empty(full[k], device="meta"),
                               "exp_avg_sq": torch.empty(full[k],
                                                         device="meta")}
                           for i, k in enumerate(pnames)},
                 "param_groups": opt.state_dict()["param_groups"]}
        state = shard_opt_state(state, pnames, layout)
        for k, shape in full.items():
            got = tuple(model.state_dict()[k].shape)
            want = shard_shape(k, shape, m)
            assert got == want, f"{k}: shard {got}, TP_RULES give {want}"
        for i, k in enumerate(pnames):
            for moment in ("exp_avg", "exp_avg_sq"):
                got = tuple(state["state"][i][moment].shape)
                assert got == tuple(params[k].shape), (
                    f"{k} {moment}: shard {got} vs parameter "
                    f"{tuple(params[k].shape)}")
        assert model.fc6.weight.shape[0] == 4096 // m
        assert model.fc7.weight.shape[1] == 4096 // m
        nbytes = sum(p.numel() * 4 for p in params.values())
        per_rank[mr] = {"param_bytes": nbytes, "adam_bytes": 2 * nbytes}
    out = {"full_width_shards": "ok", "mesh": dict(zip(names, sizes)),
           "tp_keys": sorted(TP_RULES), "per_model_rank": per_rank}
    print(f"full-width shards checked for {n} processes: {out}", flush=True)
    return out


def run_all(n: int) -> dict:
    """The single-slice DP x TP run at 0.5 width, a 2-slice hybrid-mesh run
    at 0.25 width (where n divides by 4), then the full-width shard check."""
    result = run(n)
    if n >= 4 and n % 4 == 0:
        result["multislice"] = run(n, slices=2, channel_scale=0.25)
    result["full_width"] = check_full_width(n)
    return result


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    if len(sys.argv) > 2:
        run(n, slices=int(sys.argv[2]))
    else:
        run_all(n)
