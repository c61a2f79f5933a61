#!/usr/bin/env python
"""Full-width fp32 lockstep of the port against the JAX package, on the CPU.

The port's own steps (`train.steps.make_fcn_train_step`,
`make_seenmask_train_step`, `make_szn_eval_step`, their kernels through
their plain versions) run beside the JAX package's steps from the same
weights (`models.jax_weights.load_jax_params`) on the same batches, stage
by stage as `scripts/parity_evidence.py`'s `run_lockstep` runs the JAX
package beside the torch oracle:

  adam    stage 1, Adam lr 1e-5, cosine loss (config 14), from PRNGKey(0)
  sgd     stage 1, SGD lr 1e-6, summed cross-entropy (config 1), from
          PRNGKey(1); independent of the others
  stage2  the seenmask head, Adam lr 1e-3, on adam's trained weights
  eval    the full-SZN eval (test_all) on stage2's weights: the overall,
          seen and unseen metric quadruples

Data: `RandomState(42)` draws the embeddings, then each stage's batches in
the order above (adam, sgd, stage2, then eval's max(6, steps // 4)),
whichever stages run, so a stage sees the same batches alone as in the
whole run and as in the JAX record. 10% of the labels are -1.

The bars are the JAX script's, unchanged (`BARS`); each stage asserts its
own as it ends. Both sides run single-threaded: multithreaded convolution
reductions change the fp32 summation order enough for 25 Adam steps to
amplify it.

    python tests/torch_parity_lockstep.py [--scale 1.0] [--size 128]
        [--steps 25] [--stages adam,sgd,stage2,eval] [--out FILE]

writes (merges, stage by stage) `docs/parity_torch/lockstep.json`; stages
that need another run it too (eval needs stage2, stage2 needs adam). Two
processes may run `--stages sgd` and `--stages eval` at once into the same
file.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import os.path as osp
import sys
import time

import numpy as np

_HERE = osp.dirname(osp.abspath(__file__))
_REPO = osp.dirname(_HERE)
OUT = osp.join(_REPO, "docs", "parity_torch", "lockstep.json")

N_CLASS = 21
TRAIN_UNSEEN = (1, 13)
VAL_UNSEEN = (6, 7, 10, 14, 15, 16, 17, 18, 19, 20)  # config 14
STAGES = ("adam", "sgd", "stage2", "eval")
NEEDS = {"adam": (), "sgd": (), "stage2": ("adam",), "eval": ("stage2",)}
LRS = {"adam": 1e-5, "sgd": 1e-6, "stage2": 1e-3}
FROZEN = ("seenmask_score", "seenmask_upscore")  # untouched by stage 1

# scripts/parity_evidence.py:55-370, unchanged
BARS = {"loss_rel": 1e-3, "flip_frac": 0.005, "adam_global": 5e-2,
        "sgd_global": 5e-3, "stage2_head": 5e-2, "eval_loss_rel": 1e-3,
        "metrics": 5e-3}


def _closure(stages) -> list:
    """`stages` with the stages they need, in run order."""
    want = set()

    def add(s):
        if s not in NEEDS:
            raise ValueError(f"unknown stage {s!r}; choose from {STAGES}")
        want.add(s)
        for d in NEEDS[s]:
            add(d)
    for s in stages:
        add(s)
    return [s for s in STAGES if s in want]


def _host() -> str:
    """The CPU's model name and core count, for the record."""
    name = "unknown CPU"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} cores"


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _deltas(jax_end, jax_init, port_end, skip=()):
    """Per-leaf and global rel-L2 of the port's end-state parameter delta
    against the JAX one; leaves named "<module>/<kernel|bias>" as in the
    JAX record. Deltas are taken in the port's layout (the norms do not
    depend on it). `skip`: modules left out of the global and the worst."""
    per_leaf, worst = {}, {"rel_l2": 0.0, "name": ""}
    num = den = 0.0
    for key, init in jax_init.items():
        module, kind = key.split(".")
        name = f"{module}/{'kernel' if kind == 'weight' else 'bias'}"
        b = port_end[key].numpy() - init.numpy()
        diff = float(np.sum(np.square(jax_end[key].numpy() - init.numpy()
                                      - b, dtype=np.float64)))
        norm = float(np.sum(np.square(b, dtype=np.float64)))
        rel = (diff / max(norm, 1e-24)) ** 0.5
        per_leaf[name] = round(rel, 7)
        if module in skip:
            continue
        num += diff
        den += norm
        if rel > worst["rel_l2"]:
            worst = {"rel_l2": rel, "name": name}
    return per_leaf, worst, (num / max(den, 1e-24)) ** 0.5


def check(stage: str, r: dict) -> None:
    """Assert the JAX script's bars on one stage's report."""
    if stage in ("adam", "sgd", "stage2"):
        assert r["max_loss_rel"] < BARS["loss_rel"], (stage, r)
    if stage == "adam":
        assert r["max_pred_flip_frac"] <= BARS["flip_frac"], r
        assert r["global_delta_rel_l2"] <= BARS["adam_global"], r
    elif stage == "sgd":
        assert r["global_delta_rel_l2"] <= BARS["sgd_global"], r
    elif stage == "stage2":
        assert r["head_delta_global_rel_l2"] <= BARS["stage2_head"], r
    elif stage == "eval":
        assert r["val_loss_rel"] < BARS["eval_loss_rel"], r
        for g in r["metrics"].values():
            np.testing.assert_allclose(g["port"], g["jax"],
                                       rtol=BARS["metrics"],
                                       atol=BARS["metrics"], equal_nan=True)


def run_lockstep(scale: float, size: int, steps: int,
                 stages=STAGES) -> dict:
    """Run `stages` (and what they need) at `channel_scale=scale`, `size`²
    single images, `steps` steps each; returns the report (each stage's
    bars already asserted)."""
    import jax
    import jax.numpy as jnp
    import torch

    from zeroshotsemanticsegmentation_tpu.models import FCN32s as JFCN32s
    from zeroshotsemanticsegmentation_tpu.ops import (
        hist_to_metrics as j_hist_to_metrics)
    from zeroshotsemanticsegmentation_tpu.train import (
        make_fcn_optimizer as j_fcn_optimizer)
    from zeroshotsemanticsegmentation_tpu.train import (
        make_seenmask_optimizer as j_seenmask_optimizer)
    from zeroshotsemanticsegmentation_tpu.train import steps as j_steps
    from zeroshotsemanticsegmentation_tpu.train.state import (
        TrainState as JTrainState)
    from zeroshotsemanticsegmentation_tpu_torch.models.fcn32s import FCN32s
    from zeroshotsemanticsegmentation_tpu_torch.models.jax_weights import (
        load_jax_params, state_dict_from_jax_params)
    from zeroshotsemanticsegmentation_tpu_torch.ops.metrics import (
        hist_to_metrics, unseen_mask_vector)
    from zeroshotsemanticsegmentation_tpu_torch.train import (
        TrainState, make_fcn_optimizer, make_fcn_train_step,
        make_seenmask_optimizer, make_seenmask_train_step,
        make_szn_eval_step)

    stages = _closure(stages)
    torch.set_num_threads(1)
    rng = np.random.RandomState(42)
    e = rng.randn(N_CLASS, 20).astype(np.float32)
    embeddings = e / np.linalg.norm(e, axis=1, keepdims=True)

    def make_data(n):
        out = []
        for _ in range(n):
            img = rng.randn(1, size, size, 3).astype(np.float32)
            lbl = rng.randint(0, N_CLASS, (1, size, size)).astype(np.int32)
            lbl[rng.rand(1, size, size) < 0.1] = -1
            out.append({"image": img, "label": lbl,
                        "sizes": np.full((1, 2), size, np.int32),
                        "num_real": np.int32(1)})
        return out

    # every stage's batches, drawn in the JAX script's order
    data = {"adam": make_data(steps), "sgd": make_data(steps),
            "stage2": make_data(steps), "eval": make_data(max(6, steps // 4))}

    def jbatch(b):
        return jax.tree.map(jnp.asarray, b)

    def init(num_classes, seed):
        jm = JFCN32s(num_classes=num_classes, channel_scale=scale,
                     dropout_rate=0.0)
        params = jax.jit(lambda k, x: jm.init(k, x, mode="both"))(
            jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))["params"]
        tree = jax.tree.map(np.asarray, params)
        model = load_jax_params(FCN32s(num_classes, channel_scale=scale,
                                       dropout_rate=0.0, device="cpu"), tree)
        return jm, params, tree, model

    def jax_sd(params):
        return state_dict_from_jax_params(jax.tree.map(np.asarray, params))

    def port_sd(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def stage1(name, num_classes, seed, loss_name, emb):
        jm, params, tree, model = init(num_classes, seed)
        optim = "adam" if name == "adam" else "sgd"
        tx = j_fcn_optimizer(params, optim=optim, lr=LRS[name])
        jstep = j_steps.make_fcn_train_step(
            jm, tx, loss_name=loss_name, num_classes=N_CLASS,
            embeddings=emb)
        jstate = JTrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
        state = TrainState.create(model, make_fcn_optimizer(
            model, optim=optim, lr=LRS[name]))
        pstep = make_fcn_train_step(loss_name=loss_name,
                                    num_classes=N_CLASS, embeddings=emb)
        t0, t_jax, t_port = time.time(), 0.0, 0.0
        max_rel = max_flip = 0.0
        for i, b in enumerate(data[name]):
            t = time.time()
            jstate, jaux = jstep(jstate, jbatch(b), jax.random.PRNGKey(0))
            jl, jh = float(jaux["loss"]), np.asarray(jaux["hist"], np.int64)
            t_jax += time.time() - t
            t = time.time()
            state, aux = pstep(state, b)
            pl, ph = float(aux["loss"]), aux["hist"].numpy().astype(np.int64)
            t_port += time.time() - t
            rel = _rel(pl, jl)
            flips = int(np.abs(ph - jh).sum()) // 2
            max_rel = max(max_rel, rel)
            max_flip = max(max_flip, flips / (size * size))
            print(f"{name} step {i}: loss jax {jl:.6f} port {pl:.6f} "
                  f"rel {rel:.2e} flips {flips}", flush=True)
        per_leaf, worst, glob = _deltas(jax_sd(jstate.params),
                                        state_dict_from_jax_params(tree),
                                        port_sd(model), skip=FROZEN)
        rep = {"lr": LRS[name], "max_loss_rel": max_rel,
               "global_delta_rel_l2": glob,
               "worst_param_delta_rel_l2": worst["rel_l2"],
               "worst_rel_l2_param": worst["name"],
               "delta_rel_l2_per_leaf": per_leaf,
               "jax_s": round(t_jax, 1), "port_s": round(t_port, 1),
               "wall_s": round(time.time() - t0, 1)}
        if name == "adam":
            rep["max_pred_flip_frac"] = max_flip
        return rep, (jm, jstate, state)

    def stage2(carried):
        jm, jstate, state = carried
        seen = np.array([c not in TRAIN_UNSEEN for c in range(N_CLASS)])
        tx = j_seenmask_optimizer(jstate.params, lr=LRS["stage2"])
        jstep = j_steps.make_seenmask_train_step(jm, tx, seen_vec=seen)
        jstate2 = JTrainState(params=jstate.params,
                              opt_state=tx.init(jstate.params),
                              step=jnp.zeros((), jnp.int32))
        model = state.model
        state2 = TrainState.create(model, make_seenmask_optimizer(
            model, lr=LRS["stage2"]))
        pstep = make_seenmask_train_step(seen_vec=seen)
        head0 = model.seenmask_score.weight.detach().clone().numpy()
        up0 = model.seenmask_upscore.weight.detach().clone().numpy()
        t0, t_jax, t_port, max_rel = time.time(), 0.0, 0.0, 0.0
        for i, b in enumerate(data["stage2"]):
            t = time.time()
            jstate2, jaux = jstep(jstate2, jbatch(b), jax.random.PRNGKey(0))
            jl = float(jaux["loss"])
            t_jax += time.time() - t
            t = time.time()
            state2, aux = pstep(state2, b)
            pl = float(aux["loss"])
            t_port += time.time() - t
            rel = _rel(pl, jl)
            max_rel = max(max_rel, rel)
            print(f"stage2 step {i}: loss jax {jl:.6f} port {pl:.6f} "
                  f"rel {rel:.2e}", flush=True)
        d_jax = (jax_sd(jstate2.params)["seenmask_score.weight"].numpy()
                 - head0)
        d_port = model.seenmask_score.weight.detach().numpy() - head0
        sc = max(float(np.max(np.abs(d_port))), 1e-12)
        u_jax = (jax_sd(jstate2.params)["seenmask_upscore.weight"].numpy()
                 - up0)
        u_port = model.seenmask_upscore.weight.detach().numpy() - up0
        rep = {"lr": LRS["stage2"], "max_loss_rel": max_rel,
               "head_delta_global_rel_l2": float(
                   np.linalg.norm(d_jax - d_port)
                   / max(np.linalg.norm(d_port), 1e-12)),
               "head_delta_outlier_frac": float(
                   (~np.isclose(d_jax, d_port, rtol=2e-3,
                                atol=2e-3 * sc)).mean()),
               "upscore_delta_rel_l2": float(
                   np.linalg.norm(u_jax - u_port)
                   / max(np.linalg.norm(u_port), 1e-12)),
               "jax_s": round(t_jax, 1), "port_s": round(t_port, 1),
               "wall_s": round(time.time() - t0, 1)}
        return rep, (jm, jstate2, state2)

    def evaluate(carried):
        jm, jstate, state = carried
        uv = unseen_mask_vector(N_CLASS, list(VAL_UNSEEN))
        kw = dict(loss_name="cos", num_classes=N_CLASS,
                  all_unseen_vec=uv, val_unseen_vec=uv)
        jstep = j_steps.make_szn_eval_step(jm, embeddings=embeddings, **kw)
        pstep = make_szn_eval_step(embeddings=embeddings, **kw)
        hists = {"jax": np.zeros((3, N_CLASS, N_CLASS), np.int64),
                 "port": np.zeros((3, N_CLASS, N_CLASS), np.int64)}
        loss = {"jax": 0.0, "port": 0.0}
        t0, flips = time.time(), 0
        for b in data["eval"]:
            jout = jstep(jstate.params, jbatch(b))
            pout = pstep(state.model, b)
            hists["jax"] += np.asarray(jout["hists"], np.int64)
            hists["port"] += pout["hists"].numpy().astype(np.int64)
            loss["jax"] += float(jout["loss_sum"])
            loss["port"] += float(pout["loss_sum"])
            flips += int((pout["pred"].numpy()
                          != np.asarray(jout["pred"])).sum())
        groups = {}
        for gi, gname in enumerate(("overall", "seen", "unseen")):
            ours = np.asarray(hist_to_metrics(hists["port"][gi]), np.float64)
            ref = np.asarray(j_hist_to_metrics(hists["jax"][gi]), np.float64)
            with np.errstate(invalid="ignore"):
                d = np.abs(ours - ref)
            groups[gname] = {
                "port": [round(float(v), 6) for v in ours],
                "jax": [round(float(v), 6) for v in ref],
                "max_abs_delta": float(np.nanmax(d)) if np.isfinite(
                    d).any() else 0.0}
        return {"val_loss_rel": _rel(loss["port"], loss["jax"]),
                "hist_l1": int(np.abs(hists["jax"] - hists["port"]).sum()),
                "pred_flips": flips, "images": len(data["eval"]),
                "metrics": groups, "wall_s": round(time.time() - t0, 1)}

    report = {"scale": scale, "size": size, "steps": steps,
              "threads": torch.get_num_threads(), "host": _host(),
              "jax_backend": jax.default_backend()}
    carried = None
    for name in stages:
        if name == "adam":
            report[name], carried = stage1("adam", 20, 0, "cos", embeddings)
        elif name == "sgd":
            report[name], _ = stage1("sgd", N_CLASS, 1, "cross_entropy",
                                     None)
        elif name == "stage2":
            report[name], carried = stage2(carried)
        else:
            report[name] = evaluate(carried)
        check(name, report[name])
        print(f"{name} OK: " + json.dumps(
            {k: v for k, v in report[name].items()
             if k != "delta_rel_l2_per_leaf"}), flush=True)
    return report


def save(report: dict, path: str = OUT) -> dict:
    """Merge `report`'s stages into the JSON at `path` (a file of another
    geometry is replaced), under a lock so that parallel runs may share
    it. Returns what was written."""
    directory = osp.dirname(path)
    os.makedirs(directory, exist_ok=True)
    geometry = ("scale", "size", "steps")
    lock = os.open(directory, os.O_RDONLY)  # the directory is the lock
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        old = {}
        if osp.exists(path):
            with open(path) as f:
                old = json.load(f)
            if any(old.get(k) != report[k] for k in geometry):
                old = {}
        old.update(report)
        with open(path + ".tmp", "w") as f:
            json.dump(old, f, indent=1, sort_keys=True)
        os.replace(path + ".tmp", path)
    finally:
        os.close(lock)
    return old


def _setup_jax() -> None:
    """JAX on the CPU with the tests' 8 virtual devices (which also splits
    XLA:CPU's thread pool: each program runs on one thread)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--stages", default=",".join(STAGES))
    p.add_argument("--out", default=OUT)
    a = p.parse_args(argv)
    _setup_jax()
    sys.path[:0] = [_REPO]
    t0 = time.time()
    report = run_lockstep(a.scale, a.size, a.steps, a.stages.split(","))
    print(f"lockstep {','.join(_closure(a.stages.split(',')))} "
          f"{time.time() - t0:.0f} s", flush=True)
    out = save(report, a.out)
    print(f"wrote {a.out} (stages: "
          f"{', '.join(s for s in STAGES if s in out)})", flush=True)
    return out


if __name__ == "__main__":
    main()
