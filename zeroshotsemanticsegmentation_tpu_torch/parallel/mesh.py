"""The process mesh: data x model parallelism over `torch.distributed` (the
JAX package's parallel/mesh.py).

One process per rank, each on its own device (or several ranks on one card
over gloo). The mesh lays the ranks out as the JAX mesh lays out devices:
rank r sits where device r sits in `np.arange(n).reshape(shape)`, with
axes ('data', 'model') or ('slice', 'data', 'model').

* **DP** over 'data', or over ('slice', 'data') together (`data_axes`): each
  rank runs its rows of the global batch (`shard_batch`). The loss is
  normalised by the GLOBAL count of real samples, so the gradients are
  SUMMED over the data group after the backward (`all_reduce_grads`: the
  large ones in place, the rest in one flat all-reduce), never averaged;
  the step's metrics are summed the same way (`reduce_sums`). Where the JAX package lets GSPMD insert these
  reductions, here they are placed by hand.
* **TP** over 'model': fc6 and fc7 (~86% of the parameters) split
  Megatron-style (`TP_RULES`): fc6 on its output channels with its bias,
  fc7 on its input channels; fc7's bias is replicated and added once,
  after the all-reduce. `copy_to_model` (identity forward, all-reduce
  backward) sits on fc6's input, `reduce_from_model` (all-reduce forward,
  identity backward) after fc7's product. Every other parameter is
  replicated; its gradient is equal on every model rank because fc7's
  output and fc6's input gradient are already reduced there.

* **Height** over 'data' (`parallel.spatial`: one image split into bands
  of rows): `exchange_halo` (each rank's edge rows to its neighbours),
  `gather_height` (every band's rows, in order) and `all_reduce_max` (the
  int8 forward's scales), all through `Mesh.all_reduce`. On a multislice
  mesh the 'slice' ranks repeat the same bands.

Collectives are the ones both backends offer on CUDA tensors, all_reduce
and broadcast (gloo has no all_gather for them): a gather is an all-reduce
of a zero-filled tensor in which each rank wrote its own slot (a sum with
zeros is exact in every dtype).

`init_distributed` starts the default process group with the backend the
caller names (nccl on cards, gloo on the CPU or for several ranks sharing
one card) and a timeout, so a stalled collective fails in that time.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from zeroshotsemanticsegmentation_tpu_torch import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"  # the outer data axis of a multi-slice mesh

# state-dict key -> the dimension split over 'model' (Conv2d OIHW; the JAX
# package's _TP_RULES and param_pspecs): fc6 column-parallel (output
# channels, with its bias), fc7 row-parallel (input channels); every other
# key, fc7.bias among them, is replicated
TP_RULES = {"fc6.weight": 0, "fc6.bias": 0, "fc7.weight": 1}

_timeout = datetime.timedelta(seconds=300)
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def init_distributed(backend: str, init_method: str, rank: int,
                     world_size: int, timeout: float = 300.0) -> None:
    """Start the default process group: `backend` "nccl" or "gloo",
    `init_method` e.g. "tcp://localhost:<port>", "file://<path>" or
    "env://"; a collective that waits longer than `timeout` seconds
    raises."""
    global _timeout
    _timeout = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=_timeout)


def data_axes(mesh: "Mesh | None") -> tuple:
    """The mesh axes a batch dimension shards over ('slice' included when
    the mesh is multi-slice)."""
    if mesh is not None and SLICE_AXIS in mesh.axis_names:
        return (SLICE_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


class Mesh:
    """This rank's view of the mesh: the axis sizes (`shape`), its
    coordinates, its device, and the process groups of its 'data' axes
    (slice x data together) and of 'model' (`group_ranks`). Without
    `groups` it is the layout alone, with no process group behind it."""

    def __init__(self, axis_names, sizes, rank: int, device, groups=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(rank, tuple(sizes)))))
        self.device = torch.device(device)
        self.model_size = self.shape[MODEL_AXIS]
        self.model_rank = self.rank % self.model_size
        self.data_size = self.size // self.model_size
        self.data_rank = self.rank // self.model_size
        self.data_group, self.model_group = groups or (None, None)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")

    def all_reduce(self, t: torch.Tensor, axes=(DATA_AXIS,),
                   op: str = "sum") -> None:
        """All-reduce `t` in place ("sum" or "max") over the group of each
        axis of `axes` in turn: 'data' (the data group, 'slice' included)
        or 'model'."""
        groups = {DATA_AXIS: self.data_group, MODEL_AXIS: self.model_group}
        for axis in axes:
            if groups[axis] is None:
                raise RuntimeError("this mesh is a layout without process "
                                   "groups")
            dist.all_reduce(t, op=_REDUCE_OPS[op], group=groups[axis])


def rank_grid(sizes) -> np.ndarray:
    """The ranks laid out on the mesh: rank r where device r sits in the
    JAX mesh's `devices` (its `reshape(slices, data, model)`)."""
    return np.arange(int(np.prod(sizes))).reshape(tuple(sizes))


def group_ranks(sizes) -> tuple:
    """(the data groups, the model groups) of a mesh, as lists of ranks.
    The model axis is the last: data group m holds the ranks of model
    coordinate m over every data axis, model group d the `model`
    consecutive ranks of data position d."""
    grid = rank_grid(sizes).reshape(-1, sizes[-1])
    return ([grid[:, m].tolist() for m in range(grid.shape[1])],
            [row.tolist() for row in grid])


def _device_for(rank: int, devices):
    if devices is not None:
        return torch.device(devices[rank])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = resolve_device("cuda")
    return torch.device(dev.type, local % torch.cuda.device_count())


def _build(axis_names, sizes, devices) -> Mesh:
    if not dist.is_initialized():
        raise RuntimeError("the mesh needs a process group: call "
                           "init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = int(np.prod(sizes))
    if need != world or min(sizes) < 1:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} needs {need} "
                         f"processes, the process group has {world}")
    if devices is not None and len(devices) < world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = _device_for(rank, devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # every rank creates every group, in the same order
    groups = []
    for kind in group_ranks(sizes):
        for ranks in kind:
            g = dist.new_group(ranks, timeout=_timeout)
            if rank in ranks:
                groups.append(g)
    return Mesh(axis_names, sizes, rank, device, groups)


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """('data', 'model') mesh over the default process group; `data`
    defaults to world // model. `devices[r]` is rank r's device (default:
    the card `LOCAL_RANK` names, else the rank's)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    return _build((DATA_AXIS, MODEL_AXIS), (data, model), devices)


def make_multislice_mesh(slices: int, data: int | None = None,
                         model: int = 1, devices=None) -> Mesh:
    """('slice', 'data', 'model') mesh: pure DP over 'slice' (the JAX
    package's DCN axis), DP x TP within; the batch shards over slice and
    data together."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // (slices * model)
    return _build((SLICE_AXIS, DATA_AXIS, MODEL_AXIS), (slices, data, model),
                  devices)


# ---- shards ---------------------------------------------------------------

def _shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    m = mesh.model_size
    if t.shape[dim] % m:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {m} model ranks")
    n = t.shape[dim] // m
    return t.narrow(dim, mesh.model_rank * n, n).contiguous()


def _gather(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor from each model rank's shard: an all-reduce of a
    zero-filled tensor holding this rank's slot."""
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * mesh.model_size
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, mesh.model_rank * n, n).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    return full


def shard_shape(key: str, shape, model: int) -> tuple:
    """The shape of one model rank's shard of `key` (`TP_RULES`)."""
    shape = list(shape)
    dim = TP_RULES.get(key)
    if dim is not None:
        shape[dim] //= model
    return tuple(shape)


def shard_params(state_dict, mesh: Mesh) -> dict:
    """This rank's shards of a full state dict: fc6 / fc7 split by
    `TP_RULES`, the rest as it is."""
    return {k: (_shard(v, TP_RULES[k], mesh) if k in TP_RULES else v)
            for k, v in state_dict.items()}


def gather_params(state_dict, mesh: Mesh) -> dict:
    """The full state dict from this rank's shards (every rank calls it)."""
    return {k: (_gather(v, TP_RULES[k], mesh) if k in TP_RULES else v)
            for k, v in state_dict.items()}


def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Split `model`'s fc6 / fc7 parameters over 'model' in place and give
    it the mesh: its forward then runs the TP layers (`models.fcn32s`).
    Build the optimizer after this."""
    if getattr(model, "mesh", None) is not None:
        raise ValueError("the model is already sharded over a mesh")
    with torch.no_grad():
        for key, dim in TP_RULES.items():
            mod_name, leaf = key.split(".")
            mod = getattr(model, mod_name)
            setattr(mod, leaf, torch.nn.Parameter(
                _shard(getattr(mod, leaf).detach(), dim, mesh)))
    model.mesh = mesh
    return model


def opt_param_names(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> list:
    """The parameter name of each index of `optimizer.state_dict()`'s
    "state" (torch numbers the parameters over its groups in order)."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _map_opt_state(opt_state: dict, names: list, fn) -> dict:
    state = {}
    for idx, entry in opt_state["state"].items():
        dim = TP_RULES.get(names[int(idx)])
        state[idx] = {k: (fn(v, dim) if dim is not None and torch.is_tensor(v)
                          and v.dim() > dim else v)
                      for k, v in entry.items()}
    return {**opt_state, "state": state}


def shard_opt_state(opt_state: dict, names: list, mesh: Mesh) -> dict:
    """A full optimizer `state_dict()` (Adam's moments, SGD's momentum)
    sharded like its parameters; `names` from `opt_param_names`."""
    return _map_opt_state(opt_state, names,
                          lambda v, dim: _shard(v, dim, mesh))


def gather_opt_state(opt_state: dict, names: list, mesh: Mesh) -> dict:
    """The full optimizer state from this rank's shards (every rank calls
    it)."""
    return _map_opt_state(opt_state, names,
                          lambda v, dim: _gather(v, dim, mesh))


def shard_batch(batch: dict, mesh: Mesh, chunks: int = 1) -> dict:
    """This rank's rows of a global batch: every array with a leading
    dimension is split over the data axes; scalars (`num_real`, the GLOBAL
    count of real samples) and "ids" stay as they are. With `chunks` = k
    the batch is k microbatches in turn (`grad_accum`): the rank takes its
    rows of each, in order, so its i-th local microbatch is its shard of
    the global i-th (and the dropout masks it draws are that one's)."""
    n, r = mesh.data_size, mesh.data_rank
    out = {}
    for k, v in batch.items():
        if k == "ids" or getattr(v, "ndim", np.ndim(v)) == 0:
            out[k] = v
            continue
        b = v.shape[0]
        if b % (n * chunks):
            raise ValueError(f"batch {b} ({k!r}) not divisible by the "
                             f"mesh's {n} data shards x {chunks} "
                             "microbatches")
        m = b // (n * chunks)
        parts = [v[(i * n + r) * m:(i * n + r + 1) * m]
                 for i in range(chunks)]
        out[k] = parts[0] if chunks == 1 else (
            torch.cat(parts) if torch.is_tensor(v) else np.concatenate(parts))
    return out


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from each data rank's rows, on every rank."""
    b = t.shape[0]
    full = torch.zeros((b * mesh.data_size, *t.shape[1:]), dtype=t.dtype,
                       device=t.device)
    full[mesh.data_rank * b:(mesh.data_rank + 1) * b] = t
    dist.all_reduce(full, group=mesh.data_group)
    return full


# ---- height collectives (`parallel.spatial`) --------------------------------

def exchange_halo(a: torch.Tensor, top: int, bottom: int, mesh,
                  dim: int = 2):
    """(the last `top` rows of the band above, the first `bottom` rows of
    the band below) along `dim`, None where there is no such neighbour or
    no rows are asked for. Every rank of the data group calls it with the
    same `top`, `bottom` and the same extent in every other dimension. One
    all-reduce of a zero-filled (data group size, ..., top + bottom, ...)
    buffer in which each rank wrote the edge rows its neighbours take."""
    n, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    if n == 1 or top + bottom == 0:
        return None, None
    rows = a.shape[dim]
    if (d > 0 and rows < bottom) or (d < n - 1 and rows < top):
        raise ValueError(f"exchange_halo: a band of {rows} rows cannot give "
                         f"{bottom} rows up and {top} down")
    shape = list(a.shape)
    shape[dim] = top + bottom
    buf = torch.zeros((mesh.data_size, *shape), dtype=a.dtype,
                      device=a.device)
    me = mesh.data_rank  # neighbours are me - 1 and me + 1 (same slice)
    if d > 0 and bottom:
        buf[me].narrow(dim, 0, bottom).copy_(a.narrow(dim, 0, bottom))
    if d < n - 1 and top:
        buf[me].narrow(dim, bottom, top).copy_(a.narrow(dim, rows - top,
                                                        top))
    mesh.all_reduce(buf)
    above = (buf[me - 1].narrow(dim, bottom, top) if d > 0 and top
             else None)
    below = (buf[me + 1].narrow(dim, 0, bottom) if d < n - 1 and bottom
             else None)
    return above, below


def gather_height(t: torch.Tensor, mesh, bounds, dim: int = 1
                  ) -> torch.Tensor:
    """The whole tensor along `dim` from each band's rows, on every rank:
    band r holds rows [bounds[r], bounds[r + 1]). One all-reduce over the
    data group of a zero-filled tensor in which the ranks of slice 0 wrote
    their rows (the other slices hold the same bands)."""
    n, d = mesh.shape[DATA_AXIS], mesh.coords[DATA_AXIS]
    if len(bounds) != n + 1 or t.shape[dim] != bounds[d + 1] - bounds[d]:
        raise ValueError(f"gather_height: {t.shape[dim]} rows on band {d} "
                         f"of {bounds}")
    if n == 1:
        return t
    shape = list(t.shape)
    shape[dim] = bounds[-1]
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    if mesh.coords.get(SLICE_AXIS, 0) == 0:
        full.narrow(dim, bounds[d], bounds[d + 1] - bounds[d]).copy_(t)
    mesh.all_reduce(full)
    return full


def all_reduce_max(t: torch.Tensor, mesh, over=(DATA_AXIS,)
                   ) -> torch.Tensor:
    """The elementwise maximum of `t` over the mesh axes `over` ('data',
    'model'), on every rank (a new tensor; no mesh: `t`)."""
    if mesh is None:
        return t
    out = t.detach().clone()
    mesh.all_reduce(out, over, "max")
    return out


# ---- collectives of the steps ----------------------------------------------

def all_reduce_grads(params, mesh: Mesh, in_place_numel: int = 1 << 22
                     ) -> None:
    """Sum the gradients over the data group (the loss is normalised by the
    global sample count, so the sum is the global gradient). A gradient of
    at least `in_place_numel` elements (fc6's, fc7's: most of the bytes) is
    all-reduced where it lies; the rest go in one flat all-reduce, so the
    step copies tens of MB, not every gradient. Parameters without a
    gradient are left out; the set is the same on every rank."""
    small = []
    for p in params:
        g = p.grad
        if g is None:
            continue
        if g.numel() >= in_place_numel and g.is_contiguous():
            dist.all_reduce(g, group=mesh.data_group)
        else:
            small.append(g)
    if not small:
        return
    flat = torch.cat([g.reshape(-1) for g in small])
    dist.all_reduce(flat, group=mesh.data_group)
    at = 0
    for g in small:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()


def reduce_sums(values: dict, mesh: Mesh) -> dict:
    """Each tensor of `values` summed over the data group, in one fp64
    all-reduce (exact for the histograms' counts); dtypes and shapes are
    kept."""
    keys = list(values)
    flat = torch.cat([values[k].detach().reshape(-1).to(torch.float64)
                      for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    out, at = {}, 0
    for k in keys:
        v = values[k]
        out[k] = flat[at:at + v.numel()].view(v.shape).to(v.dtype)
        at += v.numel()
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over 'model' (fc6's
    input: each model rank's fc6 shard gives part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products all-reduced over 'model' (fc7's output, before
    its bias); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh.model_group)
