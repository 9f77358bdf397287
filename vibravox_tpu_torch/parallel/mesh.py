"""The ``(data, model)`` mesh and the data-parallel step (PyTorch).

Counterpart of ``vibravox_tpu/parallel/mesh.py``.  There, XLA's partitioner
inserts every collective; here they are explicit, so that a run over W
processes (one rank, one device) computes what the one-device step computes
on the concatenated global batch:

* **Gradients** are averaged over ``data`` before each ``optimizer.step()``
  by one bucketed ``all_reduce`` per optimizer (:func:`sync_gradients`,
  which the tasks call), not by ``DistributedDataParallel``: the EBEN step
  has two optimizers and takes ``torch.autograd.grad`` of each atomic loss
  for its balancing, which DDP's reducer hooks never see.
* **Global ratios** (spectral convergence, feature matching) sum their
  numerators and denominators over ``data`` with :func:`data_sum` /
  :func:`data_mean`, differentiable all-reduces whose backward sums the
  gradient over ``data`` too.  Each rank's local gradient then comes out W
  times its share of the global one, as a mean loss's does, and the
  gradient average brings both back.
* **Random draws** that depend on the batch (dropout masks, SpecAugment
  spans) are drawn over the global batch from the generator every rank
  shares, and each rank keeps its own rows (:func:`global_rand`).
* **Initial state** is broadcast from rank 0 before the placement.
* **Placement**: tensor parallelism over ``model`` for a task with a
  ``partition_spec_for_path`` hook (``parallel/tp.py``), and, with
  ``fsdp``, FSDP2 over ``data`` for the rank-2 leaves of ``fsdp_spec``
  (``parallel/fsdp.py``).
* **Evaluation** runs each rank's own rows with no collective over
  ``data``; the trainer sums each loader's metrics and batch counts over
  ``data`` once at its end (:meth:`DataParallel.reduce_sums`), so an
  uneven split evaluates every utterance once and cannot hang, and the
  SPKV task gathers its trial scores (:func:`gather_objects`).
* **Checkpoints** hold full tensors (:meth:`DataParallel.full_state_dict`),
  so a state saved at W ranks resumes at one and the other way round.

Control messages (end of data, a preemption signal, the guard's verdict)
travel on a gloo group of their own, on the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from vibravox_tpu_torch.parallel import distributed
from vibravox_tpu_torch.parallel.fsdp import FSDP_MIN_LEAF_SIZE, torch_fsdp_dim
from vibravox_tpu_torch.parallel.tp import ModelShard, shard_transformer_

__all__ = [
    "MeshConfig", "build_mesh", "DataParallel", "current", "data_sum", "data_mean", "sync_gradients",
    "global_rand", "global_rows", "data_shard", "gather_objects",
]


@dataclasses.dataclass
class MeshConfig:
    """``trainer.mesh``: ``data`` ranks (``-1``: every process left) times
    ``model`` ranks must make the world size; ``fsdp`` shards parameters
    and optimizer state over ``data`` (leaves below ``fsdp_min_size``
    elements stay replicated)."""

    data: int = -1
    model: int = 1
    fsdp: bool = False
    fsdp_min_size: Optional[int] = None

    def resolve(self, n_devices: Optional[int] = None) -> Dict[str, int]:
        n = n_devices if n_devices is not None else distributed.process_count()
        model = max(1, int(self.model))
        data = int(self.data) if int(self.data) > 0 else n // model
        if data * model != n:
            raise ValueError(f"mesh {data}x{model} does not cover {n} processes")
        return {"data": data, "model": model}


def build_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group with dimensions
    ``("data", "model")`` (rank ``d * model + m``); None for a
    single-process run without a process group."""
    config = config or MeshConfig()
    sizes = config.resolve()
    if not distributed.is_initialized():
        return None
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(sizes["data"] * sizes["model"]).reshape(sizes["data"], sizes["model"])
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


# --------------------------------------------------------------------------- #
# The process's mesh and the helpers the tasks, losses and models call
# --------------------------------------------------------------------------- #

_MESH: Optional["DataParallel"] = None


def current() -> Optional["DataParallel"]:
    """The mesh of a train step in flight, else None."""
    return _MESH if _MESH is not None and _MESH.in_step else None


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``data`` in a train step (differentiable: the
    backward sums the gradient over ``data``); ``x`` itself otherwise."""
    mesh = current()
    if mesh is None or mesh.data_size == 1:
        return x
    return _DataSum.apply(x, mesh.data_group)


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over ``data`` of equal shards' means, as :func:`data_sum`."""
    mesh = current()
    if mesh is None or mesh.data_size == 1:
        return x
    return _DataSum.apply(x, mesh.data_group) / mesh.data_size


def sync_gradients(params: Sequence[torch.Tensor]) -> None:
    """The gradients of ``params`` averaged over ``data`` in place, one
    all-reduce per dtype, before the optimizer steps.  Gradients FSDP2
    already reduce-scattered (DTensors) and absent ones are skipped."""
    mesh = current()
    if mesh is not None:
        mesh.average_gradients(params)


def global_rows(batch: int) -> Tuple[int, int]:
    """``(global batch, first row of this rank)`` in a train step."""
    mesh = current()
    if mesh is None or mesh.data_size == 1:
        return batch, 0
    return batch * mesh.data_size, batch * mesh.data_rank


def global_rand(shape: Sequence[int], generator: torch.Generator, device,
                split_last: Optional[ModelShard] = None) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows of the global batch: drawn
    over the whole batch (dimension 0) from the shared ``generator`` and
    cut to the rank's rows, and, when ``split_last`` is given, to the
    rank's columns of a last dimension that TP split."""
    shape = list(shape)
    rows = shape[0]
    shape[0], start = global_rows(rows)
    if split_last is not None:
        shape[-1] *= split_last.size
    u = torch.rand(shape, generator=generator, device=device)[start:start + rows]
    if split_last is not None:
        u = u[..., split_last.columns(shape[-1])]
    return u


def data_shard() -> Tuple[int, int]:
    """``(rank, size)`` of this process on ``data``, which the loaders
    shard by: the built mesh's, else the process group's."""
    if _MESH is not None:
        return _MESH.data_rank, _MESH.data_size
    return distributed.process_index(), distributed.process_count()


def gather_objects(obj: Any) -> List[Any]:
    """``obj`` of every ``data`` rank (rank order; the first ``model`` rank
    of each), or ``[obj]`` without a mesh."""
    if _MESH is None or _MESH.world == 1:
        return [obj]
    return _MESH.gather_data(obj)


# --------------------------------------------------------------------------- #
# The data-parallel step
# --------------------------------------------------------------------------- #


def _bucketed(tensors, collective) -> int:
    """``collective(flat)`` on one flat copy of ``tensors`` per (dtype,
    device), written back in place; returns the bytes it carried."""
    buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    carried = 0
    for group in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
        carried += flat.numel() * flat.element_size()
    return carried


def _gather(local: torch.Tensor, dim: int, full: int, group, rank: int, size: int) -> torch.Tensor:
    """The whole of a tensor split in ``torch.chunk``'s pieces over
    ``group`` along ``dim``, through an all-reduce of a zero-filled
    tensor: gloo carries all-reduce on CUDA tensors, and its all-gather
    under DTensor's functional collectives crashed on the H100 (PERF.md)."""
    shape = list(local.shape)
    shape[dim] = full
    out = torch.zeros(shape, dtype=local.dtype, device=local.device)
    out.narrow(dim, rank * -(-full // size), local.shape[dim]).copy_(local)
    dist.all_reduce(out, group=group)
    return out


def _is_dtensor(t) -> bool:
    # no DTensor exists before its module is imported (and that is slow)
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def task_modules(task) -> Dict[str, nn.Module]:
    """The task's networks: its attributes that are modules."""
    return {k: v for k, v in vars(task).items() if isinstance(v, nn.Module)}


def _tp_dims(module: nn.Module) -> Dict[str, int]:
    """Parameter name -> torch dimension split over ``model``, of every
    ``Linear`` the TP placement cut (``ModelShard.split_`` marks them)."""
    dims = {}
    for name, layer in module.named_modules():
        for pname, dim in getattr(layer, "_tp_dims", {}).items():
            dims[f"{name}.{pname}" if name else pname] = dim
    return dims


class DataParallel:
    """A task's train and eval steps over the mesh.

    ``mesh``: a ``DeviceMesh`` from :func:`build_mesh`, or None for one
    process (every collective is then skipped).  Made once per task,
    before the optimizers exist: it broadcasts the task's networks from
    rank 0, splits them over ``model`` for a task with
    ``partition_spec_for_path``, calls the task's
    ``configure_for_mesh(self)`` when it has one, and with ``fsdp`` puts
    each network under FSDP2, whose ``forward`` and the methods the task
    names in ``fsdp_forward_methods`` (network name -> method names)
    gather its parameters.  ``allreduce_bytes`` counts the gradient bytes
    reduced; with ``time_collectives`` (it synchronises the device)
    ``allreduce_seconds`` their wall time."""

    def __init__(self, task, mesh=None, fsdp: bool = False, fsdp_min_size: Optional[int] = None,
                 time_collectives: bool = False):
        global _MESH
        self.task, self.mesh = task, mesh
        self.world = distributed.process_count() if mesh is not None else 1
        if mesh is not None:
            self.data_size, self.model_size = mesh.size(0), mesh.size(1)
            self.data_rank, self.model_rank = mesh.get_local_rank("data"), mesh.get_local_rank("model")
            self.data_group, self.model_group = mesh.get_group("data"), mesh.get_group("model")
        else:
            self.data_size = self.model_size = 1
            self.data_rank = self.model_rank = 0
            self.data_group = self.model_group = None
        self.fsdp = bool(fsdp) and self.data_size > 1
        self.fsdp_min_size = FSDP_MIN_LEAF_SIZE if fsdp_min_size is None else int(fsdp_min_size)
        self.time_collectives = time_collectives
        self.allreduce_bytes = 0
        self.allreduce_seconds = 0.0
        self.in_step = False
        # the host's control plane: agreement on stopping, metric sums
        self._control = dist.new_group(backend="gloo") if self.world > 1 else None
        self.model_shard: Optional[ModelShard] = None
        self.fsdp_modules: List[nn.Module] = []
        self._foreach_was: Dict[Tuple[int, int], Any] = {}  # (optimizer, group) -> its own foreach
        _MESH = self
        self._place()

    # ---------------------------------------------------------------- #

    def _place(self) -> None:
        modules = task_modules(self.task)
        if self.world > 1:
            self._broadcast(modules.values())
        spec_fn = getattr(self.task, "partition_spec_for_path", None)
        if self.model_size > 1 and spec_fn is not None:
            self.model_shard = ModelShard(self.model_group, self.model_size, self.model_rank)
            for module in modules.values():
                shard_transformer_(module, self.model_shard, spec_fn)
        configure = getattr(self.task, "configure_for_mesh", None)
        if configure is not None:
            configure(self)
        if self.fsdp:
            methods = getattr(self.task, "fsdp_forward_methods", {})
            for name, module in modules.items():
                if self._fully_shard(module, methods.get(name, ())):
                    self.fsdp_modules.append(module)

    def _broadcast(self, modules) -> None:
        """Every parameter and buffer from global rank 0, one bucket per dtype."""
        with torch.no_grad():
            _bucketed([t for m in modules for t in list(m.parameters()) + list(m.buffers())],
                      lambda flat: dist.broadcast(flat, src=0))

    def _fully_shard(self, module: nn.Module, methods: Sequence[str]) -> bool:
        """FSDP2 over ``data`` for the leaves ``fsdp_spec`` shards; the rest
        are ignored by FSDP2 and stay replicated.  ``methods``: entry points
        other than ``forward`` that gather the parameters.  False when no
        leaf qualifies."""
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
        from torch.distributed.tensor import Shard

        tp = _tp_dims(module)
        dims: Dict[nn.Parameter, int] = {}
        ignored = set()
        for name, p in module.named_parameters():
            shape = list(p.shape)
            tp_dim = tp.get(name)
            if tp_dim is not None:
                shape[tp_dim] *= self.model_size
            dim = torch_fsdp_dim(tuple(shape), self.data_size, tp_dim, self.fsdp_min_size)
            if dim is None or not p.requires_grad:
                ignored.add(p)
            else:
                dims[p] = dim
        if not dims:
            return False
        fully_shard(module, mesh=self.mesh["data"], reshard_after_forward=True,
                    shard_placement_fn=lambda p: Shard(dims[p]) if p in dims else None,
                    ignored_params=ignored)
        for method in methods:
            register_fsdp_forward_method(module, method)
        return True

    # ---------------------------------------------------------------- #

    @staticmethod
    def split_batch(batch: Dict[str, Any], device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """The batch's tensors (sent to ``device`` when given) and its
        host-only fields (the STP collate's ``phonemes_str``, SPKV's
        speaker ids)."""
        arrays = {k: (v.to(device, non_blocking=True) if device is not None else v)
                  for k, v in batch.items() if isinstance(v, torch.Tensor)}
        return arrays, {k: v for k, v in batch.items() if not isinstance(v, torch.Tensor)}

    def init_state(self, seed: int = 0):
        state = self.task.init_state(seed)
        self._per_tensor_steps(state)
        return state

    def _per_tensor_steps(self, state) -> None:
        """An optimizer group holding FSDP2's DTensors and plain (replicated)
        tensors steps tensor by tensor: a foreach kernel takes one kind."""
        if not self.fsdp_modules:
            return
        for value in vars(state).values():
            for i, group in enumerate(getattr(value, "param_groups", ())):
                if len({_is_dtensor(p) for p in group["params"]}) > 1:
                    self._foreach_was.setdefault((id(value), i), group.get("foreach"))
                    group["foreach"] = False

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        """The train step's collectives (:func:`current` is this mesh)."""
        self.in_step = True
        try:
            yield
        finally:
            self.in_step = False

    def train_step(self, state, batch):
        """The task's step on this rank's rows, its logs averaged over
        ``data`` (so every rank logs, and guards on, the global values)."""
        with self.step():
            state, logs = self.task.train_step(state, batch)
        if self.data_size > 1 and logs:
            keys = [k for k, v in logs.items() if isinstance(v, torch.Tensor)]
            stacked = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
            dist.all_reduce(stacked, group=self.data_group)
            stacked /= self.data_size
            logs = dict(logs, **{k: stacked[i] for i, k in enumerate(keys)})
        return state, logs

    def eval_step(self, state, batch):
        """The task's eval step on this rank's rows: no collective over
        ``data`` (TP's over ``model`` only), so uneven splits cannot hang."""
        return self.task.eval_step(state, batch)

    @contextlib.contextmanager
    def evaluation(self) -> Iterator[None]:
        """FSDP2's modules stay gathered for an evaluation: its forwards
        then need no collective over ``data``."""
        for module in self.fsdp_modules:
            module.unshard()
            module.set_reshard_after_forward(False)
        try:
            yield
        finally:
            for module in self.fsdp_modules:
                module.reshard()
                module.set_reshard_after_forward(True)

    def average_gradients(self, params: Sequence[torch.Tensor]) -> None:
        if self.data_size == 1:
            return
        t0 = None
        if self.time_collectives:
            _sync_all(params)
            t0 = time.perf_counter()
        def mean(flat):
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.data_size

        grads = [p.grad for p in params if p.grad is not None and not _is_dtensor(p.grad)]
        self.allreduce_bytes += _bucketed(grads, mean)
        if t0 is not None:
            _sync_all(params)
            self.allreduce_seconds += time.perf_counter() - t0

    # ---------------------------------------------------------------- #
    # control plane

    def agree_any(self, *flags: bool) -> Tuple[bool, ...]:
        """Each flag or-ed over every rank."""
        if self._control is None:
            return tuple(bool(f) for f in flags)
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._control)
        return tuple(bool(v) for v in t.tolist())

    def first_reason(self, reason: Optional[str]) -> Optional[str]:
        """The first rank's non-None ``reason``, on every rank."""
        if self._control is None:
            return reason
        out: List[Optional[str]] = [None] * self.world
        dist.all_gather_object(out, reason, group=self._control)
        return next((r for r in out if r is not None), None)

    def gather_data(self, obj: Any) -> List[Any]:
        """``obj`` of every ``data`` rank, in rank order."""
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, (self.model_rank, obj), group=self._control)
        return [o for m, o in out if m == 0]

    def reduce_sums(self, sums: Dict[str, float], count: int) -> Tuple[Dict[str, float], int]:
        """A loader's metric sums and batch count summed over ``data``."""
        if self.world == 1:
            return sums, count
        total: Dict[str, float] = {}
        n = 0
        for s, c in self.gather_data((sums, count)):
            n += c
            for k, v in s.items():
                total[k] = total.get(k, 0.0) + v
        return total, n

    def barrier(self) -> None:
        if self._control is not None:
            dist.barrier(group=self._control)

    # ---------------------------------------------------------------- #
    # full states for checkpoints

    def _specs(self, state) -> Tuple[Dict[str, Dict[str, int]], Dict[str, List[Optional[int]]]]:
        """Per state field: module parameter name -> TP dimension, and
        optimizer parameter index -> TP dimension (None: not split)."""
        module_dims: Dict[str, Dict[str, int]] = {}
        optim_dims: Dict[str, List[Optional[int]]] = {}
        by_param: Dict[int, int] = {}
        for field, value in vars(state).items():
            if isinstance(value, nn.Module):
                dims = _tp_dims(value)
                module_dims[field] = dims
                named = dict(value.named_parameters())
                for name, dim in dims.items():
                    by_param[id(named[name])] = dim
        for field, value in vars(state).items():
            if hasattr(value, "param_groups"):
                optim_dims[field] = [by_param.get(id(p)) for g in value.param_groups for p in g["params"]]
        return module_dims, optim_dims

    def _gather_tp(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """A split tensor whole: FSDP2's shard over ``data``, then the TP
        split over ``model``."""
        if _is_dtensor(t):
            (placement,) = t.placements
            t = _gather(t.to_local(), placement.dim, t.shape[placement.dim], t.device_mesh.get_group(),
                        t.device_mesh.get_local_rank(), t.device_mesh.size())
        if dim is None or self.model_size == 1:
            return t
        return _gather(t, dim, t.shape[dim] * self.model_size, self.model_group, self.model_rank,
                       self.model_size)

    def _cut(self, full: torch.Tensor, like: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's part of ``full`` in the layout of the live ``like``."""
        part = full
        if dim is not None and self.model_size > 1:
            width = full.shape[dim] // self.model_size
            part = full.narrow(dim, self.model_rank * width, width)
        if _is_dtensor(like):
            from torch.distributed.tensor import DTensor

            (placement,) = like.placements
            mesh = like.device_mesh
            chunk = -(-part.shape[placement.dim] // mesh.size())
            start = min(mesh.get_local_rank() * chunk, part.shape[placement.dim])
            local = part.narrow(placement.dim, start, min(chunk, part.shape[placement.dim] - start))
            part = DTensor.from_local(local.to(like.device, like.dtype).contiguous(), mesh, like.placements,
                                      run_check=False, shape=like.shape, stride=like.stride())
        return part

    def full_state_dict(self, state) -> Dict[str, Any]:
        """``state.state_dict()`` with every split tensor whole (a
        collective: every rank calls it)."""
        sd = state.state_dict()
        if self.world == 1:
            return sd
        module_dims, optim_dims = self._specs(state)
        out = dict(sd)
        for field, value in sd.items():
            if field in module_dims:
                dims = module_dims[field]
                out[field] = {k: self._gather_tp(v, dims.get(k)) if isinstance(v, torch.Tensor) else v
                              for k, v in value.items()}
            elif field in optim_dims:
                out[field] = _map_optimizer_tensors(
                    value, lambda i, t, d=optim_dims[field]: self._gather_tp(t, d[i]))
                live = id(getattr(state, field))  # the groups as the task made them
                out[field]["param_groups"] = [
                    dict(g, foreach=self._foreach_was[(live, i)]) if (live, i) in self._foreach_was else g
                    for i, g in enumerate(value["param_groups"])]
        return out

    def load_full_state_dict(self, state, sd: Dict[str, Any]) -> None:
        """Load a full ``sd`` into ``state``, each rank keeping its part."""
        if self.world == 1:
            state.load_state_dict(sd)
            return
        module_dims, optim_dims = self._specs(state)
        out = dict(sd)
        for field, value in sd.items():
            live = getattr(state, field, None)
            if field in module_dims:
                dims, live_sd = module_dims[field], live.state_dict()
                out[field] = {k: self._cut(v, live_sd[k], dims.get(k)) if isinstance(v, torch.Tensor) else v
                              for k, v in value.items()}
            elif field in optim_dims:
                params = [p for g in live.param_groups for p in g["params"]]
                dims = optim_dims[field]
                out[field] = _map_optimizer_tensors(value, lambda i, t: self._cut(t, params[i], dims[i]))
        state.load_state_dict(out)
        self._per_tensor_steps(state)

    def checkpoint_view(self, state) -> "_FullView":
        return _FullView(self, state)

    def local_view(self, state) -> "_LocalView":
        return _LocalView(state)


def _map_optimizer_tensors(osd: Dict[str, Any], fn) -> Dict[str, Any]:
    """An optimizer state dict (``MultiSteps``' ``acc`` too) with ``fn(index,
    tensor)`` applied to each parameter-shaped state tensor (not the
    0-dim step counts)."""
    out = dict(osd)
    for key in ("state", "acc"):
        if key not in osd:
            continue
        entries = {}
        for i, entry in osd[key].items():
            if isinstance(entry, torch.Tensor):
                entries[i] = fn(int(i), entry) if entry.dim() > 0 else entry
            else:
                entries[i] = {k: fn(int(i), v) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                              for k, v in entry.items()}
        out[key] = entries
    return out


def _sync_all(params) -> None:
    for p in params:
        if p.device.type == "cuda":
            torch.cuda.synchronize(p.device)
            return


class _FullView:
    """A train state seen whole: ``state_dict`` gathers, ``load_state_dict``
    cuts (for ``CheckpointManager``)."""

    def __init__(self, mesh: DataParallel, state):
        self.mesh, self.state = mesh, state

    def state_dict(self) -> Dict[str, Any]:
        return self.mesh.full_state_dict(self.state)

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.mesh.load_full_state_dict(self.state, sd)


class _LocalView:
    """A train state's own tensors on this rank (FSDP2's local shards), for
    the failure guard's scan."""

    def __init__(self, state):
        self.state = state

    def state_dict(self) -> Dict[str, Any]:
        def local(tree):
            if _is_dtensor(tree):
                return tree.to_local()
            if isinstance(tree, dict):
                return {k: local(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(local(v) for v in tree)
            return tree

        return local(self.state.state_dict())
