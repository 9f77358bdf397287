"""Tensor parallelism over ``model``: Megatron's column and row split (PyTorch).

Counterpart of ``vibravox_tpu/parallel/tp.py``.  :func:`transformer_tp_spec`
is the JAX package's placement as a pure function, in its layout (a dense
kernel is ``(in, out)``, a scanned stack's ``(L, in, out)``): the attention
q / k / v and feed-forward-in projections are column-parallel (output
features sharded, their bias too), attention-out and feed-forward-out are
row-parallel (input features sharded, bias replicated).

The port shards explicitly, because its attention and feed-forward blocks
call ``F.linear`` on the weights instead of the modules
(``models/wav2vec2.py``, ``models/mimi/transformer.py``):
:func:`shard_transformer_` replaces each projection's weight (and a
column-parallel bias) with this rank's slice and sets the module's
``tp_attention`` or ``tp_ffn`` (a :class:`ModelShard`).  The block then runs, as in Megatron:
``enter`` (identity forward, all-reduce of the input's gradient) before the
column-parallel products, ``num_heads / M`` local heads, and ``exit`` (the
all-reduce of the partial sums, identity backward) after the row-parallel
product, before its bias.  A block stays replicated when M does not divide
its heads (or its hidden width): GSPMD reshards such a leaf, the port
leaves the whole block whole.

Each split ``Linear`` records its split dimensions in ``_tp_dims``, which
the mesh's checkpoint path reads to gather full tensors and to cut them
again.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["transformer_tp_spec", "torch_tp_dim", "ModelShard", "shard_transformer_"]

Spec = Tuple[Optional[str], ...]

# column-parallel: output features sharded (kernel dim 1, bias dim 0)
_COLUMN = {"q_proj", "k_proj", "v_proj", "intermediate_dense", "linear1"}
# row-parallel: input features sharded (kernel dim 0); bias replicated
_ROW = {"out_proj", "output_dense", "linear2"}
# WavLM's gated relative-position attention (models/wavlm.py): a split would
# have to cut its gate's constant, its bucket table and P to a rank's heads too
_WAVLM_GATE = {"gru_rel_pos_linear", "gru_rel_pos_const", "rel_attn_embed"}
_WAVLM_REFUSED = "WavLM's gated relative-position attention is not split over model: run it with model = 1"


def transformer_tp_spec(path_names: Sequence[str], shape: Tuple[int, ...], model_size: int) -> Spec:
    """The placement of one leaf, matched on its trailing ``(module,
    param)`` names (``kernel`` / ``bias``, JAX layout): a tuple of axis
    names as ``PartitionSpec``, ``()`` for replicated.  Over a model axis,
    a path through WavLM's gate raises ``NotImplementedError``."""
    if model_size <= 1 or len(path_names) < 2:
        return ()
    if _WAVLM_GATE.intersection(path_names):
        raise NotImplementedError(_WAVLM_REFUSED)
    mod, name = path_names[-2], path_names[-1]
    if mod in _COLUMN:
        if name == "kernel" and len(shape) == 2 and shape[1] % model_size == 0:
            return (None, "model")
        if name == "kernel" and len(shape) == 3 and shape[2] % model_size == 0:
            return (None, None, "model")
        if name == "bias" and len(shape) == 1 and shape[0] % model_size == 0:
            return ("model",)
        if name == "bias" and len(shape) == 2 and shape[1] % model_size == 0:
            return (None, "model")
    elif mod in _ROW:
        if name == "kernel" and len(shape) == 2 and shape[0] % model_size == 0:
            return ("model", None)
        if name == "kernel" and len(shape) == 3 and shape[1] % model_size == 0:
            return (None, "model", None)
    return ()


def torch_tp_dim(module_name: str, param_name: str, shape: Tuple[int, ...], model_size: int,
                 spec_fn: Callable = transformer_tp_spec) -> Optional[int]:
    """The torch dimension of a ``Linear``'s ``weight`` (``(out, in)``) or
    ``bias`` that ``spec_fn`` (a task's ``partition_spec_for_path``, JAX's
    arguments) shards, or None."""
    if param_name == "weight":
        spec = tuple(spec_fn((module_name, "kernel"), tuple(reversed(shape)), model_size))
        return None if "model" not in spec else len(shape) - 1 - spec.index("model")
    spec = tuple(spec_fn((module_name, "bias"), tuple(shape), model_size))
    return None if "model" not in spec else spec.index("model")


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Exit(torch.autograd.Function):
    """The partial products summed over the model group; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelShard:
    """This rank's place on the ``model`` axis and the collectives of a
    split block."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def __deepcopy__(self, memo):  # a module copy shares the axis
        return self

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self.group)

    def columns(self, full: int) -> slice:
        width = full // self.size
        return slice(self.rank * width, (self.rank + 1) * width)

    def split_(self, layer: nn.Linear, module_name: str, spec_fn: Callable = transformer_tp_spec) -> None:
        """``layer``'s weight (and a column-parallel bias) replaced by this
        rank's slice, as ``spec_fn`` places it; ``layer._tp_dims`` records
        each split parameter's dimension (a module copy keeps it)."""
        layer._tp_dims = {}
        with torch.no_grad():
            for pname in ("weight", "bias"):
                p = getattr(layer, pname, None)
                dim = None if p is None else torch_tp_dim(module_name, pname, tuple(p.shape), self.size, spec_fn)
                if dim is None:
                    continue
                cols = self.columns(p.shape[dim])
                part = nn.Parameter(p.narrow(dim, cols.start, cols.stop - cols.start).clone(),
                                    requires_grad=p.requires_grad)
                setattr(layer, pname, part)
                layer._tp_dims[pname] = dim


def _splittable(block: nn.Module, names: Sequence[str], size: int, spec_fn: Callable) -> bool:
    return all(torch_tp_dim(name, "weight", tuple(getattr(block, name).weight.shape), size, spec_fn) is not None
               for name in names)


def shard_transformer_(model: nn.Module, shard: ModelShard, spec_fn: Callable = transformer_tp_spec) -> int:
    """Split, in place, every attention block (``q_proj`` / ``k_proj`` /
    ``v_proj`` / ``out_proj`` and ``num_heads``) whose heads and widths
    ``shard.size`` divides, setting the module's ``tp_attention``, and every
    feed-forward block (``intermediate_dense`` / ``output_dense`` or
    ``linear1`` / ``linear2``) whose widths it divides, setting its
    ``tp_ffn``.  Returns the number of blocks split.  A WavLM attention
    block raises ``NotImplementedError``."""
    if shard.size <= 1:
        return 0
    split = 0
    for module in list(model.modules()):
        if any(hasattr(module, n) for n in _WAVLM_GATE):
            raise NotImplementedError(_WAVLM_REFUSED)
        blocks = []
        if (all(hasattr(module, n) for n in ("q_proj", "k_proj", "v_proj", "out_proj", "num_heads"))
                and module.num_heads % shard.size == 0):
            blocks.append(("tp_attention", ("q_proj", "k_proj", "v_proj", "out_proj")))
        for pair in (("intermediate_dense", "output_dense"), ("linear1", "linear2")):
            if all(isinstance(getattr(module, n, None), nn.Linear) for n in pair):
                blocks.append(("tp_ffn", pair))
        for attr, names in blocks:
            if getattr(module, attr, None) is not None or not _splittable(module, names, shard.size, spec_fn):
                continue
            for name in names:
                shard.split_(getattr(module, name), name, spec_fn)
            setattr(module, attr, shard)
            split += 1
    return split
