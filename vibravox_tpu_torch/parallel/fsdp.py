"""FSDP placement: parameters and optimizer state sharded over ``data`` (PyTorch).

Counterpart of ``vibravox_tpu/parallel/fsdp.py``.  :func:`fsdp_spec` is the
JAX package's rule as a pure function on shapes, in its layout (a dense
kernel is ``(in, out)``): only rank-2 leaves of at least ``min_size``
elements are sharded, on the largest dimension that the TP placement left
free and that ``data`` divides.  Everything else stays replicated.

:func:`torch_fsdp_dim` reads that rule for a torch parameter (a ``Linear``
weight is ``(out, in)``, the transpose), and ``parallel/mesh.py`` applies
it with FSDP2 (``torch.distributed.fsdp.fully_shard``, whose
``shard_placement_fn`` takes the dimension).  FSDP2 holds those
parameters, their gradients and their Adam moments at 1/W on each rank,
all-gathers them for the forward and backward, and reduce-scatters the
gradients (the mean over ``data``); the leaves it leaves alone stay
replicated under the mesh's gradient all-reduce.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["FSDP_MIN_LEAF_SIZE", "fsdp_spec", "torch_fsdp_dim"]

Spec = Tuple[Optional[str], ...]

# elements below which a leaf stays replicated (2**15 float32 = 128 KiB)
FSDP_MIN_LEAF_SIZE = 2**15


def fsdp_spec(
    shape: Tuple[int, ...],
    data_size: int,
    base_spec: Optional[Sequence[Optional[str]]] = None,
    min_size: int = FSDP_MIN_LEAF_SIZE,
) -> Spec:
    """The placement of one leaf (a tuple of axis names, trailing ``None``
    dropped, as ``PartitionSpec``): ``base_spec`` (a TP placement) with
    ``"data"`` added on the largest free dimension that divides
    ``data_size``; ``base_spec`` unchanged when the leaf is not rank 2, is
    smaller than ``min_size`` or has no such dimension."""
    base = list(base_spec) if base_spec is not None else []
    base += [None] * (len(shape) - len(base))

    def done() -> Spec:
        while base and base[-1] is None:
            base.pop()
        return tuple(base)

    if len(shape) != 2 or data_size <= 1:
        return done()
    if shape[0] * shape[1] < min_size:
        return done()
    candidates = [i for i, d in enumerate(shape) if base[i] is None and d % data_size == 0]
    if not candidates:
        return done()
    base[max(candidates, key=lambda i: shape[i])] = "data"
    return done()


def torch_fsdp_dim(shape: Tuple[int, ...], data_size: int, tp_dim: Optional[int] = None,
                   min_size: int = FSDP_MIN_LEAF_SIZE) -> Optional[int]:
    """The dimension of a torch parameter of full ``shape`` that FSDP
    shards, or None.  A rank-2 parameter is a ``Linear`` weight, the
    transpose of the JAX kernel; ``tp_dim`` is the torch dimension its TP
    placement shards."""
    if len(shape) != 2:
        return None
    jax_shape = (shape[1], shape[0])
    base = [None, None]
    if tp_dim is not None:
        base[1 - tp_dim] = "model"
    spec = list(fsdp_spec(jax_shape, data_size, base, min_size)) + [None, None]
    if "data" not in spec:
        return None
    return 1 - spec.index("data")
