"""GAN losses over discriminator embedding pyramids (PyTorch).

Counterpart of ``vibravox_tpu/losses/gan.py``: the reference's
``HingeLossForDiscriminatorMelganMultiScales`` and
``FeatureLossForDiscriminatorMelganMultiScales``.  Both take the nested
embedding lists the discriminators return (input first, certainties last),
in either layout, and reduce in float32 whatever the network's dtype.
"""

from __future__ import annotations

from typing import List

import torch

from vibravox_tpu_torch.parallel.mesh import data_mean

__all__ = ["hinge_loss", "feature_matching_loss", "HingeLoss", "FeatureMatchingLoss"]


def hinge_loss(embeddings: List[List[torch.Tensor]], target: float) -> torch.Tensor:
    """Mean-over-time hinge on each scale's certainties, averaged over
    scales; ``target`` is +1 for real, -1 for fake."""
    loss = 0.0
    for scale_embedding in embeddings:
        certainties = scale_embedding[-1].float()
        loss = loss + torch.mean(torch.clamp(1.0 - target * certainties, min=0.0))
    return loss / len(embeddings)


def feature_matching_loss(
    embeddings_a: List[List[torch.Tensor]], embeddings_b: List[List[torch.Tensor]]
) -> torch.Tensor:
    """L1 between hidden layers, normalised by mean |layer_a|, averaged over
    scales x layers.  ``embeddings_a`` is the enhanced branch and gives the
    normaliser, as in the reference."""
    means = []
    for scale_a, scale_b in zip(embeddings_a, embeddings_b):
        for layer_a, layer_b in zip(scale_a[1:-1], scale_b[1:-1]):
            layer_a = layer_a.float()
            layer_b = layer_b.float()
            means += [torch.mean(torch.abs(layer_a - layer_b)), torch.mean(torch.abs(layer_a))]
    # each ratio is over the global batch: both means are taken over the
    # data ranks before the division
    means = data_mean(torch.stack(means))
    loss = 0.0
    for i in range(0, len(means), 2):
        loss = loss + means[i] / means[i + 1]
    # the reference divides by len(scale_a[1:-1]) after its loop, where
    # scale_a is the LAST scale (feature_loss.py:48); the EBEN scales differ
    # in depth, so the quirk changes the value and is kept
    n_layers_last = len(embeddings_a[-1][1:-1])
    return loss / (len(embeddings_a) * n_layers_last)


class HingeLoss:
    """Callable wrapper for config-driven instantiation."""

    def __call__(self, embeddings: List[List[torch.Tensor]], target: float) -> torch.Tensor:
        return hinge_loss(embeddings, target)


class FeatureMatchingLoss:
    """Callable wrapper for config-driven instantiation."""

    def __call__(
        self, embeddings_a: List[List[torch.Tensor]], embeddings_b: List[List[torch.Tensor]]
    ) -> torch.Tensor:
        return feature_matching_loss(embeddings_a, embeddings_b)
