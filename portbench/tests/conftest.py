"""CPU rehearsal of the benchmark: its cells at tiny sizes, on the program's
plain CPU paths (run from the repository root: ``python -m pytest
portbench/tests``)."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SEED = 2**31 + 977  # the driver's seeds are this large


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def tiny(cell: harness.Cell, float32: bool = True) -> harness.Cell:
    """``cell`` at a size a CPU test holds: EBEN at full generator width on
    0.3 s crops, batch 2, a narrow discriminator and one STFT resolution;
    wav2vec2 at the port's tiny widths on 0.5-1 s utterances.  ``float32``
    trains in float32 (the CPU's bfloat16 convolutions are not the card's)."""
    cfg, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    if cfg["adapter"] == "eben_m4_n32_p2":
        cfg["discriminator"]["min_channels"] = 8
        cfg["stft_loss"].update(fft_sizes=[512], hop_sizes=[50], win_lengths=[240])
        if float32:
            cfg["train"]["compute_dtype"] = None
        mix.update(batch=2, pool_batches=4, min_s=0.3, max_s=0.3)
    else:
        cfg["model"].update(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
                            conv_dim=[32] * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=2)
        mix.update(batch=2, pool_batches=4, min_s=0.5, max_s=1.0, bucket_samples=16000)
    return dataclasses.replace(cell, config=cfg, mix=mix)


def cell_named(name: str) -> harness.Cell:
    """A cell of BENCHMARK.json."""
    return harness.resolve(harness.load_spec(ROOT), name, ROOT)


def run_cpu(cell: harness.Cell, seconds: float = 1.0, seed: int = SEED):
    import time

    return harness.run(cell, seed, seconds, False, torch.device("cpu"), time.perf_counter())
