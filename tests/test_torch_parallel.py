"""PyTorch port: the parallel layer, W gloo ranks on the CPU against one rank.

The ranks are spawned once per group (a module fixture, ``file://``
rendezvous under a temporary directory), run every case of
``torch_parallel_support`` and save rank 0's results; each test compares
them with the same task run in this process on the concatenated global
batch.  SGD, as the JAX package's equivalence tests use and for their
reason: Adam's first steps move a parameter by about lr whatever the size
of its gradient, so a gradient that is zero up to rounding (an attention
key bias, which cancels in the softmax) moves in a direction set by that
rounding.  JAX's tolerances: parameters rtol 1e-5 / atol 1e-6 (CTC atol
1e-5), logs 1e-4 relative.

No JAX here (``tests/test_torch_parallel_jax.py`` holds the comparisons
with the JAX tasks): the children import only torch and the port.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_support as support
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)
from vibravox_tpu_torch.core.optim import MultiSteps, sgd

TWO_RANKS = [
    dict(name="eben_open", task="eben", steps=2, batch=2, mesh={"data": 2}),
    dict(name="eben_gated", task="eben", steps=2, batch=2, mesh={"data": 2}, task_kw={"ratio": 0.5}),
    dict(name="fsdp_sgd", task="stp", steps=2, batch=4, mesh={"data": 2, "fsdp": True, "fsdp_min_size": 0}),
    dict(name="mimi_fsdp", task="mimi", steps=2, batch=4, mesh={"data": 2, "fsdp": True, "fsdp_min_size": 0}),
    dict(name="fsdp_adam", task="stp", steps=1, batch=4, optimizer="adam", local=True, all_ranks=True,
         mesh={"data": 2, "fsdp": True, "fsdp_min_size": 1024}),
    dict(name="spkv", kind="eval", task="spkv", n=12, mesh={"data": 2}, all_ranks=True),
    dict(name="uneven", kind="eval", task="bwe", n=5, mesh={"data": 2}, all_ranks=True),
    dict(name="uneven_fsdp", kind="eval", task="stp", n=5, all_ranks=True,
         mesh={"data": 2, "fsdp": True, "fsdp_min_size": 0}),
    dict(name="preempt", kind="preempt", mesh={"data": 2}, all_ranks=True),
    dict(name="roundtrip_fsdp", task="stp", steps=1, batch=4, optimizer="adam",
         mesh={"data": 2, "fsdp": True, "fsdp_min_size": 0}),
    dict(name="roundtrip_tp", task="stp", steps=1, batch=4, optimizer="adam", mesh={"data": 1, "model": 2}),
]
FOUR_RANKS = [
    dict(name="ctc_2x2", task="stp", steps=2, batch=4, mesh={"data": 2, "model": 2}),
    dict(name="ctc_1x4", task="stp", steps=2, batch=4, mesh={"data": 1, "model": 4}),
    dict(name="mimi_2x2", task="mimi", steps=2, batch=4, mesh={"data": 2, "model": 2}),
    dict(name="roundtrip", task="stp", steps=1, batch=4, optimizer="adam",
         mesh={"data": 2, "model": 2, "fsdp": True, "fsdp_min_size": 0}),
]
CASES = {c["name"]: c for c in TWO_RANKS + FOUR_RANKS}
ROUND_TRIPS = ("roundtrip_fsdp", "roundtrip_tp", "roundtrip")  # FSDP2 and TP at 2 ranks, both at 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's results: 2 ranks, then 4 (the round trip's
    ``from_one.pt``, a one-rank state, is written before)."""
    tmp = tmp_path_factory.mktemp("parallel")
    rt = tmp / "roundtrip"
    rt.mkdir()
    one = support.make_task(CASES["roundtrip"])
    state = one.init_state(0)
    for batch in support.BATCHES["stp"](1, 4, seed=99):
        state, _ = one.train_step(state, batch)
    torch.save(state.state_dict(), rt / "from_one.pt")
    for name in ROUND_TRIPS:
        CASES[name]["roundtrip"] = str(rt)
    CASES["preempt"]["dir"] = str(tmp / "preempt")
    out = support.spawn(2, TWO_RANKS, tmp / "two")
    out.update(support.spawn(4, FOUR_RANKS, tmp / "four"))
    out["roundtrip_dir"] = rt
    return out


def _assert_trees_close(got, want, rtol=1e-5, atol=1e-6, skip=(), path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], rtol, atol, skip, f"{path}.{k}")
    elif isinstance(want, np.ndarray) and want.dtype.kind == "f":
        if not any(s in path for s in skip):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif not callable(want):
        assert got == want, path


def _assert_logs_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-6), k


def _gate_draws(n: int, ratio: float, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return [bool(torch.rand((), generator=gen) < ratio) for _ in range(n)]


@pytest.mark.parametrize("name", ["eben_open", "eben_gated"])
def test_eben_over_two_data_ranks_matches_one_rank(runs, name):
    """The GAN step at data=2: balancing on the global gradients, global
    STFT and feature-matching ratios, one gate draw on every rank."""
    case = CASES[name]
    if name == "eben_gated":
        assert set(_gate_draws(case["steps"], 0.5)) == {True, False}  # open and closed steps
    want = support.single_run(case)
    got = runs[name]
    assert got["mesh"][:2] == (2, 1)
    _assert_logs_close(got["logs"], want["logs"])
    _assert_trees_close(got["state"], want["state"])


@pytest.mark.parametrize("name", ["ctc_2x2", "ctc_1x4"])
def test_ctc_with_dropout_and_masking_matches_one_rank(runs, name):
    """wav2vec2-CTC with dropout, SpecAugment and layerdrop on: at (2, 2)
    every block splits over ``model``; at (1, 4) the 2-head attention
    stays whole and the feed-forward splits.  Masks are drawn over the
    global batch and the full widths."""
    case = CASES[name]
    want = support.single_run(case)
    got = runs[name]
    assert got["mesh"][:2] == (case["mesh"]["data"], case["mesh"]["model"])
    _assert_logs_close(got["logs"], want["logs"])
    _assert_trees_close(got["state"], want["state"], atol=1e-5)


def test_mimi_over_2x2_matches_one_rank(runs):
    want = support.single_run(CASES["mimi_2x2"])
    got = runs["mimi_2x2"]
    _assert_logs_close(got["logs"], want["logs"])
    _assert_trees_close(got["state"], want["state"])


@pytest.mark.parametrize("name", ["fsdp_sgd", "mimi_fsdp"])
def test_fsdp_stp_matches_one_rank(runs, name):
    """FSDP2 over data=2, every rank-2 leaf sharded (``fsdp_min_size=0``):
    STP, and Mimi, whose frozen copy is taken whole before the sharding
    and whose ``encode_to_latent`` / ``decode_latent`` gather."""
    want = support.single_run(CASES[name])
    got = runs[name]
    _assert_logs_close(got["logs"], want["logs"])
    _assert_trees_close(got["state"], want["state"], atol=1e-5)


def test_fsdp_adam_holds_sharded_leaves_and_moments_at_half(runs):
    """One Adam step at data=2 with ``fsdp_min_size=1024``: the rank-2
    leaves of at least 1024 elements are DTensors at half their rows or
    columns on each rank (``fsdp_spec``'s dimension), with their Adam
    moments alike; the rest stay whole.  The step equals one rank's but
    for the attention key biases, whose gradient is zero up to rounding
    (module docstring)."""
    from vibravox_tpu_torch.parallel.fsdp import torch_fsdp_dim

    task = support.make_task(CASES["fsdp_adam"])
    full = dict(task.wav2vec2_for_ctc.named_parameters())
    index = {name: i for i, name in enumerate(full)}
    for r in (0, 1):
        got = runs["fsdp_adam" if r == 0 else "fsdp_adam.1"]
        assert got["mesh"] == (2, 1, r, 0)
        sharded = 0
        for name, p in full.items():
            dim = torch_fsdp_dim(tuple(p.shape), 2, None, 1024)
            local = got["local_shapes"]["model"][name]
            want = list(p.shape)
            if dim is not None:
                want[dim] //= 2
                sharded += 1
            assert local == tuple(want), name
            if dim is not None or index[name] in got["moment_shapes"]:  # the frozen conv trunk has none
                assert got["moment_shapes"][index[name]] == tuple(want), name
            assert got["dtensor"][name] == ("DTensor" if dim is not None else "Parameter"), name
        assert sharded >= 8  # q/k/v/out, intermediate/output of each layer, the head
    want = support.single_run(CASES["fsdp_adam"])
    _assert_logs_close(runs["fsdp_adam"]["logs"], want["logs"])
    _assert_trees_close(runs["fsdp_adam"]["state"], want["state"], atol=1e-5, skip=("k_proj.bias",))


@pytest.mark.parametrize("name", ROUND_TRIPS)
@pytest.mark.parametrize("direction", ["ranks_to_one", "one_to_ranks"])
def test_checkpoint_moves_between_ranks_and_one(runs, direction, name):
    """STP with Adam under FSDP2 at data=2, TP at model=2, and both at
    (2, 2).  A full state gathered at the ranks loads into a one-rank task
    and comes back out bit-equal; a one-rank state cut into the ranks
    gathers back bit-equal."""
    rt = runs["roundtrip_dir"]
    if direction == "ranks_to_one":
        full = torch.load(rt / f"{name}.from_ranks.pt", weights_only=True)
        task = support.make_task(CASES["roundtrip"])
        state = task.init_state(0)
        state.load_state_dict(full)
        _assert_trees_close(support.to_numpy(state.state_dict()), support.to_numpy(full), rtol=0, atol=0)
        assert full["step"] == 1 and len(full["optimizer"]["state"]) > 0
    else:
        want = support.to_numpy(torch.load(rt / "from_one.pt", weights_only=True))
        _assert_trees_close(runs[name]["reloaded"], want, rtol=0, atol=0)


def test_spkv_over_two_ranks_gives_one_ranks_eer(runs):
    """Each rank embeds its trials; the EER and minDCF come from every
    rank's scores, gathered, and equal one rank's."""
    want = support.single_eval(CASES["spkv"])
    for key in ("spkv", "spkv.1"):
        got = runs[key]["metrics"]
        assert set(got) == set(want)
        for k in ("test/equal_error_rate", "test/minimum_dcf", "test/eer_threshold"):
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k


@pytest.mark.parametrize("name", ["uneven", "uneven_fsdp"])
def test_uneven_eval_split_evaluates_each_utterance_once(runs, name):
    """Five test utterances at batch 1 on two ranks: three and two, every
    utterance once, no hang, and the means of one rank; also under FSDP2,
    whose modules stay gathered for the evaluation (STP: CTC loss, CER)."""
    assert (runs[name]["rows"], runs[f"{name}.1"]["rows"]) == (3, 2)
    want = support.single_eval(CASES[name])
    for key in (name, f"{name}.1"):
        got = runs[key]["metrics"]
        assert set(got) == set(want) and want
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_a_signal_on_one_rank_stops_every_rank_after_the_same_step(runs):
    """Rank 1 alone is signalled during its first step: both ranks stop
    after that step and save ``last`` with the previous epoch's marker."""
    for key in ("preempt", "preempt.1"):
        got = runs[key]
        assert got["global_step"] == 1 and got["signum"] is not None
        assert got["saved"] == {"epoch": -1, "global_step": 1}


# --------------------------------------------------------------------------- #
# The loaders' shards
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n,world", [(16, 2), (17, 2), (10, 4), (5, 2)])
def test_epoch_shards_are_disjoint_and_cover_the_split(monkeypatch, n, world):
    from vibravox_tpu_torch.data import bwe

    taken, eval_taken = [], []
    for rank in range(world):
        monkeypatch.setattr(bwe, "data_shard", lambda r=rank: (r, world))
        sampler = bwe._EpochBatches(n, 1, seed=3)
        sampler.set_epoch(2)
        batches = list(sampler)
        assert len(batches) == len(sampler) == len(range(rank, n, world))
        taken += [k[0] for b in batches for k in b]
        assert {k[2] for b in batches for k in b} == {b * world + rank for b in range(len(batches))}
        eval_taken += [k[0] for b in bwe.eval_keys(n) for k in b]
    assert sorted(taken) == list(range(n)) and sorted(eval_taken) == list(range(n))
    monkeypatch.setattr(bwe, "data_shard", lambda: (0, 1))
    one = [k[0] for b in bwe._EpochBatches(n, 1, seed=3) for k in b]
    perm = np.arange(n)
    np.random.default_rng((3, 0)).shuffle(perm)
    assert one == list(perm)  # one rank: the permutation as before


def test_stream_rows_are_strided_over_the_ranks(monkeypatch):
    from vibravox_tpu_torch.data import bwe

    class Rows:
        def rows(self):
            return iter(range(10))

        def decode(self, row):
            return row

    class Collate:
        def keyed(self, items, key, indices):
            return items

    got = []
    for rank in range(2):
        monkeypatch.setattr(bwe, "data_shard", lambda r=rank: (r, 2))
        stream = bwe._StreamBatches(Rows(), Collate(), 1, shuffle=False, drop_last=False, seed=0)
        got.append([row for batch in stream for row in batch])
    assert got == [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]


# --------------------------------------------------------------------------- #
# Accumulation (the JAX comparisons are in test_torch_parallel_jax.py)
# --------------------------------------------------------------------------- #


def test_closed_gate_freezes_the_discriminators_accumulation():
    """k = 2 with a gate open on some steps: the discriminator's running
    mean and count advance on open steps only, and its parameters move on
    every second open step."""
    task = support.eben_task(ratio=0.5, accumulate=2, optimizer=sgd(1e-3))
    state = task.init_state(0)
    opt = state.discriminator_optimizer
    assert isinstance(opt, MultiSteps)
    gates = _gate_draws(4, 0.5)
    assert gates.count(True) >= 2 and False in gates
    opened = 0
    for gate, batch in zip(gates, support.eben_batches(4, 1)):
        before = [p.detach().clone() for p in task.discriminator.parameters()]
        state, _ = task.train_step(state, batch)
        moved = any(not torch.equal(a, p) for a, p in zip(before, task.discriminator.parameters()))
        opened += gate
        assert moved == (gate and opened % 2 == 0)
        assert opt.mini_step == opened % 2
        assert (len(opt.acc) > 0) == (opened % 2 == 1)
    assert state.generator_optimizer.mini_step == 4 % 2


def test_multisteps_state_round_trip_mid_accumulation():
    """A state saved between micro-batches resumes to the same parameters."""
    def run(split):
        task = support.stp_task(dropout=False, optimizer=sgd(1e-2), accumulate=2)
        state = task.init_state(0)
        batches = support.stp_batches(3, 2)
        for i, batch in enumerate(batches):
            if i == split:
                sd = state.state_dict()
                task = support.stp_task(dropout=False, optimizer=sgd(1e-2), accumulate=2)
                state = task.init_state(0)
                state.load_state_dict(sd)
            state, _ = task.train_step(state, batch)
        return support.to_numpy(state.model.state_dict())

    _assert_trees_close(run(split=1), run(split=-1), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The CLI over two ranks
# --------------------------------------------------------------------------- #


def test_cli_fits_resumes_and_tests_over_two_ranks(tmp_path):
    """``torch.distributed.run --nproc_per_node 2`` over gloo: one
    checkpoint directory of full tensors, rank 0's CSV, a resumed second
    epoch, and a test pass after each."""
    args = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
            "-m", "vibravox_tpu_torch.run",
            "lightning_datamodule=bwe", "lightning_module=eben", "callbacks=bwe_checkpoint",
            "logging=csv", "lightning_datamodule.dataset_name_principal=synthetic",
            "~lightning_datamodule.data_augmentation", "++lightning_datamodule.synthetic_size=2",
            "++lightning_datamodule.batch_size=1", "++lightning_datamodule.num_workers=0",
            "++lightning_datamodule.collate_strategy=constant_length-254-ms",
            "++trainer.limit_val_batches=1", "++trainer.limit_test_batches=1",
            "++lightning_module.compute_dtype=null", "++lightning_module.discriminator.min_channels=8",
            f"++run_dir={tmp_path}", "++device=cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    for epochs in (1, 2):
        done = subprocess.run(args + [f"++trainer.max_epochs={epochs}"], env=env, capture_output=True,
                              text=True, timeout=240)
        assert done.returncode == 0, done.stderr[-4000:]
    ckpt = tmp_path / "checkpoints"
    assert (ckpt / "last" / "state.pt").exists()
    progress = (ckpt / "trainer_state.json").read_text()
    # 2 utterances, batch 1 a rank: a step an epoch
    assert '"epoch": 1' in progress and '"global_step": 2' in progress
    lines = (tmp_path / "csv" / "metrics.csv").read_text().splitlines()
    assert "test/torchmetrics_stoi" in lines[0] and "validation/torchmetrics_stoi" in lines[0]
    full = torch.load(ckpt / "last" / "state.pt", weights_only=True)
    assert full["step"] == 2 and full["generator"]["last_conv.weight"].shape[0] == 4
