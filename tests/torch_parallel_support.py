"""Multi-process cases of the port's parallel layer, for ``tests/test_torch_parallel.py``.

Each case builds a tiny task from a seed, runs it over a mesh of W gloo
ranks on the CPU, and writes what rank 0 saw (logs, the full state) with
``torch.save``; the test runs the same task in one process on the
concatenated global batch and compares.  The task and batch factories here serve
both sides.  No JAX: the children import only torch and the port.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from vibravox_tpu_torch.core.optim import adam, sgd
from vibravox_tpu_torch.parallel.distributed import initialize_distributed
from vibravox_tpu_torch.parallel.mesh import DataParallel, MeshConfig, build_mesh

DROPOUT = dict(hidden_dropout=0.1, activation_dropout=0.1, feat_proj_dropout=0.1, mask_time_prob=0.3,
               mask_time_length=4, mask_feature_prob=0.2, mask_feature_length=4, layerdrop=0.3)


# --------------------------------------------------------------------------- #
# Tasks and batches, made alike in every process
# --------------------------------------------------------------------------- #


def eben_task(ratio: float = 1.0, accumulate: int = 1, optimizer=None):
    from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
    from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
    from vibravox_tpu_torch.models.eben_generator import EBENGenerator
    from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
    from vibravox_tpu_torch.tasks.eben import EBENTask

    torch.manual_seed(0)
    opt = optimizer or sgd(1e-2)
    return EBENTask(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=1, min_channels=8, device="cpu"),
        generator_optimizer=opt, discriminator_optimizer=opt,
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss((512,), (50,), (240,), device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(), adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema", update_discriminator_ratio=ratio,
        accumulate_grad_batches=accumulate, device="cpu")


def eben_batches(steps: int, batch: int, t: int = 4064, seed: int = 7) -> List[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ref = rng.standard_normal((batch, t, 1)).astype(np.float32) * 0.1
        noise = rng.standard_normal((batch, t, 1)).astype(np.float32) * 0.01
        out.append({"audio_body_conducted": torch.from_numpy(ref * 0.5 + noise),
                    "audio_airborne": torch.from_numpy(ref)})
    return out


def stp_task(dropout: bool = True, optimizer=None, accumulate: int = 1, **overrides):
    from vibravox_tpu_torch.models.wav2vec2 import wav2vec2_for_ctc_from_config
    from vibravox_tpu_torch.tasks.wav2vec2_stp import Wav2Vec2STPTask

    quiet = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
                 mask_feature_prob=0.0, layerdrop=0.0)
    kw = dict(DROPOUT if dropout else quiet, **overrides)
    model = wav2vec2_for_ctc_from_config(preset="tiny", seed=3, device="cpu", **kw)
    return Wav2Vec2STPTask(wav2vec2_for_ctc=model, optimizer=optimizer or sgd(1e-2),
                           accumulate_grad_batches=accumulate, device="cpu")


def stp_batches(steps: int, batch: int, t: int = 6400, seed: int = 11) -> List[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        labels = rng.integers(0, 35, (batch, 6)).astype(np.int64)
        labels[::2, 4:] = -100
        out.append({"audio": torch.from_numpy(rng.standard_normal((batch, t)).astype(np.float32)),
                    "phonemes_ids": torch.from_numpy(labels)})
    return out


def mimi_task(optimizer=None):
    from vibravox_tpu_torch.models.mimi.mimi import Mimi
    from vibravox_tpu_torch.tasks.regressive_mimi import RegressiveMimiTask

    model = Mimi(preset="tiny", seed=5, device="cpu")
    with torch.no_grad():  # layer scales of 1, so the transformers weigh in the loss
        for name, p in model.named_parameters():
            if "layer_scale" in name:
                p.fill_(1.0)
    return RegressiveMimiTask(mimi=model, optimizer=optimizer or sgd(1e-2), device="cpu")


def mimi_batches(steps: int, batch: int, t: int = 16 * 12, seed: int = 13) -> List[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ref = rng.standard_normal((batch, t, 1)).astype(np.float32) * 0.1
        out.append({"audio_body_conducted": torch.from_numpy(ref * 0.5), "audio_airborne": torch.from_numpy(ref)})
    return out


TASKS: Dict[str, Callable] = {"eben": eben_task, "stp": stp_task, "mimi": mimi_task}
BATCHES: Dict[str, Callable] = {"eben": eben_batches, "stp": stp_batches, "mimi": mimi_batches}
OPTIMIZERS = {"sgd": sgd, "adam": adam}
LEARNING_RATES = {"eben": 1e-3, "stp": 1e-3, "mimi": 1e-2}  # JAX's equivalence tests' SGD rates


def make_task(case: Dict[str, Any]):
    lr = LEARNING_RATES[case["task"]]
    return TASKS[case["task"]](optimizer=OPTIMIZERS[case.get("optimizer", "sgd")](lr),
                               **case.get("task_kw", {}))


def rows(batch: Dict[str, torch.Tensor], rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s rows of a global batch (equal shards in rank order)."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def single_run(case: Dict[str, Any]) -> Dict[str, Any]:
    """The one-process reference of a train case: the task's own steps on
    the global batches."""
    task = make_task(case)
    state = task.init_state(0)
    logs_seen = []
    for batch in BATCHES[case["task"]](case["steps"], case["batch"]):
        state, logs = task.train_step(state, batch)
        logs_seen.append({k: float(v) for k, v in logs.items()})
    return {"logs": logs_seen, "state": to_numpy(state.state_dict())}


# --------------------------------------------------------------------------- #
# The children
# --------------------------------------------------------------------------- #


def _train_case(case: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    task = make_task(case)
    config = MeshConfig(**case["mesh"])
    dp = DataParallel(task, build_mesh(config, "cpu"), fsdp=config.fsdp, fsdp_min_size=config.fsdp_min_size)
    state = dp.init_state(0)
    logs_seen = []
    for batch in BATCHES[case["task"]](case["steps"], case["batch"]):
        state, logs = dp.train_step(state, rows(batch, dp.data_rank, dp.data_size))
        logs_seen.append({k: float(v) for k, v in logs.items()})
    out = {"logs": logs_seen, "state": to_numpy(dp.full_state_dict(state)),
           "mesh": (dp.data_size, dp.model_size, dp.data_rank, dp.model_rank)}
    if case.get("local"):  # the shapes each rank holds, FSDP2's shards as local tensors
        local = dp.local_view(state).state_dict()
        out["local_shapes"] = {f: {k: tuple(v.shape) for k, v in local[f].items() if isinstance(v, torch.Tensor)}
                               for f in ("model",)}
        opt = local["optimizer"]["state"]
        out["moment_shapes"] = {i: tuple(s["exp_avg"].shape) for i, s in opt.items()}
        out["param_shapes"] = {i: tuple(p.shape) for i, p in enumerate(
            [p for g in state.optimizer.param_groups for p in g["params"]])}
        out["dtensor"] = {n: type(p).__name__ for n, p in state.model.named_parameters()}
    if case.get("roundtrip"):
        # full state out of W ranks, then back in: the gathered state again
        full = dp.full_state_dict(state)
        path = Path(case["roundtrip"])
        if rank == 0:
            torch.save(full, path / f"{case['name']}.from_ranks.pt")
        dist.barrier()
        dp.load_full_state_dict(state, torch.load(path / "from_one.pt", weights_only=True))
        out["reloaded"] = to_numpy(dp.full_state_dict(state))
    return out


def _eval_case(case: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """``Trainer.test`` over the mesh: BWE's test split at batch 1, or the
    SPKV trials."""
    from vibravox_tpu_torch.core.loop import Trainer

    task, datamodule = eval_setup(case)
    seen = []
    eval_step = task.eval_step

    def counted(state, batch):  # the rows this rank evaluates
        seen.append(next(iter(batch.values())).shape[0])
        return eval_step(state, batch)

    task.eval_step = counted
    metrics = Trainer(mesh=case["mesh"]).test(task, datamodule, ckpt_path=None)
    return {"metrics": metrics, "rows": sum(seen)}


def single_eval(case: Dict[str, Any]) -> Dict[str, float]:
    """The one-process reference of an eval case."""
    from vibravox_tpu_torch.core.loop import Trainer

    task, datamodule = eval_setup(case)
    return Trainer().test(task, datamodule, ckpt_path=None)


def eval_setup(case: Dict[str, Any]):
    if case["task"] == "stp":
        from vibravox_tpu_torch.data.stp import STPDataModule

        dm = STPDataModule(dataset_name_principal="synthetic", synthetic_size=case["n"], num_workers=0,
                           device="cpu")
        task = stp_task(dropout=False)
        task.tokenizer = dm.tokenizer
        return task, dm
    if case["task"] == "spkv":
        from vibravox_tpu_torch.data.spkv import SPKVDataModule
        from vibravox_tpu_torch.models.ecapa2 import ecapa2_from_config
        from vibravox_tpu_torch.tasks.ecapa2_spkv import SPKVTask

        torch.manual_seed(0)
        task = SPKVTask(embedder=ecapa2_from_config(preset="tiny", device="cpu"), device="cpu")
        dm = SPKVDataModule(dataset_name="synthetic", synthetic_size=case["n"], num_workers=0, device="cpu")
        return task, dm
    from vibravox_tpu_torch.data.bwe import BWEDataModule

    task = eben_task()
    dm = BWEDataModule(synthetic_size=case["n"], num_workers=0, device="cpu")
    return task, dm


def _preempt_case(case: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """``Trainer.fit`` of the EBEN task at data=2 with a checkpoint manager;
    rank 1 alone gets the preemption signal during its first step."""
    from vibravox_tpu_torch.core.checkpoint import CheckpointManager
    from vibravox_tpu_torch.core.loop import Trainer
    from vibravox_tpu_torch.data.bwe import BWEDataModule

    task = eben_task()
    dm = BWEDataModule(synthetic_size=8, batch_size=1, num_workers=0,
                       collate_strategy="constant_length-254-ms", device="cpu")
    trainer = Trainer(max_epochs=1, limit_val_batches=0, mesh=case["mesh"],
                      checkpoint=CheckpointManager(case["dir"]))
    train_step = task.train_step

    def signalled(state, batch):
        out = train_step(state, batch)
        if rank == 1:
            trainer._on_preempt(15, None)
        return out

    task.train_step = signalled
    trainer.fit(task, dm)
    return {"global_step": trainer.global_step, "signum": trainer._preempt_signum,
            "saved": CheckpointManager(case["dir"]).trainer_state()}


CASE_KINDS = {"train": _train_case, "eval": _eval_case, "preempt": _preempt_case}


def run_cases(rank: int, world: int, init_file: str, cases: List[Dict[str, Any]], out_dir: str) -> None:
    """One rank: join the gloo group, run every case, save rank 0's results."""
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{init_file}", world_size=world, rank=rank)
    try:
        for case in cases:
            result = CASE_KINDS[case.get("kind", "train")](case, rank, world)
            if rank == 0 or case.get("all_ranks"):
                torch.save(result, os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
            dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(world: int, cases: List[Dict[str, Any]], tmp: Path) -> Dict[str, Any]:
    """Run ``cases`` over ``world`` spawned ranks; returns ``{name: rank 0's
    result}`` (``name.r`` for every rank of an ``all_ranks`` case)."""
    import torch.multiprocessing as mp

    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(run_cases, args=(world, str(tmp / "rendezvous"), cases, str(tmp)), nprocs=world, join=True)
    out = {}
    for case in cases:
        for r in range(world if case.get("all_ranks") else 1):
            result = torch.load(tmp / f"{case['name']}.{r}.pt", weights_only=False)
            out[case["name"] if r == 0 else f"{case['name']}.{r}"] = result
    return out
