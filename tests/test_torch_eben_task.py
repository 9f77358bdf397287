"""PyTorch port: the EBEN GAN train step against the JAX package.

Sizes of ``tests/test_eben_task.py``: B = 2, T = 4064, the full-width
generator, the discriminator at q = 4 / min_channels = 8, one STFT
resolution 512/50/240 with A-weighting, feature matching, hinge, EMA
balancing, in float32.  The JAX ``init_state`` is converted with
``eben_train_state_from_jax``; both sides then take three steps on the same
batch with the discriminator gate open.

The three steps use SGD (lr 1e-2) for both networks, so a parameter's
update is proportional to its gradient.  With the configured Adam (3e-4,
betas (0.5, 0.9)) the first steps move a parameter by about lr whatever its
gradient's size: discriminator gradients that agree to 3e-9 absolute (3e-6
of their largest) but are themselves near zero then move parameters in
different directions, which hides what the comparison is for.  The
configured Adam is held to optax on one step of its own, through its
moments and its update where the gradient is above that noise.

Tolerances, float32 summed in other orders on the two sides:
* every logged loss, each step: 1e-4 relative;
* lambda and the EMA norms against ``balancing_lambdas_naive``: 1e-4 relative;
* parameters after each step: the difference between the two sides at most
  1e-2 of the size of the step's update (Frobenius norms, per tensor;
  measured up to 1.2e-3, on the latent convolution's weight-norm direction).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vibravox_tpu.data.collate import BWECollate as JaxBWECollate
from vibravox_tpu.data.sources import SyntheticVibravoxSource as JaxSyntheticVibravoxSource
from vibravox_tpu.losses.gan import FeatureMatchingLoss as JaxFeatureMatchingLoss
from vibravox_tpu.losses.gan import HingeLoss as JaxHingeLoss
from vibravox_tpu.models.eben_discriminator import (
    DiscriminatorEBENMultiScales as JaxDiscriminatorEBENMultiScales,
)
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu.ops.stft import MultiResolutionSTFTLoss as JaxMultiResolutionSTFTLoss
from vibravox_tpu.tasks.eben import EBENTask as JaxEBENTask
from vibravox_tpu.tasks.eben_oracle import balancing_lambdas_naive
from vibravox_tpu_torch.core.loop import Trainer
from vibravox_tpu_torch.core.optim import adam, sgd
from vibravox_tpu_torch.data.bwe import BWEDataModule
from vibravox_tpu_torch.data.collate import BWECollate
from vibravox_tpu_torch.data.sources import SyntheticVibravoxSource
from vibravox_tpu_torch.losses.gan import FeatureMatchingLoss, HingeLoss
from vibravox_tpu_torch.models.convert import (
    eben_discriminator_params_from_jax,
    eben_generator_params_from_jax,
    eben_train_state_from_jax,
)
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.ops.stft import MultiResolutionSTFTLoss
from vibravox_tpu_torch.tasks.eben import EBENTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


T = 4064
ADAMS = dict(generator_optimizer=adam(3e-4, betas=(0.5, 0.9)),
             discriminator_optimizer=adam(3e-4, betas=(0.5, 0.9)))  # eben.yaml's


def _jax_task(**kw):
    args = dict(
        sample_rate=16000,
        generator=JaxEBENGenerator(m=4, n=32, p=2),
        discriminator=JaxDiscriminatorEBENMultiScales(q=4, min_channels=8),
        generator_optimizer=optax.sgd(1e-2),
        discriminator_optimizer=optax.sgd(1e-2),
        reconstructive_loss_freq_fn=JaxMultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True),
        feature_matching_loss_fn=JaxFeatureMatchingLoss(),
        adversarial_loss_fn=JaxHingeLoss(),
        dynamic_loss_balancing="ema",
    )
    args.update(kw)
    return JaxEBENTask(**args)


def _port_task(**kw):
    args = dict(
        sample_rate=16000,
        generator=EBENGenerator(m=4, n=32, p=2, device="cpu"),
        discriminator=DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
        generator_optimizer=sgd(1e-2),
        discriminator_optimizer=sgd(1e-2),
        reconstructive_loss_freq_fn=MultiResolutionSTFTLoss(
            (512,), (50,), (240,), sample_rate=16000, perceptual_weighting=True, device="cpu"),
        feature_matching_loss_fn=FeatureMatchingLoss(),
        adversarial_loss_fn=HingeLoss(),
        dynamic_loss_balancing="ema",
        device="cpu",
    )
    args.update(kw)
    return EBENTask(**args)


@pytest.fixture(scope="module")
def batch_np():
    ref = np.random.default_rng(7).standard_normal((2, T, 1)).astype(np.float32) * 0.1
    return {"audio_body_conducted": ref * 0.5, "audio_airborne": ref}


@pytest.fixture(scope="module")
def jax_run(batch_np):
    """The JAX task, its initial state and the states and logs of 3 steps."""
    task = _jax_task()
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    state = jax.jit(task.init_state)(jax.random.key(0), batch)
    step = jax.jit(task.train_step)
    states, logs = [], []
    s = state
    for _ in range(3):
        s, lg = step(s, batch)
        states.append(jax.device_get(s))
        logs.append({k: float(v) for k, v in lg.items()})
    return task, jax.device_get(state), states, logs


def _port_batch(batch_np):
    return {k: torch.from_numpy(v) for k, v in batch_np.items()}


def _assert_params_close(port_sd, ref_sd, prev_sd):
    for k, ref in ref_sd.items():
        if k.startswith("pqmf."):
            continue
        a, b, b0 = port_sd[k].detach().numpy(), ref.numpy(), prev_sd[k].numpy()
        # a tensor whose update is 0 (a saturated hinge gives no gradient)
        # must stay put on both sides
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b - b0) + 1e-7, k


def test_balancing_lambdas_match_naive_oracle(jax_run, batch_np):
    jtask, jstate, _, _ = jax_run
    corrupted = jtask.generator.cut_to_valid_length(jnp.asarray(batch_np["audio_body_conducted"]))
    reference = jtask.generator.cut_to_valid_length(jnp.asarray(batch_np["audio_airborne"]))
    dec_ref = jtask.generator.pqmf.analysis(reference)
    features, first_bands = jax.jit(
        lambda p, x: jtask.generator.apply(p, x, method="front"))(jstate.gen_params, corrupted)
    want_lambdas, want_ema = jax.jit(
        lambda *a: balancing_lambdas_naive(jtask, *a))(jstate, features, first_bands, reference, dec_ref)

    task = _port_task()
    state = task.init_state(0, restored=eben_train_state_from_jax(jstate))
    gen = task.generator
    b = _port_batch(batch_np)
    corrupted_t = b["audio_body_conducted"].transpose(1, 2).contiguous()
    reference_t = b["audio_airborne"].transpose(1, 2).contiguous()
    task.discriminator.requires_grad_(False)
    enhanced, decomposed = gen.tail(*gen.front(corrupted_t))
    atomic = task._generator_atomic_losses(
        enhanced, reference_t, decomposed, gen.pqmf.analysis(reference_t))
    lambdas, ema = task._balancing(state, [atomic[n] for n in task.atomic_loss_names])
    np.testing.assert_allclose(lambdas.numpy(), np.asarray(want_lambdas), rtol=1e-4)
    np.testing.assert_allclose(ema.numpy(), np.asarray(want_ema), rtol=1e-4)


def test_three_steps_match_jax(jax_run, batch_np):
    _, jstate, jstates, jlogs = jax_run
    task = _port_task()
    prev = eben_train_state_from_jax(jstate)
    state = task.init_state(0, restored=prev)
    batch = _port_batch(batch_np)
    for i in range(3):
        state, logs = task.train_step(state, batch)
        assert set(logs) == set(jlogs[i])
        for k, want in jlogs[i].items():
            np.testing.assert_allclose(float(logs[k]), want, rtol=1e-4, err_msg=f"step {i} {k}")
        assert state.step == int(jstates[i].step) == i + 1
        np.testing.assert_allclose(
            state.atomic_norms_ema.numpy(), np.asarray(jstates[i].atomic_norms_ema), rtol=1e-4)
        ref = eben_train_state_from_jax(jstates[i])
        _assert_params_close(task.generator.state_dict(), ref["generator"], prev["generator"])
        _assert_params_close(task.discriminator.state_dict(), ref["discriminator"], prev["discriminator"])
        prev = ref


def test_closed_gate_freezes_discriminator_and_its_adam(batch_np):
    torch.manual_seed(0)
    task = _port_task(update_discriminator_ratio=0.0, **ADAMS)
    state = task.init_state(0)
    before = {k: v.clone() for k, v in task.discriminator.state_dict().items()}
    gen_before = task.generator.last_conv.weight.detach().clone()
    for _ in range(2):
        state, logs = task.train_step(state, _port_batch(batch_np))
        assert all(np.isfinite(float(v)) for v in logs.values())
    for k, v in task.discriminator.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert len(state.discriminator_optimizer.state) == 0  # no Adam moments, no step count
    assert all(p.grad is None for p in task.discriminator.parameters())
    assert not torch.equal(task.generator.last_conv.weight, gen_before)


def test_bfloat16_step_is_close_to_float32(jax_run, batch_np):
    """One step with compute_dtype bfloat16 against the JAX float32 step:
    the losses within 5e-2 relative (bf16 activations and weights)."""
    _, jstate, _, jlogs = jax_run
    task = _port_task(compute_dtype="bfloat16")
    state = task.init_state(0, restored=eben_train_state_from_jax(jstate))
    state, logs = task.train_step(state, _port_batch(batch_np))
    for k, want in jlogs[0].items():
        assert float(logs[k]) == pytest.approx(want, rel=5e-2), k
    assert all(p.dtype == torch.float32 for p in task.generator.parameters())


def test_trainer_fits_two_steps_on_synthetic_data():
    torch.manual_seed(0)
    task = _port_task(**ADAMS)
    before = task.generator.last_conv.weight.detach().clone()
    dm = BWEDataModule(collate_strategy="constant_length-254-ms", batch_size=2, num_workers=0,
                       synthetic_size=4, device="cpu")
    trainer = Trainer(max_epochs=1, log_every_n_steps=1, limit_train_batches=2, limit_val_batches=0,
                      sync_every_step=True)
    trainer.fit(task, dm)
    assert trainer.global_step == 2 and trainer.state.step == 2 and len(trainer.step_seconds) == 2
    assert len(trainer.data_wait_seconds) == 2 and all(w >= 0 for w in trainer.data_wait_seconds)
    step_logs = [lg for _, lg in trainer.logged if "train/generator/backprop_loss" in lg]
    assert len(step_logs) == 2
    assert all(np.isfinite(v) for lg in step_logs for v in lg.values())
    epoch = trainer.logged[-1][1]
    assert epoch["train/audio_seconds_per_second"] > 0
    assert not torch.equal(task.generator.last_conv.weight, before)


def test_one_adam_step_matches_jax(batch_np):
    """One step with eben.yaml's Adams (3e-4, betas (0.5, 0.9)) on both sides
    from the converted ``init_state``: the losses (1e-4 relative), each
    parameter's Adam step count, its first and second moments (relaid as
    the parameters are) within 2e-4 of the network's largest moment entry
    (measured 1.6e-5 and 2.0e-5), and the update within 1e-3 of lr
    (measured 5.0e-5) on the entries whose gradient is at least 1e-3 of the
    network's largest.  Below that a gradient can be float32 noise (a bias
    under a saturated hinge cancels to 7e-9 on one side and 0 on the
    other), and Adam's first step moves such an entry by lr times its sign."""
    jtask = _jax_task(generator_optimizer=optax.adam(3e-4, b1=0.5, b2=0.9),
                      discriminator_optimizer=optax.adam(3e-4, b1=0.5, b2=0.9))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jstate = jax.jit(jtask.init_state)(jax.random.key(0), batch)
    jnew, jlogs = jax.jit(jtask.train_step)(jstate, batch)
    jstate, jnew = jax.device_get(jstate), jax.device_get(jnew)

    task = _port_task(**ADAMS)
    state = task.init_state(0, restored=eben_train_state_from_jax(jstate))
    before = {k: v.detach().clone() for k, v in task.generator.named_parameters()}
    before.update({f"disc.{k}": v.detach().clone() for k, v in task.discriminator.named_parameters()})
    state, logs = task.train_step(state, _port_batch(batch_np))
    for k, want in jlogs.items():
        np.testing.assert_allclose(float(logs[k]), float(want), rtol=1e-4, err_msg=k)

    nets = ((task.generator, "", jnew.gen_opt_state, jnew.gen_params, state.generator_optimizer,
             eben_generator_params_from_jax),
            (task.discriminator, "disc.", jnew.disc_opt_state, jnew.disc_params,
             state.discriminator_optimizer, eben_discriminator_params_from_jax))
    for net, prefix, opt_state, params, opt, convert in nets:
        adam_state = opt_state[0]
        assert int(adam_state.count) == 1
        want = {"exp_avg": convert(adam_state.mu), "exp_avg_sq": convert(adam_state.nu)}
        after = convert(params)
        names = [name for name, _ in net.named_parameters()]
        scale = {k: max(float(np.abs(want[k][n].numpy()).max()) for n in names) for k in want}
        held = 0
        for name, p in net.named_parameters():
            st = opt.state[p]
            assert float(st["step"]) == 1, name
            for key in want:
                np.testing.assert_allclose(st[key].numpy(), want[key][name].numpy(), rtol=0,
                                           atol=2e-4 * scale[key], err_msg=f"{name} {key}")
            big = np.abs(want["exp_avg"][name].numpy()) >= 1e-3 * scale["exp_avg"]
            held += int(big.sum())
            p0 = before[prefix + name].numpy()
            moved, want_moved = p.detach().numpy() - p0, after[name].numpy() - p0
            np.testing.assert_allclose(moved[big], want_moved[big], rtol=0, atol=1e-3 * 3e-4, err_msg=name)
        assert held > 0


def test_adam_factory_builds_the_configured_torch_adam():
    opt = adam(3e-4, betas=(0.5, 0.9))([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (3e-4, (0.5, 0.9), 1e-8, 0.0)


@pytest.mark.parametrize("deterministic", [True, False])
def test_collate_is_byte_equal_to_jax(deterministic, monkeypatch):
    from vibravox_tpu.native import pipeline

    items = [SyntheticVibravoxSource(6, split="speech_clean-train")[i] for i in range(6)]
    jax_items = [JaxSyntheticVibravoxSource(6, split="speech_clean-train")[i] for i in range(6)]
    for a, b in zip(items, jax_items):
        for k in a:
            assert np.array_equal(a[k], b[k])
    monkeypatch.setattr(pipeline, "native_available", lambda: False)
    ours = BWECollate(16000, "constant_length-2500-ms", deterministic=deterministic, seed=3)
    ref = JaxBWECollate(16000, "constant_length-2500-ms", deterministic=deterministic, seed=3)
    for chunk in (items[:3], items[3:]):
        got, want = ours(chunk), ref(chunk)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32 and got[k].numpy().tobytes() == want[k].tobytes()
