"""PyTorch port: the parallel layer against the JAX package.

* ``fsdp_spec`` and ``transformer_tp_spec`` are pure functions in both
  packages: the port's equal JAX's on a table of shapes and names, and the
  torch-layout readings (``torch_fsdp_dim``, ``torch_tp_dim``: a ``Linear``
  weight is the JAX kernel transposed) agree with them.
* ``accumulate_grad_batches=2`` over four micro-batches against the JAX
  tasks' ``optax.MultiSteps``: EBEN with the discriminator's gate open and
  closed (a closed gate freezes its accumulation), and STP with dropout off.
  SGD, for the reason of ``tests/test_torch_eben_task.py``; parameters held
  as there, to 1e-2 of each update (exactly still where there is none),
  logs to 1e-4 relative.

No loader workers and no spawned processes here (this module imports JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

from vibravox_tpu.losses.gan import FeatureMatchingLoss as JaxFeatureMatchingLoss
from vibravox_tpu.losses.gan import HingeLoss as JaxHingeLoss
from vibravox_tpu.models.eben_discriminator import (
    DiscriminatorEBENMultiScales as JaxDiscriminatorEBENMultiScales,
)
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu.models.wav2vec2 import TINY_W2V2_CONFIG, Wav2Vec2Config, Wav2Vec2ForCTC, Wav2Vec2ForCTCModule
from vibravox_tpu.ops.stft import MultiResolutionSTFTLoss as JaxMultiResolutionSTFTLoss
from vibravox_tpu.parallel.fsdp import fsdp_spec as jax_fsdp_spec
from vibravox_tpu.parallel.tp import transformer_tp_spec as jax_tp_spec
from vibravox_tpu.tasks.eben import EBENTask as JaxEBENTask
from vibravox_tpu.tasks.wav2vec2_stp import Wav2Vec2STPTask as JaxSTPTask
from vibravox_tpu_torch.core.optim import MultiSteps, sgd
from vibravox_tpu_torch.models.convert import eben_train_state_from_jax, wav2vec2_state_dict_from_jax
from vibravox_tpu_torch.parallel.fsdp import fsdp_spec, torch_fsdp_dim
from vibravox_tpu_torch.parallel.tp import torch_tp_dim, transformer_tp_spec
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)

import torch_parallel_support as support

# --------------------------------------------------------------------------- #
# Placement rules
# --------------------------------------------------------------------------- #

FSDP_CASES = [
    ((128, 512), 8, None, 0), ((512, 128), 8, None, 0), ((512, 64), 8, None, 2**16),
    ((512, 64), 8, None, 2**15), ((), 8, None, 0), ((1024, 8), 1, None, 0), ((7, 9), 8, None, 0),
    ((4096,), 8, None, 0), ((41, 512, 512), 8, None, 0), ((4, 32, 64), 8, (None, None, "model"), 0),
    ((64, 32), 8, (None, "model"), 0), ((7, 32), 8, (None, "model"), 0), ((32, 64), 8, ("model",), 0),
    ((768, 3072), 2, None, 2**15), ((3072, 768), 4, (None, "model"), 2**15), ((768, 38), 2, None, 2**15),
    ((768, 38), 4, None, 0), ((6, 6), 3, None, 0), ((9, 6), 3, None, 0), ((512, 512), 2, ("model", None), 0),
]


@pytest.mark.parametrize("shape,data,base,min_size", FSDP_CASES)
def test_fsdp_spec_equals_jax(shape, data, base, min_size):
    want = jax_fsdp_spec(shape, data, None if base is None else P(*base), min_size=min_size)
    assert fsdp_spec(shape, data, base, min_size=min_size) == tuple(want)


TP_NAMES = ["q_proj", "k_proj", "v_proj", "out_proj", "intermediate_dense", "output_dense", "linear1",
            "linear2", "lm_head", "projection"]
TP_SHAPES = [(768, 768), (768, 3072), (3072, 768), (38,), (768,), (12, 768, 3072), (12, 3072), (30, 32)]


@pytest.mark.parametrize("model", [1, 2, 4])
@pytest.mark.parametrize("module", TP_NAMES)
def test_transformer_tp_spec_equals_jax(module, model):
    for shape in TP_SHAPES:
        for param in ("kernel", "bias", "scale"):
            names = ("encoder", "layer_0", module, param)
            assert transformer_tp_spec(names, shape, model) == tuple(jax_tp_spec(names, shape, model)), (
                names, shape)
    assert transformer_tp_spec((module,), (768, 768), model) == tuple(jax_tp_spec((module,), (768, 768), model))


@pytest.mark.parametrize("module", TP_NAMES)
@pytest.mark.parametrize("out_features,in_features", [(768, 768), (3072, 768), (768, 3072), (30, 32)])
def test_torch_layout_readings_agree_with_jax(module, out_features, in_features):
    """A ``Linear`` weight ``(out, in)`` is the JAX kernel ``(in, out)``:
    the TP dimension and the FSDP dimension (alone and on top of TP) read
    JAX's specs through that transpose."""
    for model in (2, 4):
        spec = tuple(jax_tp_spec((module, "kernel"), (in_features, out_features), model))
        dim = torch_tp_dim(module, "weight", (out_features, in_features), model)
        assert dim == (None if "model" not in spec else 1 - spec.index("model"))
        for data in (2, 3, 8):
            fspec = tuple(jax_fsdp_spec((in_features, out_features), data, P(*spec) if spec else None, 0))
            fspec = fspec + (None,) * (2 - len(fspec))
            want = None if "data" not in fspec else 1 - fspec.index("data")
            assert torch_fsdp_dim((out_features, in_features), data, dim, 0) == want


# --------------------------------------------------------------------------- #
# Accumulation against optax.MultiSteps
# --------------------------------------------------------------------------- #

MICRO = 4  # micro-batches, k = 2


def _jax_eben_task():
    return JaxEBENTask(
        sample_rate=16000,
        generator=JaxEBENGenerator(m=4, n=32, p=2),
        discriminator=JaxDiscriminatorEBENMultiScales(q=1, min_channels=8),
        generator_optimizer=optax.sgd(1e-3),
        discriminator_optimizer=optax.sgd(1e-3),
        reconstructive_loss_freq_fn=JaxMultiResolutionSTFTLoss((512,), (50,), (240,)),
        feature_matching_loss_fn=JaxFeatureMatchingLoss(),
        adversarial_loss_fn=JaxHingeLoss(),
        dynamic_loss_balancing="ema",
        accumulate_grad_batches=2,
    )


def _assert_moved_alike(got, got_prev, want, prev, skip=()):
    """Each tensor to 1e-2 of its update on the JAX side; where that update
    is 0, exactly where the port's previous step left it."""
    for k, w in want.items():
        if k.startswith("pqmf.") or any(s in k for s in skip):
            continue
        a, b, b0 = got[k].detach().numpy(), w.numpy(), prev[k].numpy()
        update = np.linalg.norm(b - b0)
        if update == 0:
            np.testing.assert_array_equal(a, got_prev[k].numpy(), err_msg=k)
        else:
            assert np.linalg.norm(a - b) <= 1e-2 * update + 1e-7, k


def _copy(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def eben_runs():
    """The JAX task's four micro-steps with the gate open (ratio 1) and
    closed (ratio 0), from one compiled step: the ratio enters as an
    argument."""
    task = _jax_eben_task()
    batches = [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in support.eben_batches(MICRO, 2)]
    state0 = jax.device_get(jax.jit(task.init_state)(jax.random.key(0), batches[0]))

    def step(state, batch, ratio):
        task.update_discriminator_ratio = ratio
        return task.train_step(state, batch)

    step = jax.jit(step)
    runs = {}
    for ratio in (1.0, 0.0):
        state, states, logs = state0, [], []
        for b in batches:
            state, lg = step(state, b, jnp.float32(ratio))
            states.append(jax.device_get(state))
            logs.append({k: float(v) for k, v in lg.items()})
        runs[ratio] = (states, logs)
    return state0, runs


@pytest.mark.parametrize("ratio", [1.0, 0.0])
def test_eben_accumulation_matches_multisteps(eben_runs, ratio):
    state0, runs = eben_runs
    jstates, jlogs = runs[ratio]
    task = support.eben_task(ratio=ratio, accumulate=2, optimizer=sgd(1e-3))
    prev = eben_train_state_from_jax(state0)
    state = task.init_state(0, restored=prev)
    for i, batch in enumerate(support.eben_batches(MICRO, 2)):
        gen_prev, disc_prev = _copy(task.generator), _copy(task.discriminator)
        state, logs = task.train_step(state, batch)
        for k, want in jlogs[i].items():
            assert float(logs[k]) == pytest.approx(want, rel=1e-4), f"step {i} {k}"
        js = jstates[i]
        assert state.generator_optimizer.mini_step == int(js.gen_opt_state.mini_step) == (i + 1) % 2
        assert state.discriminator_optimizer.mini_step == int(js.disc_opt_state.mini_step)
        ref = eben_train_state_from_jax(js)
        _assert_moved_alike(task.generator.state_dict(), gen_prev, ref["generator"], prev["generator"])
        _assert_moved_alike(task.discriminator.state_dict(), disc_prev, ref["discriminator"],
                            prev["discriminator"])
        prev = ref
    if ratio == 0.0:  # frozen: the count never moved, and no parameter did
        assert int(jstates[-1].disc_opt_state.mini_step) == 0 and not state.discriminator_optimizer.acc
    assert isinstance(state.discriminator_optimizer, MultiSteps)


QUIET = dict(hidden_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0, mask_time_prob=0.0,
             mask_feature_prob=0.0, layerdrop=0.0)


def test_stp_accumulation_matches_multisteps():
    cfg = Wav2Vec2Config(**TINY_W2V2_CONFIG, **QUIET)
    module = Wav2Vec2ForCTCModule(cfg)
    params = jax.jit(lambda k: module.init({"params": k}, jnp.zeros((1, 4000)), train=False)["params"])(
        jax.random.key(0))
    jmodel = Wav2Vec2ForCTC(cfg, params=jax.device_get(params))
    jtask = JaxSTPTask(wav2vec2_for_ctc=jmodel, optimizer=optax.sgd(1e-3), accumulate_grad_batches=2)
    batches = support.stp_batches(MICRO, 2)
    jbatches = [{k: jnp.asarray(v.numpy()) for k, v in b.items()} for b in batches]
    jstate = jtask.init_state(jax.random.key(0), jbatches[0])
    jstep = jax.jit(jtask.train_step)

    task = support.stp_task(dropout=False, optimizer=sgd(1e-3), accumulate=2)
    task.wav2vec2_for_ctc.load_state_dict(wav2vec2_state_dict_from_jax(jmodel.params, cfg), strict=True)
    state = task.init_state(0)
    prev = wav2vec2_state_dict_from_jax(jax.device_get(jstate.params), cfg)
    for i, (batch, jbatch) in enumerate(zip(batches, jbatches)):
        port_prev = _copy(task.wav2vec2_for_ctc)
        state, logs = task.train_step(state, batch)
        jstate, jlogs = jstep(jstate, jbatch)
        assert float(logs["train/ctc_loss"]) == pytest.approx(float(jlogs["train/ctc_loss"]), rel=1e-4)
        assert state.optimizer.mini_step == int(jstate.opt_state.mini_step) == (i + 1) % 2
        want = wav2vec2_state_dict_from_jax(jax.device_get(jstate.params), cfg)
        # the key bias's gradient is 0 up to rounding (test_torch_stp_task.py)
        _assert_moved_alike(task.wav2vec2_for_ctc.state_dict(), port_prev, want, prev, skip=("k_proj.bias",))
        prev = want
