"""PyTorch port: EBEN weights in the hub layout, shared with the JAX package.

* The port's safetensors writer gives the bytes of ``safetensors.torch
  .save_file`` for the same dict (float32, float16, bfloat16, the int
  types, a scalar, an empty and a transposed tensor), and each side reads
  the other's file.
* A full-width generator (m=4, n=32, p=2) saved by JAX's
  ``save_eben_generator`` loads into the port and enhances within 1e-5 of
  JAX's forward (of the output's scale), and one saved by the port loads
  into JAX within the same bar; the ``.bin`` route and the discriminator
  load too.
* A hub repo id, the push and ``--repo-id`` raise.
* The enhancement script on ``--dataset synthetic --limit 2 --device cpu``
  writes npz files within 1e-5 of the JAX script's; ``upload_eben_to_hub``
  on a port checkpoint writes files that JAX's loader reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.torch import save_file as reference_save_file

from vibravox_tpu.models import hub as jhub
from vibravox_tpu.models.eben_generator import EBENGenerator as JaxEBENGenerator
from vibravox_tpu.scripts.eben_enhanced_vibravox import main as jax_enhance
from vibravox_tpu_torch.core.checkpoint import CheckpointManager
from vibravox_tpu_torch.core.optim import sgd
from vibravox_tpu_torch.models import hub, safetensors_io
from vibravox_tpu_torch.models.eben_discriminator import DiscriminatorEBENMultiScales
from vibravox_tpu_torch.models.eben_generator import EBENGenerator
from vibravox_tpu_torch.scripts.eben_enhanced_vibravox import main as enhance
from vibravox_tpu_torch.scripts.upload_eben_to_hub import main as export
from vibravox_tpu_torch.tasks.eben import EBENTask
from torch_support import one_thread  # noqa: F401  (autouse: torch on one thread)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_safetensors_writer_matches_the_package(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tensors = {
        "w": torch.randn(4, 3, generator=gen), "h": torch.randn(2, 2, generator=gen).half(),
        "b": torch.randn(5, generator=gen).bfloat16(), "i64": torch.arange(3), "i32": torch.arange(4, dtype=torch.int32),
        "i16": torch.arange(2, dtype=torch.int16), "i8": torch.arange(3, dtype=torch.int8),
        "u8": torch.arange(3, dtype=torch.uint8), "mask": torch.tensor([True, False]),
        "f64": torch.randn(2, dtype=torch.float64, generator=gen), "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 3), "transposed": torch.randn(3, 4, generator=gen).T,
    }
    safetensors_io.save_file(tensors, tmp_path / "port.safetensors")
    reference_save_file({k: v.contiguous() for k, v in tensors.items()}, str(tmp_path / "package.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "package.safetensors").read_bytes()
    ours = safetensors_io.load_file(tmp_path / "package.safetensors")
    theirs = np_load_file(str(tmp_path / "port.safetensors"))
    assert list(ours) == list(theirs)
    for k, v in tensors.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
        if v.dtype != torch.bfloat16:  # numpy has no bfloat16
            assert np.array_equal(theirs[k], v.numpy()), k
    # the hub's files carry a metadata header, which the reader skips
    reference_save_file({"x": torch.ones(2)}, str(tmp_path / "meta.safetensors"), metadata={"format": "pt"})
    assert torch.equal(safetensors_io.load_file(tmp_path / "meta.safetensors")["x"], torch.ones(2))


@pytest.fixture(scope="module")
def jax_generator():
    """The full-width JAX generator (seed 0), its jitted forward and a test signal."""
    model = JaxEBENGenerator(m=4, n=32, p=2)
    t = model.valid_length(8000)
    audio = (0.1 * np.random.default_rng(0).standard_normal((1, t, 1))).astype(np.float32)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, t, 1)))
    return model, jax.jit(lambda p, a: model.apply(p, a)[0]), params, audio


def _enhance(model, audio):
    with torch.inference_mode():
        return model(torch.from_numpy(audio))[0].numpy()


def test_generator_saved_by_either_package_loads_in_the_other(jax_generator, tmp_path):
    jmodel, apply, params, audio = jax_generator
    want = np.asarray(apply(params, jnp.asarray(audio)))
    jhub.save_eben_generator(params, str(tmp_path / "from_jax"))
    assert (tmp_path / "from_jax" / "model.safetensors").is_file()
    port = hub.eben_generator_from_pretrained(str(tmp_path / "from_jax"), device="cpu")
    assert (port.m, port.n, port.p) == (4, 32, 2)
    assert _rel(_enhance(port, audio), want) <= 1e-5

    source = EBENGenerator(device="cpu")
    hub.save_eben_generator(source, tmp_path / "from_port", sensor="throat_microphone")
    assert {p.name for p in (tmp_path / "from_port").iterdir()} == {"model.safetensors", "config.json", "README.md"}
    assert "throat_microphone" in (tmp_path / "from_port" / "README.md").read_text()
    jm, jparams = jhub.eben_generator_from_pretrained(str(tmp_path / "from_port"))
    assert (jm.m, jm.n, jm.p) == (4, 32, 2)
    assert _rel(np.asarray(apply(jparams, jnp.asarray(audio))), _enhance(source, audio)) <= 1e-5
    loaded = hub.eben_generator_from_pretrained(tmp_path / "from_port" / "model.safetensors", device="cpu")
    assert np.array_equal(_enhance(loaded, audio), _enhance(source, audio))


def test_bin_route_and_discriminator(tmp_path):
    source = EBENGenerator(m=4, n=32, p=1, device="cpu")
    torch.save(source.state_dict(), tmp_path / "pytorch_model.bin")
    loaded = hub.eben_generator_from_pretrained(tmp_path, device="cpu")
    assert (loaded.m, loaded.n, loaded.p) == (4, 32, 1)
    audio = (0.1 * np.random.default_rng(1).standard_normal((1, source.valid_length(4000), 1))).astype(np.float32)
    assert np.array_equal(_enhance(loaded, audio), _enhance(source, audio))

    disc = DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu")
    safetensors_io.save_file(disc.state_dict(), tmp_path / "disc.safetensors")
    loaded = hub.eben_discriminator_from_pretrained(tmp_path / "disc.safetensors", min_channels=8, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), disc.state_dict().values()))


def test_hub_ids_and_pushes_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="never downloads"):
        hub.eben_generator_from_pretrained("Cnam-LMSSC/EBEN_throat_microphone", device="cpu")
    with pytest.raises(FileNotFoundError, match="no weight file"):
        hub.eben_generator_from_pretrained(tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="needs the network"):
        hub.push_eben_generator_to_hub(EBENGenerator(device="cpu"), "someone/EBEN")
    with pytest.raises(NotImplementedError, match="needs the network"):
        export(["--checkpoint", str(tmp_path), "--out", str(tmp_path / "out"), "--repo-id", "someone/EBEN"])
    assert not (tmp_path / "out").exists()


def test_enhancement_script_matches_jax(jax_generator, tmp_path):
    _, _, params, _ = jax_generator
    jhub.save_eben_generator(params, str(tmp_path / "weights"))
    common = ["--dataset", "synthetic", "--sensors", "body_conducted", "--weights", str(tmp_path / "weights"),
              "--limit", "2"]
    enhance([*common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    jax_enhance([*common, "--out", str(tmp_path / "jax")])
    ours = sorted((tmp_path / "port" / "body_conducted").glob("*.npz"))
    theirs = sorted((tmp_path / "jax" / "body_conducted").glob("*.npz"))
    assert [p.name for p in ours] == [p.name for p in theirs] == ["000000.npz", "000001.npz"]
    for a, b in zip(ours, theirs):
        got, want = np.load(a)["audio_enhanced"], np.load(b)["audio_enhanced"]
        assert got.shape == want.shape and got.ndim == 1 and _rel(got, want) <= 1e-5


def test_export_of_a_port_checkpoint_loads_in_jax(jax_generator, tmp_path):
    _, apply, _, audio = jax_generator
    torch.manual_seed(3)
    task = EBENTask(16000, EBENGenerator(device="cpu"), DiscriminatorEBENMultiScales(q=4, min_channels=8, device="cpu"),
                    sgd(1e-2), sgd(1e-2), device="cpu")
    state = task.init_state(0)
    CheckpointManager(str(tmp_path / "checkpoints")).save(state, step=1)
    export(["--checkpoint", str(tmp_path / "checkpoints" / "last"), "--out", str(tmp_path / "export")])
    jm, jparams = jhub.eben_generator_from_pretrained(str(tmp_path / "export"))
    assert (jm.m, jm.n, jm.p) == (4, 32, 2)
    assert _rel(np.asarray(apply(jparams, jnp.asarray(audio))), _enhance(state.generator, audio)) <= 1e-5
