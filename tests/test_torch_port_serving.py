"""The port's serving path on the CPU: EvalForward and ChunkedInference
host arithmetic against aero_tpu.eval.forward with stub forwards, and the
predict CLI end to end at experiment=tiny with a reference-format .th."""

import os
import typing as tp

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from aero_tpu.data import audio_io
from aero_tpu.eval import forward as jfwd
from aero_tpu.models.aero import Aero as JaxAero
from aero_tpu.train.torch_import import save_torch_checkpoint
from aero_tpu.utils.config import load_config
from aero_tpu_torch import predict as ppredict
from aero_tpu_torch.eval import forward as pfwd

pytestmark = pytest.mark.torch_port

SR = 4000
CONF = os.path.join(os.path.dirname(__file__), "..", "conf")


@pytest.mark.parametrize("n", [1, 3999, 4000, 4001, 23 * SR + 17])
def test_bucket_and_reflect_pad_match_jax(n):
    x = np.random.default_rng(n).standard_normal((2, 1, n)).astype(np.float32)
    assert pfwd.bucket_target(n, SR) == jfwd.bucket_target(n, SR)
    target = pfwd.bucket_target(n, SR) + 3 * n  # several reflections
    np.testing.assert_array_equal(pfwd._pad_reflect_tail(x, target),
                                  jfwd._pad_reflect_tail(x, target))


class _StubState(tp.NamedTuple):
    gen_params: dict
    gen_state: dict


class _JaxStub:
    """Output depends on the padded input, so padding arithmetic shows."""

    def apply(self, variables, lr, train=False):
        return jnp.repeat(lr, 4, axis=-1) + jnp.mean(lr, axis=-1,
                                                     keepdims=True)


class _TorchStub(torch.nn.Module):
    def forward(self, lr):
        return torch.repeat_interleave(lr, 4, dim=-1) + lr.mean(-1, True)


@pytest.mark.parametrize("n", [SR // 2 + 5, 3 * SR + 1])
def test_eval_forward_matches_jax(n):
    x = np.random.default_rng(0).standard_normal((2, 1, n)).astype(np.float32)
    want = jfwd.EvalForward(_JaxStub(), _StubState({}, {}), scale=4,
                            lr_sr=SR)(x)
    got = pfwd.EvalForward(_TorchStub(), scale=4, lr_sr=SR, device="cpu")(x)
    assert got.shape == (2, 1, 4 * n)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _stub_np(x):
    """Depends on the batch it is given, so chunk batching shows."""
    return np.repeat(x, 4, axis=-1) * (1.0 + x.shape[0]) + x.mean()


@pytest.mark.parametrize("batch_chunks", [True, False])
def test_chunked_inference_matches_jax(batch_chunks):
    x = np.random.default_rng(1).standard_normal((1, 1, 23 * SR + 7)).astype(
        np.float32)
    kw = dict(segment_s=10.0, batch_chunks=batch_chunks)
    want = jfwd.ChunkedInference(_stub_np, SR, **kw)(x)
    got = pfwd.ChunkedInference(_stub_np, SR, **kw)(x)
    assert got.shape == (1, 1, 4 * x.shape[-1])
    np.testing.assert_array_equal(got, want)


def test_predict_cli_tiny_cpu(tmp_path):
    """23 s at 4 kHz: two full chunks batched plus a 3 s tail."""
    exp = load_config(CONF, "main_config", ["experiment=tiny"]).experiment
    kw = dict(exp.aero)
    kw["strides"] = tuple(kw["strides"])
    jm = JaxAero(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 2000)),
                        train=False)
    ckpt = str(tmp_path / "checkpoint.th")
    save_torch_checkpoint(ckpt, jax.tree.map(np.asarray, dict(variables)),
                          dict(exp.aero))
    n = 23 * SR
    wav = str(tmp_path / "in.wav")
    t = np.arange(n) / SR
    audio_io.save(wav, 0.3 * np.sin(2 * np.pi * 440 * t)[None], SR)

    out = ppredict.main(["experiment=tiny", "dset=debug", f"+filename={wav}",
                         f"+output={tmp_path / 'out'}",
                         f"checkpoint_file={ckpt}", "device=cpu"])
    pr, sr = audio_io.load(out["path"])
    assert sr == 16000 and out["path"].endswith("in_pr.wav")
    assert pr.shape == (1, 4 * n) and out["out_samples"] == 4 * n
    assert np.isfinite(pr).all() and np.abs(pr).max() > 0


def test_predict_refuses_cuda_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ppredict.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ppredict.resolve_device("tpu")  # the shared config's default
    assert ppredict.resolve_device("cpu").type == "cpu"
