"""Package rules of the PyTorch port: it loads nothing of JAX or of the JAX
package, and it never moves to the CPU on its own."""
import subprocess
import sys

import pytest
import torch

from audio_diffusion_torch import (DiffusionModel, DiffusionUpsampler,
                                   DiffusionVocoder, LTPlugin, MelEncoder1d,
                                   UNetV0)

torch.set_num_threads(2)

CFG = dict(in_channels=2, channels=[8, 16], factors=[1, 2], items=[1, 1],
           modulation_features=16)


def test_import_loads_no_jax():
    code = ("import sys, audio_diffusion_torch, audio_diffusion_torch.convert, "
            "audio_diffusion_torch.ops.text, audio_diffusion_torch.dsp, "
            "audio_diffusion_torch.losses, audio_diffusion_torch.ops.conv, "
            "audio_diffusion_torch.models.encoders, "
            "audio_diffusion_torch.models.tasks, "
            "audio_diffusion_torch.data, audio_diffusion_torch.train, "
            "audio_diffusion_torch.cli, audio_diffusion_torch.__main__, "
            "audio_diffusion_torch.serve, audio_diffusion_torch.server, "
            "audio_diffusion_torch.export, audio_diffusion_torch.ops.quant, "
            "audio_diffusion_torch.distill, audio_diffusion_torch.eval, "
            "audio_diffusion_torch.embed, audio_diffusion_torch.ops.unet2d, "
            "audio_diffusion_torch.ops.unet3d, "
            "audio_diffusion_torch.parallel.comm, "
            "audio_diffusion_torch.parallel.mesh, "
            "audio_diffusion_torch.parallel.inference;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'audio_diffusion_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        model = DiffusionModel(net_t=UNetV0, **CFG)
        assert model.device.type == "cuda"
        assert next(model.net.module.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DiffusionModel(net_t=UNetV0, **CFG)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            UNetV0(dim=1, **CFG)


def test_explicit_cpu_device():
    model = DiffusionModel(net_t=UNetV0, device="cpu", **CFG)
    assert model.device.type == "cpu"
    out = model.sample(torch.zeros(1, 2, 64), num_steps=2)
    assert out.device.type == "cpu" and torch.isfinite(out).all()


def test_task_model_extras_follow_the_model_device():
    """Without a device the task models and the encoder raise where CUDA is
    absent; with ``device="cpu"`` every extra module lives there."""
    enc = dict(in_channels=2, channels=16, out_channels=4, mel_channels=8,
               mel_n_fft=64, mel_sample_rate=16000)
    voc = dict(mel_channels=8, mel_n_fft=64, mel_sample_rate=16000,
               **{k: v for k, v in CFG.items() if k != "in_channels"})
    if not torch.cuda.is_available():
        for build in (lambda: MelEncoder1d(**enc),
                      lambda: DiffusionVocoder(net_t=UNetV0, **voc),
                      lambda: DiffusionUpsampler(net_t=UNetV0,
                                                 upsample_factor=2, **CFG)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()
    model = DiffusionVocoder(net_t=UNetV0, device="cpu", **voc)
    assert model.to_flat.kernel.device.type == "cpu"
    lt = DiffusionModel(net_t=LTPlugin(UNetV0, num_filters=2,
                                       window_length=4, stride=2),
                        device="cpu", **CFG)
    assert all(p.device.type == "cpu" for p in lt.params.values())


SERVING_NAMES = ["GenerationService", "make_server", "wav_bytes", "QTensor",
                 "quantize_params", "dequantize_params", "unpack_int4_leaves",
                 "export_sampler", "load_sampler", "load_params",
                 "ArtifactSampler", "ProgressiveDistiller", "CorpusEmbedder",
                 "frechet_embedding_distance"]


@pytest.mark.parametrize("name", SERVING_NAMES)
def test_serving_names_are_public(name):
    import audio_diffusion_torch

    assert name in audio_diffusion_torch.__all__
    assert getattr(audio_diffusion_torch, name) is not None


def test_serving_modules_import_no_jax_in_source():
    """The new modules' sources name neither JAX nor the JAX package in an
    import."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1] / "audio_diffusion_torch"
    for rel in ("serve.py", "server.py", "export.py", "ops/quant.py",
                "distill.py", "eval.py", "embed.py", "parallel/comm.py",
                "parallel/mesh.py", "parallel/inference.py",
                "parallel/train_step.py"):
        src = (root / rel).read_text()
        bad = re.findall(r"^\s*(?:from|import)\s+(jax\w*|flax|"
                         r"audio_diffusion_tpu)\b", src, re.MULTILINE)
        assert not bad, (rel, bad)
