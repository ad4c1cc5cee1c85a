"""Package rules of the PyTorch port: it loads nothing of JAX or of the JAX
package, and it never moves to the CPU on its own."""
import subprocess
import sys

import pytest
import torch

from audio_diffusion_torch import DiffusionModel, UNetV0

torch.set_num_threads(2)

CFG = dict(in_channels=2, channels=[8, 16], factors=[1, 2], items=[1, 1],
           modulation_features=16)


def test_import_loads_no_jax():
    code = ("import sys, audio_diffusion_torch, audio_diffusion_torch.convert, "
            "audio_diffusion_torch.ops.text;"
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
