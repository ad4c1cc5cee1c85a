"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check) on a tiny cell on the CPU, once for
each fault the cell can have, against the cell's own limits."""
import pytest
import torch

from tiny import run_cell


def _scaled(fn, factor):
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs) * factor
    return wrapper


@pytest.mark.parametrize("workload", ["uncond-sample-b1",
                                      "text-cfg-sample-b1"])
def test_sample_altered_where_produced(workload, monkeypatch):
    from audio_diffusion_torch.models import model

    monkeypatch.setattr(model.DiffusionModel, "sample",
                        _scaled(model.DiffusionModel.sample, 1.05))
    run, _ = run_cell(workload)
    assert not run.correct


def test_guided_batch_half_left_out(monkeypatch):
    """The guided pass runs its conditioned half alone: no guidance."""
    from audio_diffusion_torch.ops import unet

    forward = unet.ClassifierFreeGuidanceWrapper.forward

    def half(self, x, sigmas=None, **kwargs):
        kwargs["embedding_scale"] = 1.0
        return forward(self, x, sigmas, **kwargs)

    monkeypatch.setattr(unet.ClassifierFreeGuidanceWrapper, "forward", half)
    run, _ = run_cell("text-cfg-sample-b1")
    assert not run.correct


def test_train_state_unchanged(monkeypatch):
    from audio_diffusion_torch.train import trainer

    monkeypatch.setattr(trainer.ClipAdamW, "step",
                        lambda self, closure=None: None)
    run, _ = run_cell("uncond-train-b8")
    assert not run.correct


def test_train_state_unchanged_in_window(monkeypatch):
    """Set-up's steps are sound and the window's leave the state as it
    was: the window's checked steps catch it."""
    from audio_diffusion_torch.train import trainer

    def broken():
        monkeypatch.setattr(trainer.ClipAdamW, "step",
                            lambda self, closure=None: None)

    run, _ = run_cell("uncond-train-b8", before_window=broken)
    assert not run.correct
    assert all(c["value"] <= c["limit"] for c in run.compared
               if not c["name"].startswith("late_"))


def test_train_half_batch_left_out(monkeypatch):
    from audio_diffusion_torch.models import model

    loss = model.DiffusionModel.loss

    def half(self, params, generator, x, **kwargs):
        return loss(self, params, generator, x[:x.shape[0] // 2], **kwargs)

    monkeypatch.setattr(model.DiffusionModel, "loss", half)
    run, _ = run_cell("uncond-train-b8")
    assert not run.correct


def test_train_loss_altered_where_produced(monkeypatch):
    from audio_diffusion_torch.diffusion import vdiffusion

    monkeypatch.setattr(vdiffusion, "v_loss",
                        _scaled(vdiffusion.v_loss, 1.05))
    run, _ = run_cell("uncond-train-b8")
    assert not run.correct


def test_serve_reply_altered_where_produced(monkeypatch):
    from audio_diffusion_torch import serve

    monkeypatch.setattr(serve, "to_pcm16",
                        lambda x, f=serve.to_pcm16: f(x * 1.05))
    run, _ = run_cell("uncond-serve-poisson")
    assert not run.correct


def test_serve_half_batch_left_out(monkeypatch):
    """Each batch computes its first half and hands those rows to the
    rest; every served request is checked."""
    from audio_diffusion_torch import serve

    noise = serve.GenerationService._seed_noise

    def half(self, seeds, channels, length):
        head = seeds[:max(len(seeds) // 2, 1)]
        rows = noise(self, head, channels, length)
        return torch.cat([rows, rows, rows])[:len(seeds)]

    monkeypatch.setattr(serve.GenerationService, "_seed_noise", half)
    run, _ = run_cell("uncond-serve-poisson", check_requests=100,
                      rate_per_s=6.0)
    assert not run.correct
