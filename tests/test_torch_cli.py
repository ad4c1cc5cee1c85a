"""The port's command line (``python -m audio_diffusion_torch``) on the CPU:
``train`` (2 steps) -> ``sample`` -> ``info`` on a tiny JSON config and
WAVs synthesized from a numpy seed, then ``train`` again, which resumes
from the run's checkpoint; the commands that are not ported raise.

No tolerances: the run directory's layout, the recorded config and the
outputs' shapes are checked exactly, the audio for finite values.
"""
import json

import numpy as np
import pytest
import torch

from audio_diffusion_torch import cli
from audio_diffusion_torch.data import wav_probe, wav_read, wav_write

torch.set_num_threads(2)

TINY = dict(channels=[8, 32, 64], factors=[1, 4, 2], items=[1, 2, 1],
            attentions=[0, 0, 1], attention_heads=4, attention_features=8,
            modulation_features=64)


@pytest.fixture
def corpus(tmp_path):
    rs = np.random.default_rng(0)
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(3):
        wav_write(wavs / f"f{i}.wav", rs.uniform(-.5, .5, (2, 600 + 50 * i)),
                  16000)
    preset = tmp_path / "tiny.json"
    preset.write_text(json.dumps(TINY))
    return wavs, preset


def test_train_sample_info_and_resume(tmp_path, corpus, capsys):
    wavs, preset = corpus
    run = tmp_path / "run"
    train = ["train", "--data", str(wavs), "--preset", str(preset), "--out",
             str(run), "--batch", "2", "--crop", "256", "--device", "cpu",
             "--log-every", "1", "--checkpoint-every", "1", "--ema-decay",
             "0.9", "--lr-schedule", "cosine", "--warmup-steps", "1",
             "--max-grad-norm", "1.0"]
    cli.main(train + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "data device-resident" in out and "step 2:" in out
    recorded = json.loads((run / "config.json").read_text())
    assert recorded == {**TINY, "in_channels": 2, "_dtype": "bf16",
                        "_sample_rate": 16000, "_task": "unconditional"}
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["1", "2"]
    assert (run / "model").is_file()

    cli.main(["sample", "--model", str(run / "model"), "--out",
              str(tmp_path / "smp"), "--num", "2", "--steps", "3",
              "--length", "256", "--device", "cpu"])
    for i in (0, 1):
        path = tmp_path / "smp" / f"sample_{i}.wav"
        assert wav_probe(path) == (2, 16000, 256)
        assert np.isfinite(wav_read(path)).all()

    capsys.readouterr()
    cli.main(["info", "--run", str(run), "--params", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "checkpoints: [1, 2]" in out and "compute dtype: bf16" in out
    assert "parameters: 0.2 M" in out

    # --steps is the total budget: the second run takes the third step.
    cli.main(train + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2; 1 steps remain" in out
    assert "step 3:" in out and "step 1:" not in out
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["1", "2",
                                                                 "3"]


def test_train_host_placement_and_text_encoder(tmp_path, corpus, capsys):
    """The host AudioDataset path with --embedding-dir (per-file .npy
    embeddings riding each crop), and the pretrained T5 raising."""
    wavs, _ = corpus
    preset = tmp_path / "text.json"
    preset.write_text(json.dumps(dict(
        TINY, cross_attentions=[0, 0, 1], embedding_features=8,
        use_embedding_cfg=True, embedding_max_length=4)))
    emb = tmp_path / "emb"
    emb.mkdir()
    for i in range(3):
        np.save(emb / f"f{i}.npy", np.full((4, 8), i, np.float32))
    cli.main(["train", "--data", str(wavs), "--preset", str(preset),
              "--out", str(tmp_path / "run"), "--batch", "2", "--crop",
              "256", "--steps", "1", "--device", "cpu", "--embedding-dir",
              str(emb), "--dtype", "f32"])
    out = capsys.readouterr().out
    assert "paired embeddings" in out and "step 1:" in out
    with pytest.raises(NotImplementedError, match="T5"):
        cli.main(["train", "--data", str(wavs), "--preset", str(preset),
                  "--out", str(tmp_path / "run2"), "--crop", "256",
                  "--caption-dir", str(emb), "--device", "cpu"])


@pytest.mark.parametrize("cmd", ["distill", "export", "serve", "eval"])
def test_unported_commands_raise(cmd):
    with pytest.raises(NotImplementedError, match="item 11.*item 12"):
        cli.main([cmd, "--model", "run/model"])
