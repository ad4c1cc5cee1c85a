"""The port's exported sampler (export.py) on the CPU: ``export_sampler``
traces one sampler step with ``torch.export``, ``load_sampler`` runs the
loop over the manifest's table; the output equals ``model.sample``'s bit
for bit (VSampler and DPMSampler, an ``embedding=`` input, int8
parameters), the parameters are an input, the guards fail loudly, and an
``ArtifactSampler`` serves behind a ``GenerationService``. No tolerance:
every comparison is bit for bit."""
import json

import numpy as np
import pytest
import torch

from audio_diffusion_torch import (ArtifactSampler, DiffusionModel,
                                   DPMSampler, GenerationService, SDESampler,
                                   UNetV0, export_sampler, load_params,
                                   load_sampler, quantize_params)

torch.set_num_threads(2)

TINY = dict(in_channels=1, channels=[8], factors=[1], items=[1],
            modulation_features=32)


def tiny(**kw):
    return DiffusionModel(net_t=UNetV0, device="cpu", **TINY, **kw)


def noise(shape, seed=0):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = tiny()
    path = tmp_path_factory.mktemp("art")
    manifest = export_sampler(model, path, length=256, batch_size=2,
                              num_steps=3, sample_rate=np.int32(8000))
    return model, path, manifest


def test_export_roundtrip_bit_exact(artifact):
    model, path, manifest = artifact
    assert manifest["kind"] == "audio_diffusion_torch.sampler"
    assert manifest["noise_shape"] == [2, 1, 256]
    assert manifest["num_steps"] == 3 and manifest["platforms"] == ["cpu"]
    assert manifest["sample_rate"] == 8000 and manifest["unroll"] == 1
    assert manifest["torch_version"] == torch.__version__
    assert manifest["sampler"] == "VSampler" and manifest["carry"] == 1
    assert (path / "step.pt2").exists()
    disk = json.loads((path / "manifest.json").read_text())
    assert disk == json.loads(json.dumps(manifest))
    sampler, loaded = load_sampler(path, device="cpu")
    x = noise((2, 1, 256))
    want = model.sample(x, num_steps=3)
    got = sampler(model.params, x)
    assert list(got.shape) == manifest["out_shape"]
    assert torch.equal(got, want)
    # Parameters are an input: another set of the same names runs and
    # gives other audio, model.sample's of that set.
    other = {k: v + 0.01 for k, v in model.params.items()}
    assert torch.equal(sampler(other, x),
                       model.sample(x, num_steps=3, params=other))
    assert not torch.equal(sampler(other, x), got)


def test_export_dpm_roundtrip_bit_exact(tmp_path):
    model = tiny(sampler_t=DPMSampler)
    manifest = export_sampler(model, tmp_path, length=256, num_steps=4)
    assert manifest["sampler"] == "DPMSampler" and manifest["carry"] == 2
    sampler, _ = load_sampler(tmp_path, device="cpu")
    x = noise((1, 1, 256), 1)
    assert torch.equal(sampler(model.params, x), model.sample(x, num_steps=4))


def test_export_guards(artifact, tmp_path):
    model, path, _ = artifact
    (tmp_path / "junk").mkdir()
    (tmp_path / "junk" / "manifest.json").write_text("{}")
    with pytest.raises(ValueError, match="not an exported sampler"):
        load_sampler(tmp_path / "junk")
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "manifest.json").write_text(json.dumps(
        {"kind": "audio_diffusion_tpu.sampler"}))
    with pytest.raises(ValueError, match="JAX package"):
        load_sampler(tmp_path / "jax")
    with pytest.raises(ValueError, match="exported for cpu"):
        load_sampler(path, device="meta")
    sampler, _ = load_sampler(path, device="cpu")
    with pytest.raises(ValueError, match="expects noise"):
        sampler(model.params, noise((1, 1, 256)))
    with pytest.raises(ValueError, match="configuration"):
        sampler({k: v for k, v in list(model.params.items())[1:]},
                noise((2, 1, 256)))
    with pytest.raises(ValueError, match="array conditioning"):
        sampler(model.params, noise((2, 1, 256)), embedding=noise((2, 4)))
    with pytest.raises(ValueError, match="step form"):
        export_sampler(tiny(sampler_t=SDESampler), tmp_path / "sde",
                       length=256)
    with pytest.raises(ValueError, match="encoder_reuse"):
        export_sampler(model, tmp_path / "reuse", length=256,
                       encoder_reuse=2)
    art = ArtifactSampler(path, model.params, device="cpu")
    assert (art.batch_size, art.in_channels, art.length) == (2, 1, 256)
    with pytest.raises(ValueError, match="num_steps"):
        art.sample(noise((2, 1, 256)), num_steps=5)
    with pytest.raises(ValueError, match="conditioning"):
        art.sample(noise((2, 1, 256)), embedding_scale=5.0)
    with pytest.raises(ValueError, match="expects noise"):
        art.sample(noise((2, 1, 128)))


def test_export_conditional_roundtrip(tmp_path):
    """An embedding is an input of the program; the guidance scale is
    baked in."""
    model = DiffusionModel(
        net_t=UNetV0, device="cpu", in_channels=1, channels=[8, 16],
        factors=[1, 2], items=[1, 1], cross_attentions=[0, 1],
        attention_heads=2, attention_features=8, modulation_features=32,
        embedding_features=16, use_embedding_cfg=True,
        embedding_max_length=4)
    manifest = export_sampler(model, tmp_path, length=256, batch_size=2,
                              num_steps=2, embedding=torch.zeros(2, 4, 16),
                              embedding_scale=np.float32(3.0))
    assert manifest["scalar_cond"] == {"embedding_scale": 3.0}
    assert manifest["array_cond"] == {
        "embedding": {"shape": [2, 4, 16], "dtype": "float32"}}
    art = ArtifactSampler(tmp_path, model.params, device="cpu")
    emb = noise((2, 4, 16), 3)
    x = noise((2, 1, 256), 4)
    want = model.sample(x, num_steps=2, embedding=emb, embedding_scale=3.0)
    assert torch.equal(art.sample(x, embedding=emb), want)
    with pytest.raises(ValueError, match="requires embedding"):
        art.sample(x)
    with pytest.raises(ValueError, match="shape"):
        art.sample(x, embedding=noise((2, 5, 16)))
    # Served: per-request embeddings batch into the program's input.
    with GenerationService(art, num_steps=2, batch_size=2,
                           max_wait_ms=200.0) as svc:
        futs = [svc.submit(x[i], embedding=emb[i]) for i in range(2)]
        got = np.stack([f.result(timeout=120) for f in futs])
    assert svc.stats["batches"] == 1
    np.testing.assert_array_equal(got, want.numpy())


def test_export_composes_with_int8_quantization(tmp_path):
    model = tiny()
    q = quantize_params(model.params, min_size=16)
    export_sampler(model, tmp_path, length=256, num_steps=2, params=q)
    sampler, _ = load_sampler(tmp_path, device="cpu")
    x = noise((1, 1, 256), 5)
    want = model.sample(x, num_steps=2, params=q)
    assert torch.equal(sampler(q, x), want)
    assert not torch.equal(want, model.sample(x, num_steps=2))


def test_artifact_sampler_serves_from_params_file(artifact, tmp_path):
    """A serving host with the artifact and a DiffusionModel.save file: the
    service's rows equal model.sample of the same batch."""
    model, path, _ = artifact
    model.save(tmp_path / "model")
    params = load_params(tmp_path / "model", device="cpu")
    assert list(params) == list(model.params)
    art = ArtifactSampler(path, params, device="cpu")
    reqs = [noise((1, 256), s) for s in (6, 7, 8)]
    with GenerationService(art, num_steps=art.num_steps,
                           batch_size=art.batch_size,
                           max_wait_ms=200.0) as svc:
        got = [f.result(timeout=120) for f in
               [svc.submit(r) for r in reqs]]
    want = torch.cat([model.sample(torch.stack(reqs[:2]), num_steps=3),
                      model.sample(torch.stack([reqs[2]] * 2),
                                   num_steps=3)[:1]])
    np.testing.assert_array_equal(np.stack(got), want.numpy())
