"""The port's distillation (audio_diffusion_torch.distill) against the JAX
package's on the CPU: the tiny nets of tests/test_distill.py (2 levels,
one channel, here at 256 samples) and tests/test_guidance_distill.py (the
CFG net), with the same weights (a seeded numpy tree carried across by
``params_from_jax``) and the JAX package's draws fed through the port's
``diffusion/noise.py`` hooks. Each JAX program compiles once per file: the
N = 4 teacher-target program serves both the target test and the stage.

Tolerances.
- The analytic two-step algebra: atol 1e-5, the JAX test's.
- Teacher and guidance targets in float32: x_t and σ to 1e-6; v_target
  max-abs ≤ 1e-4 at N = 4 (the target divides by sin(π/8) and by β_t,
  which amplify the teacher's rounding; the forwards agree to about 1e-6).
- The fused loss against the split pipeline: rtol 1e-6.
- A 3-step ``stage`` against the JAX ``ProgressiveDistiller.stage`` (Adam,
  lr 1e-4): the last loss rel 1e-4; every parameter within 2·lr per step of
  the JAX one; where each step's gradient exceeds 1e-3 of its leaf's
  largest (and 1e-6 of the gradient norm), so Adam's update is beyond the
  rounding, within 5e-7: the bars of tests/test_torch_train.py. The biases
  that a one-channel-per-group GroupNorm removes (level 0: 8 channels, 8
  groups) have gradients of rounding noise only, so they are compared
  absolutely (2·lr per step).
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_diffusion_tpu.distill as jax_distill
from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_torch import (DiffusionModel, ProgressiveDistiller,
                                   UNetV0, params_from_jax)
from audio_diffusion_torch.diffusion import noise as port_noise
from audio_diffusion_torch.diffusion.core import alpha_beta, pad_dims
from audio_diffusion_torch.distill import (_two_step_target,
                                           make_distill_loss,
                                           make_guidance_targets,
                                           make_teacher_targets)

torch.set_num_threads(2)

LENGTH = 256
N = 4  # student steps of the target tests and of the stage (8 -> 4)
LR = 1e-4
STEPS = 3
TINY = dict(in_channels=1, channels=[8, 16], factors=[1, 2], items=[1, 1],
            modulation_features=32)
EMB_LEN, EMB_FEAT = 4, 16
SCALE = 3.0
CFG_TINY = dict(TINY, cross_attentions=[0, 1], attention_heads=2,
                attention_features=8, embedding_features=EMB_FEAT,
                use_embedding_cfg=True, embedding_max_length=EMB_LEN)


def random_tree(cfg, seed):
    """A seeded random parameter tree of the JAX net of ``cfg`` (every leaf
    random, so the zero-initialized gates carry signal too)."""
    net = JaxUNetV0(dim=1, **cfg)
    kw = ({"embedding": jnp.zeros((2, EMB_LEN, EMB_FEAT))}
          if cfg.get("use_embedding_cfg") else {})
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, 1, LENGTH)),
        jnp.zeros((2,)), **kw))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            a = a * 16.0
        elif "scale" in name:
            a = 1.0 + 0.1 * a
        elif len(s.shape) >= 2:
            a = a / np.sqrt(np.prod(s.shape[:-1]))
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def pair(cfg, seed):
    """(the JAX model holding the tree, the port model with its weights)."""
    tree = random_tree(cfg, seed)
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, seed=seed, **cfg)
    jax_model.params = {"net": tree}
    model = DiffusionModel(net_t=UNetV0, device="cpu", **cfg)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    return jax_model, model


def batch(seed, b=2):
    return np.random.RandomState(seed).randn(b, 1, LENGTH).astype(
        np.float32) * 0.5


def jax_draws(key, b, shape, guided=False):
    """The draws a JAX target program makes from ``key``: t ~ U{1..N} (or σ
    ~ U(0, 1) for guidance), then ε."""
    k_t, k_eps = jax.random.split(key)
    first = (jax.random.uniform(k_t, (b,), jnp.float32) if guided
             else jax.random.randint(k_t, (b,), 1, N + 1))
    return np.asarray(first), np.asarray(jax.random.normal(k_eps, shape))


def feed(monkeypatch, draws):
    """Replace the port's draw hooks with ``draws`` (numpy arrays, in
    order); each draw must ask for the shape of the array it takes."""
    queue = list(draws)

    def take(shape):
        a = torch.from_numpy(np.array(queue.pop(0)))
        assert tuple(a.shape) == tuple(shape)
        return a

    monkeypatch.setattr(port_noise, "randint",
                        lambda g, lo, hi, shape, device:
                        take(shape).to(torch.int64).to(device))
    monkeypatch.setattr(port_noise, "uniform",
                        lambda g, shape, dtype, device:
                        take(shape).to(dtype=dtype, device=device))
    monkeypatch.setattr(port_noise, "normal",
                        lambda g, shape, dtype, device:
                        take(shape).to(dtype=dtype, device=device))
    return queue


@pytest.fixture(scope="module")
def jax_targets():
    """The JAX N = 4 teacher-target program, compiled once for the file."""
    cache, original = {}, jax_distill.make_teacher_targets

    def make(net, num_student_steps, mesh=None):
        assert num_student_steps == N and mesh is None
        if net not in cache:
            cache[net] = original(net, N)
        return cache[net]

    return make


@pytest.fixture(scope="module")
def uncond():
    return pair(TINY, 0)


class _AnalyticNet:
    """A perfect v-oracle for a fixed (x0, ε): along z(σ) = α·x0 + β·ε the
    true v is α·ε − β·x0."""

    def __init__(self, x0, eps):
        self.x0, self.eps = x0, eps

    def apply(self, params, z, sig, **cond):
        a, b = alpha_beta(pad_dims(sig, z.ndim - 1))
        return a * self.eps - b * self.x0


def test_two_step_target_algebra_exact():
    gen = torch.Generator().manual_seed(0)
    x0, eps = torch.randn(2, 1, 64, generator=gen), torch.randn(
        2, 1, 64, generator=gen)
    sig_t = torch.tensor([3 / 8, 7 / 8])
    a_t, b_t = alpha_beta(pad_dims(sig_t, 2))
    x_t = a_t * x0 + b_t * eps
    v = _two_step_target(_AnalyticNet(x0, eps), {}, x_t, sig_t, 8)
    torch.testing.assert_close(v, a_t * eps - b_t * x0, atol=1e-5, rtol=0)


def test_teacher_targets_match_jax(uncond, jax_targets, monkeypatch):
    jax_model, model = uncond
    x = batch(1)
    key = jax.random.key(42)
    want = [np.asarray(a) for a in jax_targets(jax_model.net, N)(
        jax_model.params["net"], key, jnp.asarray(x))]
    feed(monkeypatch, jax_draws(key, 2, x.shape))
    got = [a.numpy() for a in make_teacher_targets(model.net, N)(
        model.params, None, torch.from_numpy(x))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.abs(got[2] - want[2]).max() <= 1e-4
    assert got[1].dtype == np.float32


def test_guidance_targets_match_jax(monkeypatch):
    jax_model, model = pair(CFG_TINY, 3)
    rs = np.random.RandomState(4)
    x = batch(5, b=4)
    emb = rs.randn(4, EMB_LEN, EMB_FEAT).astype(np.float32)
    key = jax.random.key(11)
    want = [np.asarray(a) for a in jax_distill.make_guidance_targets(
        jax_model.net, SCALE)(jax_model.params["net"], key, jnp.asarray(x),
                              embedding=jnp.asarray(emb))]
    feed(monkeypatch, jax_draws(key, 4, x.shape, guided=True))
    got = [a.numpy() for a in make_guidance_targets(model.net, SCALE)(
        model.params, None, torch.from_numpy(x),
        embedding=torch.from_numpy(emb))]
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=0)
    assert np.abs(got[2] - want[2]).max() <= 1e-4


def test_split_pipeline_matches_fused_loss(uncond):
    _, model = uncond
    x = torch.from_numpy(batch(7))
    params = model.params
    fused = make_distill_loss(model.net, params, num_student_steps=N)(
        params, torch.Generator().manual_seed(3), x)
    x_t, sig_t, v_tgt = make_teacher_targets(model.net, N)(
        params, torch.Generator().manual_seed(3), x)
    split = torch.mean(torch.square(model.net.apply(params, x_t, sig_t)
                                    - v_tgt))
    torch.testing.assert_close(fused, split, rtol=1e-6, atol=0)
    assert fused.requires_grad and not v_tgt.requires_grad


def test_teacher_targets_dequantize_int16_batches(uncond):
    _, model = uncond
    xi = torch.from_numpy((batch(1) * 16000).astype(np.int16))
    targets = make_teacher_targets(model.net, N)
    got_i = targets(model.params, torch.Generator().manual_seed(5), xi)
    got_f = targets(model.params, torch.Generator().manual_seed(5),
                    xi.to(torch.float32) / 32768.0)
    for a, b in zip(got_i, got_f):
        assert torch.equal(a, b)


class _Recording(torch.optim.Adam):
    """Adam that keeps each step's gradients."""

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        self.grads = []

    def step(self, closure=None):
        self.grads.append([p.grad.detach().clone()
                           for p in self.param_groups[0]["params"]])
        return super().step(closure)


def test_stage_matches_jax(jax_targets, monkeypatch):
    jax_model, model = pair(TINY, 6)
    old = {k: v.detach().clone() for k, v in model.params.items()}
    xs = [batch(10 + i) for i in range(STEPS)]
    # The keys the JAX stage consumes: the train state's, then the
    # targets' (folded with the step index).
    rng = jax_model._rng
    _, tkey = jax.random.split(jax.random.split(rng)[0])
    draws = []
    for i in range(STEPS):
        draws += jax_draws(jax.random.fold_in(tkey, i), 2, xs[i].shape)
    monkeypatch.setattr(jax_distill, "make_teacher_targets", jax_targets)
    metrics_j = jax_distill.ProgressiveDistiller(
        jax_model, base_steps=2 * N, learning_rate=LR).stage(
        iter([jnp.asarray(x) for x in xs]), num_train_steps=STEPS,
        log_fn=lambda s: None)
    new_j = params_from_jax(jax_model.params["net"])

    feed(monkeypatch, draws)
    optimizers = []
    logs = []

    def recording(leaves):
        optimizers.append(_Recording(leaves, lr=LR))
        return optimizers[-1]

    distiller = ProgressiveDistiller(model, base_steps=2 * N,
                                     optimizer=recording)
    metrics_t = distiller.stage(iter(xs), num_train_steps=STEPS,
                                log_fn=logs.append, log_every=2)
    assert distiller.steps == N
    assert [s.split(":")[0] for s in logs] == [
        "distill 8->4 step 2/3", "distill 8->4 step 3/3"]
    assert logs[-1].endswith(f"loss={float(metrics_t['loss']):.5f}")
    assert float(metrics_t["loss"]) == pytest.approx(
        float(metrics_j["loss"]), rel=1e-4)

    grads = optimizers[0].grads
    assert len(grads) == STEPS
    names = list(model.params)
    unclear = []
    for j, name in enumerate(names):
        got = model.params[name].detach().numpy()
        want = new_j[name].numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * LR * STEPS + 5e-7, name
        clear = np.ones(got.shape, bool)
        for step_grads in grads:
            g = step_grads[j].numpy()
            norm = float(torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(t) for t in step_grads])))
            clear &= np.abs(g) > max(1e-3 * np.abs(g).max(), 1e-6 * norm)
        if not clear.any():
            unclear.append(name)
            continue
        assert diff[clear].max() <= 5e-7, name
        assert np.abs(got - old[name].numpy())[clear].min() > 0, name
    # Biases that a one-channel-per-group GroupNorm removes (level 0: 8
    # channels, 8 groups): their gradients are rounding noise.
    assert all(n.endswith("bias") for n in unclear) and len(unclear) <= 6, \
        unclear


def test_guidance_stage_accepts_tuple_batches():
    _, model = pair(CFG_TINY, 7)
    old = {k: v.detach().clone() for k, v in model.params.items()}
    x = batch(8, b=4)
    emb = np.random.RandomState(9).randn(4, EMB_LEN, EMB_FEAT).astype(
        np.float32)
    distiller = ProgressiveDistiller(model, base_steps=4, learning_rate=1e-3)
    logs = []
    metrics = distiller.guidance_stage(
        itertools.repeat((x, {"embedding": emb})), embedding_scale=SCALE,
        num_train_steps=2, log_fn=logs.append, log_every=1)
    assert np.isfinite(float(metrics["loss"])) and distiller.steps == 4
    assert [s.split(":")[0] for s in logs] == [
        "distill guidance(w=3) step 1/2", "distill guidance(w=3) step 2/2"]
    # The student's pass is conditional and unmasked: every parameter moves
    # but the fixed (null) embedding, which only the teacher's guided pass
    # reads.
    still = [k for k, v in model.params.items() if torch.equal(v, old[k])]
    assert still == ["inner.fixed_embedding"]


def test_abort_leaves_params_whole(uncond):
    _, model = uncond
    old = {k: v.detach().clone() for k, v in model.params.items()}

    def batches():
        yield batch(1)
        raise RuntimeError("data source failed")

    distiller = ProgressiveDistiller(model, base_steps=8)
    with pytest.raises(RuntimeError, match="data source"):
        distiller.stage(batches(), num_train_steps=3, log_fn=lambda s: None)
    assert distiller.steps == 8
    assert all(torch.equal(v, old[k]) for k, v in model.params.items())


def test_distiller_guards(uncond):
    _, model = uncond
    for steps in (7, 0):
        with pytest.raises(ValueError, match="even"):
            ProgressiveDistiller(model, base_steps=steps)
    distiller = ProgressiveDistiller(model, base_steps=6)
    distiller.steps = 3
    with pytest.raises(ValueError, match="odd step count"):
        distiller.stage(iter([batch(0)]), num_train_steps=1)
    with pytest.raises(NotImplementedError, match=r"item 4\)"):
        ProgressiveDistiller(model, base_steps=8, mesh=object())
    adam = functools.partial(torch.optim.Adam, lr=1e-4)
    assert ProgressiveDistiller(model, 8, optimizer=adam).optimizer is adam
