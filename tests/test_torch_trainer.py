"""The port's Trainer (audio_diffusion_torch.train) against the JAX
package's, on the CPU, on the 3-level config of tests/test_torch_unet.py
with the same weights (a seeded numpy tree carried across by
``params_from_jax``) and batches, σ and noise made with numpy and fed per
step as ``(x, cond)`` batches.

Tolerances.
- The optimizer chain (``ClipAdamW``) against ``optax.chain(
  clip_by_global_norm, adamw)`` as the JAX Trainer builds it, 6 steps of
  seeded numpy gradients (|g| far above Adam's eps, the global norm below
  and above ``max_grad_norm``): every parameter within 1e-6 of its leaf's
  largest value (float32 sums in another order), and the learning rates
  of the two schedules within float32 rounding (rel 1e-6).
- ``Trainer.fit`` against the JAX Trainer, float32, 4 steps (warmup,
  cosine decay, clipping, weight decay, EMA): the bars of
  tests/test_torch_train.py. The last loss and gradient norm rel 1e-4.
  Adam turns a rounding-noise gradient (a bias that a one-channel-per-group
  GroupNorm removes) into a ±lr step, so every parameter and EMA value is
  within 3·2·lr; and all but a few of them (under 1%, those leaves) within
  1e-6 of their leaf's largest value (at least 1).
- The JAX state after 2 steps continued in the port
  (``train_state_from_jax``) for the JAX run's other 2: the same bars, and
  Adam's first moments within 1e-4 of their leaf's largest value.
- Resume, pruning and the rest run in the port alone: bit for bit.
"""
import itertools
import types

import jax
import numpy as np
import optax
import pytest
import torch

from audio_diffusion_torch import (DiffusionModel, UNetV0, params_from_jax,
                                   train_state_from_jax)
from audio_diffusion_torch.train import (ClipAdamW, Trainer, TrainerConfig,
                                         lr_schedule)
from audio_diffusion_tpu.train import Trainer as JaxTrainer
from audio_diffusion_tpu.train import TrainerConfig as JaxTrainerConfig
from test_torch_train import batch_sigma_noise, jax_loss_fn, port_loss_fn
from test_torch_unet import CFG, jax_net_and_params, port_model

torch.set_num_threads(2)

LR = 1e-3
PARITY = dict(learning_rate=LR, weight_decay=0.01, max_grad_norm=1.0,
              lr_schedule="cosine", warmup_steps=1, total_steps=6,
              ema_decay=0.9, log_every=100)
SCHEDULES = {
    "constant": dict(),
    "warmup": dict(warmup_steps=2),
    "cosine": dict(lr_schedule="cosine", warmup_steps=2, total_steps=5),
}


def _shim(**kw):
    return types.SimpleNamespace(loss=lambda *a, **k: 0.0, **kw)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_optimizer_chain_matches_optax(schedule):
    cfg = dict(learning_rate=0.05, weight_decay=0.1, max_grad_norm=1.0,
               **SCHEDULES[schedule])
    tx = JaxTrainer(_shim(), JaxTrainerConfig(**cfg)).optimizer
    rs = np.random.RandomState(0)
    params = {"a": rs.randn(7, 5).astype(np.float32),
              "b": rs.randn(13).astype(np.float32)}
    # Global norms below and above max_grad_norm (1.0), and one on it.
    norms = [0.5, 3.0, 0.9, 1.0, 7.0, 0.2]
    grads = []
    for n in norms:
        g = {k: rs.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
        total = np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                            for v in g.values()))
        grads.append({k: (v * (n / total)).astype(np.float32)
                      for k, v in g.items()})
    state, want = tx.init(params), dict(params)
    for g in grads:
        upd, state = tx.update(g, state, want)
        want = optax.apply_updates(want, upd)

    leaves = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
    factory = Trainer(_shim(), TrainerConfig(**cfg)).optimizer
    opt = factory(list(leaves.values()))
    assert isinstance(opt, ClipAdamW)
    assert opt.param_groups[0]["weight_decay"] == 0.1
    for step, g in enumerate(grads):
        assert opt.updates() == step
        for k, p in leaves.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in leaves.items():
        got, w = p.detach().numpy(), np.asarray(want[k])
        assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max(), k


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_lr_schedule_matches_optax(schedule):
    cfg = TrainerConfig(learning_rate=1e-4, **SCHEDULES[schedule])
    want = {"constant": lambda k: 1e-4,
            "warmup": optax.linear_schedule(0.0, 1e-4, 2),
            "cosine": optax.warmup_cosine_decay_schedule(0.0, 1e-4, 2, 5),
            }[schedule]
    got = lr_schedule(cfg)
    for k in range(8):
        assert got(k) == pytest.approx(float(want(k)), rel=1e-6, abs=1e-12)
    if schedule != "constant":
        assert got(0) == 0.0  # the first update has LR 0 after a warmup


def feed(seeds):
    """(x, {"sigmas", "noise"}) batches from numpy, one per seed."""
    out = []
    for s in seeds:
        x, sigmas, noise = batch_sigma_noise(s)
        out.append((x, dict(sigmas=sigmas, noise=noise)))
    return out


class JaxShim:
    """What the JAX Trainer needs of a model, with the loss of
    test_torch_train.py (σ and noise passed in)."""

    def __init__(self, net, tree):
        self.loss = jax_loss_fn(net)
        self.params = tree

    def next_key(self):
        return jax.random.key(0)


def port_trainer(tree, **cfg):
    model = port_model(CFG, tree)
    shim = types.SimpleNamespace(loss=port_loss_fn(model), params=model.params,
                                 device=model.device,
                                 generator=model.generator)
    return Trainer(shim, TrainerConfig(**cfg), log_fn=lambda s: None)


def assert_close_to_jax(got, want, what):
    """The bars of the module docstring on two {name: array} dicts."""
    assert set(got) == set(want), what
    loose = total = 0
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = np.asarray(w)
        diff = np.abs(g - w)
        assert diff.max() <= 3 * 2 * LR + 1e-6, (what, name, diff.max())
        loose += int((diff > 1e-6 * max(np.abs(w).max(), 1.0)).sum())
        total += diff.size
    assert loose <= 0.01 * total, (what, loose, total)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Trainer over 4 batches: its state after 2 steps (as the
    content of ``Trainer.load_state_dict``), its last metrics and its state
    after 4."""
    net, _, tree = jax_net_and_params()
    batches = feed([21, 22, 23, 24])
    jt = JaxTrainer(JaxShim(net, tree), JaxTrainerConfig(**PARITY),
                    log_fn=lambda s: None)
    jt.fit(iter(batches[:2]), num_steps=2)
    content = train_state_from_jax(jax.tree_util.tree_map(
        np.asarray, jt.state._replace(rng=None)))
    metrics = jt.fit(iter(batches[2:]), num_steps=2)
    return dict(tree=tree, batches=batches, at_2=content, metrics=metrics,
                state=jt.state, ema=jt.ema_params)


def test_fit_matches_jax_trainer(jax_run):
    pt = port_trainer(jax_run["tree"], **PARITY)
    mt = pt.fit(iter(jax_run["batches"]), num_steps=4)
    mj = jax_run["metrics"]
    assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-4)
    assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]),
                                                   rel=1e-4)
    # The gradient norm is the one before clipping: above max_grad_norm.
    assert float(mt["grad_norm"]) > PARITY["max_grad_norm"]
    assert int(pt.state.step) == int(jax_run["state"].step) == 4
    assert_close_to_jax(pt.state.params,
                        params_from_jax(jax_run["state"].params), "params")
    assert_close_to_jax(pt.ema_params, params_from_jax(jax_run["ema"]), "ema")


def test_jax_state_continues_in_the_port(jax_run):
    """The JAX state after 2 steps, carried by train_state_from_jax, then
    the 2 more steps the JAX run took."""
    content = jax_run["at_2"]
    assert content["step"] == 2 and content["generator"] is None
    pt = port_trainer(jax_run["tree"], **PARITY)
    pt.init_state()
    pt.load_state_dict(content)
    first = next(iter(pt.state.params))
    assert pt.state.optimizer.updates() == 2
    assert torch.equal(pt.state.params[first], content["params"][first])
    pt.fit(iter(jax_run["batches"][2:]), num_steps=2)
    assert int(pt.state.step) == 4
    state = jax_run["state"]
    assert_close_to_jax(pt.state.params, params_from_jax(state.params),
                        "params")
    assert_close_to_jax(pt.ema_params, params_from_jax(jax_run["ema"]), "ema")
    opt = pt.state.optimizer
    adam = state.opt_state[1][0]
    for name, w in params_from_jax(adam.mu).items():
        got = opt.state[pt.state.params[name]]["exp_avg"].numpy()
        w = w.numpy()
        assert np.abs(got - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-3), \
            name
    # Strict: an optimizer state it cannot map raises.
    bad = state._replace(opt_state=(optax.trace(0.9).init(state.params),))
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        train_state_from_jax(bad)


TINY = dict(net_t=UNetV0, in_channels=1, channels=[8, 16], factors=[1, 2],
            items=[1, 1], modulation_features=32, device="cpu")


def tone_batches(batch_size=4, length=64):
    t = np.arange(length) / length
    tone = np.sin(2 * np.pi * 4 * t).astype(np.float32)
    return itertools.repeat(np.tile(tone, (batch_size, 1, 1)))


def snapshot(trainer):
    s = trainer.state
    return ({n: p.detach().clone() for n, p in s.params.items()},
            {n: e.clone() for n, e in s.ema.items()},
            {n: {k: v.clone() for k, v in s.optimizer.state[p].items()}
             for n, p in s.params.items()})


def test_resume_is_bit_exact_and_ignores_torn_saves(tmp_path):
    """4 straight steps against 2, a save, a fresh model and trainer, a
    restore and 2 more: the same bits (σ and noise drawn from the restored
    generator). A torn save is ignored; pruning keeps max_checkpoints."""
    cfg = dict(learning_rate=1e-3, ema_decay=0.9, max_grad_norm=0.5,
               lr_schedule="cosine", warmup_steps=1, total_steps=6,
               log_every=100, checkpoint_every=1, max_checkpoints=2)
    straight = Trainer(DiffusionModel(**TINY), TrainerConfig(**cfg),
                       log_fn=lambda s: None)
    straight.fit(tone_batches(), num_steps=4)

    ck = str(tmp_path / "ck")
    first = Trainer(DiffusionModel(**TINY),
                    TrainerConfig(checkpoint_dir=ck, **cfg),
                    log_fn=lambda s: None)
    first.fit(tone_batches(), num_steps=2)
    assert first.checkpoint_steps() == [1, 2]
    del first
    (tmp_path / "ck" / "7").mkdir()  # a step directory without its file
    torn = tmp_path / "ck" / ".tmp-8-x"
    torn.mkdir()
    (torn / "state.pt").write_bytes(b"partial")
    resumed = Trainer(DiffusionModel(**TINY, seed=9),
                      TrainerConfig(checkpoint_dir=ck, **cfg),
                      log_fn=lambda s: None)
    assert resumed.restore_latest() == 2
    resumed.fit(tone_batches(), num_steps=2)
    assert int(resumed.state.step) == 4
    for a, b in zip(snapshot(straight), snapshot(resumed)):
        assert a.keys() == b.keys()
        for name in a:
            if isinstance(a[name], dict):
                for k in a[name]:
                    assert torch.equal(a[name][k], b[name][k]), (name, k)
            else:
                assert torch.equal(a[name], b[name]), name
    assert resumed.checkpoint_steps() == [3, 4]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        ".tmp-8-x", "3", "4", "7"]


def test_fit_options():
    """debug_nans raises at the first non-finite loss and leaves no mode on;
    the steps_per_call tail; (x, cond) batches need steps_per_call=1; the
    assertion messages; a mesh= that is no DeviceMesh raises."""
    model = DiffusionModel(**TINY)
    t = Trainer(model, TrainerConfig(debug_nans=True, log_every=100),
                log_fn=lambda s: None)
    bad = np.full((4, 1, 64), np.nan, np.float32)
    with pytest.raises(FloatingPointError, match="step 2"):
        t.fit(itertools.chain([next(tone_batches())], itertools.repeat(bad)),
              num_steps=3)
    assert not torch.is_anomaly_enabled()

    logs = []
    t = Trainer(DiffusionModel(**TINY),
                TrainerConfig(steps_per_call=2, log_every=2),
                log_fn=logs.append)
    m = t.fit(tone_batches(), num_steps=5)  # 2 calls of 2 and a tail of 1
    assert int(t.state.step) == 5 and int(m["step"]) == 5
    assert [ln.split(":")[0] for ln in logs] == ["step 2", "step 4",
                                                 "step 5"]
    pairs = ((x, {}) for x in tone_batches())
    with pytest.raises(ValueError, match="steps_per_call=1"):
        t.fit(pairs, num_steps=2)

    with pytest.raises(AssertionError, match="total_steps"):
        Trainer(model, TrainerConfig(lr_schedule="cosine"))
    with pytest.raises(AssertionError, match="unknown lr_schedule"):
        Trainer(model, TrainerConfig(lr_schedule="linear"))
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(model, mesh=object())


def test_fit_with_cond_batches_device_corpus_and_profile(tmp_path):
    """(x, cond) batches reach the loss; device batches (a DeviceCorpus on
    the CPU) train; profile_dir writes a trace of its window."""
    from audio_diffusion_torch.data import DeviceCorpus, wav_write

    seen = []
    model = DiffusionModel(**TINY)
    loss = model.loss

    def spy(params, generator, x, **cond):
        seen.append(sorted(cond))
        return loss(params, generator, x)

    shim = types.SimpleNamespace(loss=spy, params=model.params,
                                 device=model.device,
                                 generator=model.generator)
    t = Trainer(shim, TrainerConfig(log_every=100), log_fn=lambda s: None)
    t.fit(((x, {"tag": np.zeros(4)}) for x in tone_batches()),
          num_steps=2, other=1)
    assert seen == [["other", "tag"]] * 2

    rs = np.random.default_rng(0)
    for i in range(2):
        wav_write(tmp_path / f"f{i}.wav", rs.uniform(-.5, .5, (1, 300)), 8000)
    dc = DeviceCorpus(tmp_path, crop_frames=64, batch_size=4, device="cpu")
    prof = tmp_path / "prof"
    t = Trainer(DiffusionModel(**TINY),
                TrainerConfig(steps_per_call=2, log_every=100,
                              profile_dir=str(prof), profile_start_step=2,
                              profile_num_steps=2), log_fn=lambda s: None)
    m = t.fit(iter(dc), num_steps=4)
    assert np.isfinite(float(m["loss"])) and int(t.state.step) == 4
    assert [p.name for p in prof.iterdir()] == ["trace_steps_2_4.json"]
