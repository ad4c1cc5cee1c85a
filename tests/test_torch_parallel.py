"""The port's multi-GPU training path (audio_diffusion_torch.parallel, and
mesh= through the Trainer, DeviceCorpus and the distiller) on the CPU:
in this process on a one-rank mesh, and over two gloo ranks, each a process
running this file as a worker (``python tests/test_torch_parallel.py
--worker RANK PORT DIR``, which imports no JAX). One spawn per module runs
every two-rank scenario and saves each rank's results; each test asserts on
one scenario. The net is the 3-level TINY of tests/test_parallel.py at 256
samples with 4 GroupNorm groups, float32, the kernel's plain version; the
weights are a seeded JAX tree carried across by ``params_from_jax``, and
where the port is held against the JAX package, the JAX package's draws
are fed through ``diffusion/noise.py``. With 8 groups level 0 would have
one channel per group, whose conv biases a GroupNorm removes: their
gradient is rounding noise, which Adam turns into a ±lr step.

Tolerances.
- DP loss vs the JAX single-device loss and vs JAX DP over the 8 virtual
  CPU devices: rtol 2e-5, the bar of tests/test_parallel.py:89-90.
- Parameters after two Adam steps vs the port's one-process step at the
  global batch: atol 1e-6 (tests/test_torch_train.py's bar for a sum in
  another order) where every step's gradient exceeds 1e-6 of the gradient
  norm, so that Adam's normalized update is beyond the rounding, as
  tests/test_torch_train.py compares; elsewhere (under 1% of the
  elements) Adam may turn a rounding difference into up to ±lr per step, and the bar
  is 2·lr per step. The loss and gradient norm rtol 2e-5. The same bars
  under accum_steps=2 and steps_per_call=2.
- ZeRO-1 vs no ZeRO-1 on the same mesh: bit-equal parameters and moments.
- The model axis (model=2) vs one process: parameters atol 1e-6.
- DeviceCorpus(mesh=), the Trainer's resume and save-perturb-restore: bit
  for bit.
- ProgressiveDistiller(mesh=) vs one process: loss rtol 2e-5.
"""
import contextlib
import functools
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from audio_diffusion_torch import (DiffusionModel, ProgressiveDistiller,
                                   UNetV0, make_train_step)
from audio_diffusion_torch.data import AudioDataset, DeviceCorpus, wav_write
from audio_diffusion_torch.diffusion import noise as port_noise
from audio_diffusion_torch.parallel import (create_mesh, global_batch,
                                            param_sharding_rules,
                                            shard_batch)
from audio_diffusion_torch.parallel.train_step import Slice, gather_slices
from audio_diffusion_torch.train import Trainer, TrainerConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(in_channels=2, channels=[8, 32, 256], factors=[1, 4, 2],
            items=[1, 1, 1], attentions=[0, 0, 1], attention_heads=4,
            attention_features=8, modulation_features=64, resnet_groups=4)
LENGTH = 256
BATCH = 8  # global; 4 rows per rank
LR = 1e-4
STEPS = 2


# ----------------------------------------------------------------- helpers
@contextlib.contextmanager
def one_rank_mesh():
    """``create_mesh("cpu")`` over a one-rank group made in this process; the
    group is destroyed afterwards."""
    mesh = create_mesh("cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: Path, root: Path, timeout: float = 120):
    """Run ``script --worker RANK PORT ROOT`` as two gloo ranks; wait for
    both with a timeout, check both exit codes, and return each rank's
    saved results."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(script), "--worker", str(r), str(port),
         str(root)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err[-4000:]}"
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def join_group(rank: int, port: int) -> None:
    """A worker's rendezvous: the launcher's variables, as torchrun sets
    them; ``create_mesh`` joins through them."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank))


def port_model(params, seed: int = 0) -> DiffusionModel:
    model = DiffusionModel(net_t=UNetV0, device="cpu", seed=seed, **TINY)
    model.net.module.load_state_dict(params, strict=True)
    return model


@contextlib.contextmanager
def fed(draws):
    """The port's draw hooks replaced by ``draws`` (tensors, in order);
    each draw must ask for the shape of the tensor it takes."""
    queue = list(draws)
    saved = port_noise.normal, port_noise.uniform

    def take(g, shape, dtype, device):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return a.to(dtype=dtype, device=device)

    port_noise.normal = port_noise.uniform = take
    try:
        yield queue
    finally:
        port_noise.normal, port_noise.uniform = saved


class RecordingAdam(torch.optim.Adam):
    """Adam that keeps each step's gradients (the one-process reference's,
    for the rounding mask of :func:`params_close`)."""

    seen: list = []

    def step(self, closure=None):
        RecordingAdam.seen.append([p.grad.detach().clone()
                                   for g in self.param_groups
                                   for p in g["params"]])
        return super().step(closure)


def adam(recording: bool = False):
    return functools.partial(RecordingAdam if recording else torch.optim.Adam,
                             lr=LR)


def run_steps(model, x, mesh=None, draws=None, recording=False, **kw):
    """STEPS Adam steps of ``model.loss`` on ``x`` (this rank's rows with a
    mesh); returns (losses, grad norms, parameters, state)."""
    init, step = make_train_step(model.loss, adam(recording), mesh=mesh,
                                 **kw)
    state = init(model.params, torch.Generator().manual_seed(7))
    losses, norms = [], []
    with (fed(draws) if draws is not None else contextlib.nullcontext()):
        for _ in range(STEPS):
            state, m = step(state, x)
            losses.append(m["loss"].reshape(-1)[0].item())
            norms.append(m["grad_norm"].reshape(-1)[0].item())
    return losses, norms, {k: v.detach().clone()
                           for k, v in state.params.items()}, state


def make_corpus(root: Path, files: int = 4, frames: int = 700) -> Path:
    d = root / "wavs"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(files):
        data = np.clip(rng.standard_normal((2, frames + 37 * i)) * 0.3,
                       -0.99, 0.99).astype(np.float32)
        wav_write(d / f"f{i}.wav", data, 16000, bits=16)
    return d


def trainer_config(root: Path, name: str, every: int) -> TrainerConfig:
    return TrainerConfig(learning_rate=1e-3, max_grad_norm=0.05,
                         ema_decay=0.9, checkpoint_dir=str(root / name),
                         checkpoint_every=every, log_every=1)


# ------------------------------------------------------------ the worker
def worker(rank: int, port: int, root: Path) -> None:
    join_group(rank, port)
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    params, x = inputs["params"], inputs["x"]
    dp = create_mesh("cpu")
    mp = create_mesh("cpu", data=1, model=2)
    out = {"shape": tuple(dp.shape), "mp_shape": tuple(mp.shape),
           "rows": shard_batch(torch.arange(BATCH)[:, None], dp)[:, 0],
           "global": global_batch(np.ones((3, 2)), dp).shape}
    local = shard_batch(x, dp)

    # DP, fed the JAX package's draws.
    out["fed"] = run_steps(port_model(params), local, dp,
                           draws=inputs["draws"])[:3]
    for name, kw in (("accum", dict(accum_steps=2)),
                     ("spc", dict(steps_per_call=2))):
        xs = (torch.stack([shard_batch(b, dp) for b in inputs["xs"]])
              if name == "spc" else local)
        init, step = make_train_step(port_model(params).loss, adam(),
                                     mesh=dp, **kw)
        model = port_model(params)
        state = init(model.params, torch.Generator().manual_seed(7))
        state, m = step(state, xs)
        out[name] = (m["loss"].reshape(-1).tolist(),
                     {k: v.detach().clone() for k, v in state.params.items()})

    # ZeRO-1 against no ZeRO-1 on the same mesh.
    runs = {}
    for z in (False, True):
        _, _, p, state = run_steps(port_model(params), local, dp, zero1=z)
        moments = {}
        for name in p:
            st = state.optimizer.state[state.optimizer_leaf(name)]
            moments[name] = (st["exp_avg"], st["exp_avg_sq"])
        runs[z] = (p, moments, state)
    (p0, m0, _), (p1, m1, s1) = runs[False], runs[True]
    out["zero1"] = {
        "params_equal": all(torch.equal(p0[k], p1[k]) for k in p0),
        "moments_equal": all(
            torch.equal(s1.shards[k].cut(m0[k][i]) if k in s1.shards
                        else m0[k][i], m1[k][i])
            for k in p0 for i in (0, 1)),
        "fractions": {k: m1[k][0].numel() / p0[k].numel() for k in p0}}

    # The model axis: each rank holds half of each rule-sharded leaf.
    model = port_model(params)
    rules = param_sharding_rules(model.params, mp)
    _, _, p, state = run_steps(model, x, mp, ema_decay=0.9)
    out["model"] = {
        "rules": rules, "params": p,
        "held": {k: (tuple(state.optimizer_leaf(k).shape),
                     tuple(state.optimizer.state[
                         state.optimizer_leaf(k)]["exp_avg"].shape),
                     tuple(state.ema[k].shape)) for k in p}}

    # DeviceCorpus: this rank's rows of the global batch.
    dc = DeviceCorpus(inputs["corpus"], crop_frames=128, batch_size=4,
                      seed=3, mesh=dp)
    out["corpus"] = [dc.batch_at(s) for s in (0, 5)]

    # The Trainer on the data mesh over disjoint file shards.
    ds = AudioDataset(inputs["corpus"], crop_frames=LENGTH, batch_size=2,
                      seed=1, num_hosts=2)
    logs = []
    trainer = Trainer(port_model(params), trainer_config(root, "dp", 2),
                      mesh=dp, log_fn=logs.append)
    feed = (global_batch(b, dp) for b in ds)
    losses = [trainer.fit(feed, num_steps=1)["loss"].item()
              for _ in range(STEPS)]
    saved = trainer.state_dict()
    with torch.no_grad():
        for p in trainer.state.params.values():
            p.add_(0.5)
    step = trainer.restore_latest()
    out["trainer"] = {"files": [f.name for f in ds.files], "losses": losses,
                      "logs": logs, "saved": saved, "step": step,
                      "restored": trainer.state_dict()}

    # The Trainer on the model mesh: its checkpoint gathers the shards.
    trainer = Trainer(port_model(params), trainer_config(root, "mp", 1),
                      mesh=mp, log_fn=lambda s: None)
    trainer.fit(iter([x]), num_steps=1)
    out["trainer_mp"] = {"saved": trainer.state_dict(),
                         "ema": trainer.ema_params}

    # One halving step of distillation over the data mesh.
    model = port_model(params)
    d = ProgressiveDistiller(model, base_steps=4, mesh=dp)
    m = d.stage(iter([local]), num_train_steps=1, log_fn=lambda s: None)
    out["distill"] = m["loss"].item()

    # A gather of each rank's slices, in rank order.
    part = torch.full((2, 3), float(rank))
    out["gathered"] = gather_slices(
        [part], [Slice(part, 1, rank, 2, dp.get_group("data"))])[0]
    torch.save(out, root / f"rank{rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------- the parent
@functools.lru_cache(maxsize=None)
def jax_setup():
    """The JAX model of TINY (seeded numpy weights), its params in the port's
    names, the global batch and two steps' JAX keys."""
    import jax
    import jax.numpy as jnp

    from audio_diffusion_torch import params_from_jax
    from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
    from audio_diffusion_tpu import UNetV0 as JaxUNetV0

    model = JaxDiffusionModel(net_t=JaxUNetV0, seed=0, **TINY)
    x = np.random.default_rng(1).standard_normal(
        (BATCH, 2, LENGTH)).astype(np.float32) * 0.5
    model.initialize(jnp.asarray(x))
    rs = np.random.RandomState(0)
    # Every leaf random, so the zero-initialized gates carry signal too.
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rs.randn(*a.shape)).astype(
            np.float32), model.params["net"])
    model.params = {"net": tree}
    return model, params_from_jax(tree), x


def jax_draws(key, x):
    """The draws the JAX VDiffusion loss makes from ``key``: σ, then the
    noise (audio_diffusion_tpu/diffusion/vdiffusion.py:61-66)."""
    import jax
    import jax.numpy as jnp

    k_sigma, k_noise, _ = jax.random.split(key, 3)
    return [torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k_sigma, (x.shape[0],), jnp.float32),
        jax.random.normal(k_noise, x.shape))]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank scenario, with what the parent holds them against."""
    import jax
    import jax.numpy as jnp

    from audio_diffusion_tpu.parallel import create_mesh as jax_mesh
    from audio_diffusion_tpu.parallel import shard_batch as jax_shard

    root = tmp_path_factory.mktemp("two_ranks")
    jmodel, params, x = jax_setup()
    keys = [jax.random.key(10 + i) for i in range(STEPS)]
    draws = [d for k in keys for d in jax_draws(k, x)]
    xs = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, BATCH, 2, LENGTH)).astype(np.float32) * 0.5)
    torch.save(dict(params=params, x=torch.from_numpy(x), draws=draws,
                    xs=xs, corpus=str(make_corpus(root))),
               root / "inputs.pt")
    ranks = spawn(Path(__file__), root)
    loss = jax.jit(jmodel.loss)
    mesh8 = jax_mesh()
    ref = dict(
        jax_loss=float(loss(jmodel.params, keys[0], jnp.asarray(x))),
        jax_dp_loss=float(loss(jmodel.params, keys[0],
                               jax_shard(jnp.asarray(x), mesh8))),
        jax_rules=jax_rules(jmodel))
    return root, params, ranks, ref


def jax_rules(jmodel):
    """JAX param_sharding_rules on a model=2 mesh, in the port's names and
    layout (a Dense kernel's spec reversed, as the bridge transposes it)."""
    import jax

    from audio_diffusion_torch import params_from_jax
    from audio_diffusion_tpu.parallel import create_mesh as jax_mesh
    from audio_diffusion_tpu.parallel import param_sharding_rules as rules

    def code(spec, a):
        """A leaf that varies along its sharded axis only (zeros if
        replicated), so the bridge carries the axis, transposes included,
        under the port's names."""
        out = np.zeros(a.shape, np.float32)
        if "model" in tuple(spec):
            ax = tuple(spec).index("model")
            shape = [1] * a.ndim
            shape[ax] = a.shape[ax]
            out += np.arange(a.shape[ax], dtype=np.float32).reshape(shape)
        return out

    specs = rules(jmodel.params["net"], jax_mesh(model=2))
    coded = params_from_jax(jax.tree_util.tree_map(
        code, specs, jmodel.params["net"],
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)))
    out = {}
    for name, t in coded.items():
        axes = [k for k in range(t.ndim)
                if t.shape[k] > 1 and bool((t.diff(dim=k) != 0).any())]
        out[name] = (tuple("model" if k in axes else None
                           for k in range(t.ndim)) if axes else ())
    return out


def params_close(got, want, grads=None, norms=None):
    """``got`` within 1e-6 of ``want``; with the reference's gradients of
    each step, 2·lr per step where a step's gradient is within 1e-6 of the
    gradient norm of zero (under 1% of all the elements)."""
    masked = 0
    for i, (name, w) in enumerate(want.items()):
        diff = (got[name] - w).abs()
        if grads is not None:
            clear = torch.stack([g[i].abs() > 1e-6 * n
                                 for g, n in zip(grads, norms)]).all(0)
            if not clear.all():
                assert diff[~clear].max().item() <= 2 * LR * len(grads), name
            masked += int((~clear).sum())
            diff = diff[clear]
        assert diff.max().item() <= 1e-6, (name, diff.max().item())
    assert masked < 0.01 * sum(w.numel() for w in want.values())


def one_process(params, x, **kw):
    """The port's STEPS steps in this process; with the gradients each step
    saw."""
    RecordingAdam.seen = []
    out = run_steps(port_model(params), x, recording=True, **kw)
    return out, RecordingAdam.seen


def test_create_mesh_shapes_and_messages():
    with one_rank_mesh() as mesh:
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(AssertionError, match=r"data\(2\) × model\(1\) "
                           r"!= devices\(1\)"):
            create_mesh("cpu", data=2)
        with pytest.raises(AssertionError,
                           match="1 devices not divisible by model=2"):
            create_mesh("cpu", model=2)
        with pytest.raises(ValueError, match="runs gloo"):
            create_mesh("cpu", backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices='cpu'"):
            create_mesh()


def test_shard_and_global_batch_rows_one_rank():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    with one_rank_mesh() as mesh:
        tree = shard_batch({"x": x, "c": [torch.ones(6, 1)]}, mesh)
        assert torch.equal(tree["x"], torch.from_numpy(x))
        assert tree["c"][0].shape == (6, 1)
        assert torch.equal(global_batch(x, mesh), torch.from_numpy(x))


def test_one_rank_mesh_step_is_bit_equal_to_no_mesh():
    _, params, x = jax_setup()
    x = torch.from_numpy(x[:2])
    want, _ = one_process(params, x)
    with one_rank_mesh() as mesh:
        for kw in (dict(), dict(zero1=True)):
            got = run_steps(port_model(params), x, mesh, **kw)
            assert got[0] == want[0] and got[1] == want[1]
            assert all(torch.equal(got[2][k], v) for k, v in want[2].items())


def test_two_rank_mesh_and_batch_rows(two_ranks):
    _, _, ranks, _ = two_ranks
    for r, res in enumerate(ranks):
        assert res["shape"] == (2, 1) and res["mp_shape"] == (1, 2)
        assert res["rows"].tolist() == list(range(4 * r, 4 * r + 4))
        assert tuple(res["global"]) == (3, 2)
        assert torch.equal(res["gathered"],
                           torch.tensor([[0.0] * 3 + [1.0] * 3] * 2))


def test_param_sharding_rules_match_jax(two_ranks):
    _, params, ranks, ref = two_ranks
    rules = ranks[0]["model"]["rules"]
    assert rules == ref["jax_rules"]
    assert set(rules) == set(params) and any(rules.values())


def test_dp_loss_matches_jax(two_ranks):
    _, _, ranks, ref = two_ranks
    for res in ranks:
        loss = res["fed"][0][0]
        np.testing.assert_allclose(loss, ref["jax_loss"], rtol=2e-5)
        np.testing.assert_allclose(loss, ref["jax_dp_loss"], rtol=2e-5)
    assert ranks[0]["fed"][0] == ranks[1]["fed"][0]
    assert ranks[0]["fed"][1] == ranks[1]["fed"][1]


def test_dp_params_match_one_process(two_ranks):
    root, params, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    (losses, norms, want, _), grads = one_process(params, inputs["x"],
                                                  draws=inputs["draws"])
    for res in ranks:
        got_losses, got_norms, got = res["fed"]
        np.testing.assert_allclose(got_losses, losses, rtol=2e-5)
        np.testing.assert_allclose(got_norms, norms, rtol=2e-5)
        params_close(got, want, grads, norms)
    assert all(torch.equal(ranks[0]["fed"][2][k], v)
               for k, v in ranks[1]["fed"][2].items())


@pytest.mark.parametrize("name", ["accum", "spc"])
def test_accum_and_steps_per_call_under_the_mesh(two_ranks, name):
    root, params, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    kw = dict(accum_steps=2) if name == "accum" else dict(steps_per_call=2)
    model = port_model(params)
    init, step = make_train_step(model.loss, adam(True), **kw)
    state = init(model.params, torch.Generator().manual_seed(7))
    RecordingAdam.seen = []
    state, m = step(state, inputs["xs"] if name == "spc" else inputs["x"])
    for res in ranks:
        losses, got = res[name]
        np.testing.assert_allclose(losses, m["loss"].reshape(-1).tolist(),
                                   rtol=2e-5)
        params_close(got, {k: v.detach() for k, v in state.params.items()},
                     RecordingAdam.seen,
                     m["grad_norm"].reshape(-1).tolist())


def test_zero1_is_bit_equal_and_holds_half_of_each_moment(two_ranks):
    _, _, ranks, _ = two_ranks
    for res in ranks:
        z = res["zero1"]
        assert z["params_equal"] and z["moments_equal"]
        assert set(z["fractions"].values()) == {0.5}


def test_model_axis_matches_one_process(two_ranks):
    root, params, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    (_, _, want, _), _ = one_process(params, inputs["x"], ema_decay=0.9)
    for res in ranks:
        m = res["model"]
        for name, w in want.items():
            torch.testing.assert_close(m["params"][name], w, atol=1e-6,
                                       rtol=0)
            master, moment, ema = m["held"][name]
            spec = m["rules"][name]
            half = tuple(n // 2 if ax == "model" else n
                         for n, ax in zip(w.shape, spec)) if spec else \
                tuple(w.shape)
            assert master == moment == ema == half, name
        assert any(m["rules"].values())


def test_device_corpus_rows_are_the_global_batchs(two_ranks):
    root, _, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    dc = DeviceCorpus(inputs["corpus"], crop_frames=128, batch_size=4,
                      seed=3, device="cpu")
    for step, want in zip((0, 5), (dc.batch_at(0), dc.batch_at(5))):
        for r, res in enumerate(ranks):
            assert torch.equal(res["corpus"][step != 0],
                               want[2 * r:2 * r + 2])


def state_equal(a, b) -> bool:
    """Two Trainer state_dicts, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(state_equal(a[k], b[k])
                                             for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def test_trainer_over_two_ranks(two_ranks):
    """Disjoint file shards, the same losses on both ranks, logs on rank 0,
    an exact save-perturb-restore, and the two-rank checkpoint resumed on
    one rank bit for bit."""
    root, params, ranks, _ = two_ranks
    t0, t1 = (r["trainer"] for r in ranks)
    assert set(t0["files"]).isdisjoint(t1["files"])
    assert t0["losses"] == t1["losses"]
    assert len(t0["logs"]) == STEPS and t1["logs"] == []
    for t in (t0, t1):
        assert t["step"] == STEPS and state_equal(t["restored"], t["saved"])
    one = Trainer(port_model(params), trainer_config(root, "dp", 2),
                  log_fn=lambda s: None)
    assert one.restore_latest() == STEPS
    assert state_equal(one.state_dict(), t0["saved"])


def test_trainer_on_the_model_axis_checkpoints_the_whole_state(two_ranks):
    """The model=2 Trainer's checkpoint is the whole state: a one-rank
    Trainer resumes it bit for bit, and it is the one-process step's
    within the model axis' bar."""
    root, params, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    saved = ranks[0]["trainer_mp"]["saved"]
    assert state_equal(saved, ranks[1]["trainer_mp"]["saved"])
    one = Trainer(port_model(params), trainer_config(root, "mp", 1),
                  log_fn=lambda s: None)
    assert one.restore_latest() == 1
    assert state_equal(one.state_dict(), saved)
    ref = Trainer(port_model(params), trainer_config(root, "ref", 1),
                  log_fn=lambda s: None)
    ref.fit(iter([inputs["x"]]), num_steps=1)
    want = ref.state_dict()
    for name, w in want["params"].items():
        torch.testing.assert_close(saved["params"][name], w, atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(saved["ema"][name], want["ema"][name],
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(ranks[0]["trainer_mp"]["ema"][name],
                                   want["ema"][name], atol=1e-6, rtol=0)


def test_distiller_over_two_ranks_matches_one_process(two_ranks):
    root, params, ranks, _ = two_ranks
    inputs = torch.load(root / "inputs.pt", weights_only=False)
    model = port_model(params)
    m = ProgressiveDistiller(model, base_steps=4).stage(
        iter([inputs["x"]]), num_train_steps=1, log_fn=lambda s: None)
    for res in ranks:
        np.testing.assert_allclose(res["distill"], m["loss"].item(),
                                   rtol=2e-5)


def test_loss_draws_through_noise_py_are_bit_unchanged():
    """The loss's σ, noise and embedding-mask draws go through
    diffusion/noise.py; at one seed the loss is the one drawn with
    torch.rand/torch.randn directly, bit for bit."""
    from audio_diffusion_torch import DiffusionAR
    from audio_diffusion_torch.diffusion.vdiffusion import arv_loss, v_loss
    from audio_diffusion_torch.ops.unet import ClassifierFreeGuidanceWrapper

    cfg = dict(in_channels=1, channels=[8, 16], factors=[1, 2],
               items=[1, 1], modulation_features=32)
    model = DiffusionModel(net_t=UNetV0, device="cpu", **cfg)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1, 64).astype(
        np.float32))
    got = model.loss(model.params, torch.Generator().manual_seed(5), x)
    g = torch.Generator().manual_seed(5)
    sigmas = torch.rand((2,), generator=g, dtype=torch.float32)
    noise = torch.randn(x.shape, generator=g, dtype=x.dtype)
    assert torch.equal(got, v_loss(model.net, model.params, x, sigmas,
                                   noise))

    ar = DiffusionAR(net_t=UNetV0, length=64, num_splits=4, device="cpu",
                     **cfg)
    got = ar.loss(ar.params, torch.Generator().manual_seed(6), x)
    g = torch.Generator().manual_seed(6)
    sigmas = torch.rand((2, 1, 4), generator=g, dtype=x.dtype)
    noise = torch.randn(x.shape, generator=g, dtype=x.dtype)
    assert torch.equal(got, arv_loss(ar.net, ar.params, x, sigmas, noise))

    mask = ClassifierFreeGuidanceWrapper.draw_mask(
        5, 0.5, torch.Generator().manual_seed(8), "cpu")
    want = torch.rand((5, 1, 1), generator=torch.Generator().manual_seed(8)
                      ) < 0.5
    assert torch.equal(mask, want)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
