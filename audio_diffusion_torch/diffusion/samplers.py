"""Samplers (counterpart of audio_diffusion_tpu/diffusion/samplers.py).

The JAX package compiles the step loop into one ``lax.scan``; here it is a
Python loop that launches each step's work on the device without waiting
for it. A sampler with ``needs_key`` draws noise: it takes a
``torch.Generator`` (on the device of its tensors) after the parameters,
where the JAX sampler takes a key, and every draw goes through
:func:`noise.normal`.

A parameter dict may hold quantized leaves (``ops/quant.py``): each step
then runs on the dict dequantized to the net's compute dtype
(:func:`run_steps`), as the JAX samplers dequantize inside their scan.

``VSampler`` and ``DPMSampler`` are also written as steps, which
``export.py`` traces one at a time: ``coefficients(num_steps, device)``
gives the per-step f32 table, ``start(x_noisy)`` the carry (``x_noisy``
and zero tensors of its shape), and ``step(net, carry, row, **kwargs)``
one step on row i of the table (with ``return_hidden=True`` it also
returns the net's encoder state, and ``hidden=`` decodes one: the two step
forms of encoder reuse). ``sample`` runs those same steps, so an exported
sampler gives ``sample``'s bits.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from ..ops.net import Net, cast_inference_params
from ..ops.quant import dequantize_step_params, has_qtensors
from ..spans import span
from . import noise
from .core import alpha_beta, linspace
from .schedules import LinearSchedule, Schedule, UniformLambdaSchedule

__all__ = ["Sampler", "VSampler", "SDESampler", "DPMSampler", "ARVSampler",
           "run_steps"]


def run_steps(net: Net, params: Dict, loop: Callable):
    """``loop(step_net)``, where ``step_net()`` gives the net to call in the
    step that asks (call it once per step). A plain dict is swapped into the
    module once for the whole loop (``Net.run``); a dict holding QTensors is
    dequantized to the net's compute dtype at each ``step_net()``, so a
    step streams the quantized weights (a dict without QTensors runs
    exactly as before)."""
    if not has_qtensors(params):
        return net.run(params, lambda module: loop(lambda: module))

    def step_net():
        return functools.partial(
            net.apply, dequantize_step_params(params, net.compute_dtype))

    return loop(step_net)


class Sampler:
    """Interface for samplers."""

    net: Net
    # True when sample() draws noise: its second positional argument is a
    # torch.Generator, which DiffusionModel.sample passes.
    needs_key: bool = False

    def sample(self, params: Dict[str, Tensor], *args, **kwargs) -> Tensor:
        raise NotImplementedError()

    def __call__(self, params: Dict[str, Tensor], *args, **kwargs) -> Tensor:
        return self.sample(params, *args, **kwargs)


def _check_reuse(num_steps: int, k: int) -> None:
    if k > 1 and num_steps % k:
        raise ValueError(
            f"num_steps ({num_steps}) must be divisible by encoder_reuse "
            f"({k}): the encoder runs once per chunk of k steps")


def _net_v(net, x: Tensor, row: Dict[str, Tensor], kwargs: Dict):
    """(the net's v at this row's σ, in x's dtype; its encoder state, or
    None unless ``kwargs`` hold ``return_hidden=True``)."""
    out = net(x, row["sigma"].expand(x.shape[0]).to(x.dtype), **kwargs)
    return out if kwargs.get("return_hidden") else (out, None)


def _stepped(carry: Tuple[Tensor, ...], enc, kwargs: Dict):
    """A step's result: (carry, encoder state) where the step was asked for
    the state, else the carry."""
    return (carry, enc) if kwargs.get("return_hidden") else carry


def reuse_kwargs(i: int, k: int, enc) -> Dict:
    """The extra step kwargs of step ``i`` under ``encoder_reuse=k``: none
    when k <= 1; on the first step of each chunk of k, ``return_hidden``;
    on the others, the chunk's encoder state ``enc``."""
    if k <= 1:
        return {}
    return {"return_hidden": True} if i % k == 0 else {"hidden": enc}


def _step_loop(sampler, params: Dict[str, Tensor], x_noisy: Tensor,
               num_steps: int, encoder_reuse: int, show_progress: bool,
               kwargs: Dict) -> Tensor:
    """The loop of a sampler written as steps (``coefficients``, ``start``,
    ``step``), with encoder reuse in chunks of ``encoder_reuse`` steps."""
    k = int(encoder_reuse)
    _check_reuse(num_steps, k)
    params = cast_inference_params(params, sampler.net.compute_dtype)
    # σ/α/β stay f32 under a bf16 carry; only the carry is in x's dtype.
    table = sampler.coefficients(num_steps, x_noisy.device)

    def loop(step_net):
        carry, enc = sampler.start(x_noisy), None
        for i in range(num_steps):
            with span("sampler.step"):
                row = {name: t[i] for name, t in table.items()}
                extra = reuse_kwargs(i, k, enc)
                carry = sampler.step(step_net(), carry, row, **extra,
                                     **kwargs)
                if "return_hidden" in extra:
                    carry, enc = carry
                if show_progress:
                    print(f"Sampling (noise={float(row['sigma']):.2f})")
        return carry[0]

    return run_steps(sampler.net, params, loop)


class VSampler(Sampler):
    """Deterministic angular-DDIM v-sampler. Per step::

        v      = net(x, σ_i)
        x_pred = α_i·x − β_i·v        (denoised estimate)
        n_pred = β_i·x + α_i·v        (noise estimate)
        x      = α_{i+1}·x_pred + β_{i+1}·n_pred
    """

    def __init__(self, net: Net, schedule: Optional[Schedule] = None):
        self.net = net
        self.schedule = schedule or LinearSchedule()

    def coefficients(self, num_steps: int, device=None) -> Dict[str, Tensor]:
        """The per-step f32 table on ``device``: σ_i, α_i, β_i, α_{i+1} and
        β_{i+1} (α and β computed there, from the schedule's σ)."""
        sigmas = self.schedule(num_steps + 1).to(torch.float32).to(device)
        alphas, betas = alpha_beta(sigmas)
        return dict(sigma=sigmas[:-1], alpha=alphas[:-1], beta=betas[:-1],
                    alpha_next=alphas[1:], beta_next=betas[1:])

    @staticmethod
    def start(x_noisy: Tensor) -> Tuple[Tensor, ...]:
        return (x_noisy,)

    @staticmethod
    def update(x: Tensor, v: Tensor, row: Dict[str, Tensor]) -> Tensor:
        """x_{i+1} from x_i and the net's v, in f32, cast to x's dtype."""
        xf, vf = x.float(), v.float()
        x_pred = row["alpha"] * xf - row["beta"] * vf
        noise_pred = row["beta"] * xf + row["alpha"] * vf
        return (row["alpha_next"] * x_pred
                + row["beta_next"] * noise_pred).to(x.dtype)

    def step(self, net, carry: Tuple[Tensor, ...], row: Dict[str, Tensor],
             **kwargs):
        """One step from ``carry`` on this step's row of the table; the net
        sees σ in the carry dtype. With ``return_hidden=True`` it returns
        (carry, the net's encoder state); ``hidden=`` decodes such a state
        (encoder reuse)."""
        (x,) = carry
        v, enc = _net_v(net, x, row, kwargs)
        return _stepped((self.update(x, v, row),), enc, kwargs)

    def sample(self, params: Dict[str, Tensor], x_noisy: Tensor,
               num_steps: int, show_progress: bool = False, unroll: int = 1,
               encoder_reuse: int = 1, **kwargs) -> Tensor:
        """``unroll`` is the JAX sampler's scan unrolling, accepted and
        ignored: a Python loop has no scan to unroll.

        ``encoder_reuse=k`` (k > 1) runs the net's down path (encoder) only
        on the first step of each chunk of k steps (``return_hidden=True``)
        and decodes the k − 1 steps after it from that encoder state with
        the current σ (``hidden=``). Approximate; k = 1 is the exact
        sampler. ``num_steps`` must be a multiple of k."""
        return _step_loop(self, params, x_noisy, num_steps, encoder_reuse,
                          show_progress, kwargs)


class SDESampler(Sampler):
    """Stochastic (ancestral) variant of the angular v-sampler. Per step the
    predicted noise is mixed with fresh Gaussian noise ε (in the carry
    dtype, one draw per step)::

        n_mix = sqrt(1 − eta²)·n_pred + eta·ε
        x     = α_{i+1}·x_pred + β_{i+1}·n_mix

    ``eta=0`` gives :class:`VSampler`'s output bit for bit; ``eta=1``
    redraws the whole noise each step."""

    needs_key = True

    def __init__(self, net: Net, schedule: Optional[Schedule] = None,
                 eta: float = 1.0):
        if not 0.0 <= eta <= 1.0:
            raise ValueError(f"eta must be in [0, 1], got {eta}")
        self.net = net
        self.schedule = schedule or LinearSchedule()
        self.eta = eta

    def sample(self, params: Dict[str, Tensor], generator: torch.Generator,
               x_noisy: Tensor, num_steps: int, show_progress: bool = False,
               unroll: int = 1, **kwargs) -> Tensor:
        """``unroll`` is accepted and ignored, as in :class:`VSampler`."""
        b = x_noisy.shape[0]
        params = cast_inference_params(params, self.net.compute_dtype)
        sigmas_host = self.schedule(num_steps + 1).to(torch.float32)
        sigmas = sigmas_host.to(x_noisy.device)
        alphas, betas = alpha_beta(sigmas)
        mix_fresh = torch.tensor(self.eta, dtype=torch.float32)
        mix_pred = torch.sqrt(torch.clamp(1.0 - mix_fresh ** 2, min=0.0))
        mix_fresh, mix_pred = (t.to(x_noisy.device)
                               for t in (mix_fresh, mix_pred))

        def loop(step_net):
            x = x_noisy
            for i in range(num_steps):
                with span("sampler.step"):
                    v = step_net()(x, sigmas[i].expand(b).to(x.dtype),
                                   **kwargs)
                    xf, vf = x.float(), v.float()
                    x_pred = alphas[i] * xf - betas[i] * vf
                    noise_pred = betas[i] * xf + alphas[i] * vf
                    # β_{i+1} = 0 on the last step of a schedule ending at
                    # σ = 0, so no fresh noise reaches the clean output.
                    eps = noise.normal(generator, x.shape, x.dtype, x.device)
                    n_mix = mix_pred * noise_pred + mix_fresh * eps.float()
                    x = (alphas[i + 1] * x_pred
                         + betas[i + 1] * n_mix).to(x.dtype)
                    if show_progress:
                        print(f"Sampling "
                              f"(noise={float(sigmas_host[i]):.2f})")
            return x

        return run_steps(self.net, params, loop)


class DPMSampler(Sampler):
    """DPM-Solver++(2M) for the trigonometric v-parameterization, a
    second-order multistep solver of the same probability-flow ODE as
    :class:`VSampler` (data-prediction form; α = cos, β = sin of the
    schedule, λ = log(α/β), h_i = λ_{i+1} − λ_i, r = h_{i−1}/h_i)::

        x0_i    = α_i·x − β_i·v(x, σ_i)
        D_i     = x0_i + (x0_i − x0_{i−1}) / (2r)        (D_0 = x0_0)
        x_{i+1} = (β_{i+1}/β_i)·x + α_{i+1}·(1 − e^{−h_i})·D_i

    Deterministic. Default schedule: :class:`UniformLambdaSchedule` (steps
    uniform in log-SNR). The coefficients are f32; the carry and the
    previous x0 are stored in the carry dtype."""

    # α and β are floored here inside λ, so σ ∈ {0, 1} (λ = ±∞) stays
    # finite and e^{−h} underflows to the right limit.
    _EPS = 1e-7

    def __init__(self, net: Net, schedule: Optional[Schedule] = None):
        self.net = net
        self.schedule = schedule or UniformLambdaSchedule()

    def coefficients(self, num_steps: int, device=None) -> Dict[str, Tensor]:
        """The per-step f32 coefficients, computed on the host and moved to
        ``device``: σ_i, α_i, β_i, the second-order weight 1/(2r) (0 on the
        first step, which is first order: its previous x0 is zeros), the
        ratio β_{i+1}/β_i and α_{i+1}·(1 − e^{−h_i})."""
        sigmas = self.schedule(num_steps + 1).to(torch.float32)
        alphas, betas = alpha_beta(sigmas)
        eps = torch.tensor(self._EPS, dtype=torch.float32)
        lam = torch.log(torch.maximum(alphas, eps) / torch.maximum(betas, eps))
        hs = lam[1:] - lam[:-1]
        r = hs[:-1] / hs[1:]
        second = torch.cat([torch.zeros_like(hs[:1]), 1.0 / (2.0 * r)])
        table = dict(sigma=sigmas[:-1], alpha=alphas[:-1], beta=betas[:-1],
                     second=second,
                     ratio=betas[1:] / torch.maximum(betas[:-1], eps),
                     decay=alphas[1:] * (1.0 - torch.exp(-hs)))
        return {name: t.to(device) for name, t in table.items()}

    @staticmethod
    def start(x_noisy: Tensor) -> Tuple[Tensor, ...]:
        """(x, the previous x0): zeros before the first step."""
        return (x_noisy, torch.zeros_like(x_noisy))

    @staticmethod
    def update(x: Tensor, x0_prev: Tensor, v: Tensor,
               row: Dict[str, Tensor]) -> Tuple[Tensor, Tensor]:
        """(x_{i+1}, x0_i in the carry dtype). On the first step the weight
        is 0 and the previous x0 zeros, so D_0 = x0_0 exactly."""
        xf = x.float()
        x0 = row["alpha"] * xf - row["beta"] * v.float()
        d = x0 + row["second"] * (x0 - x0_prev.float())
        return ((row["ratio"] * xf + row["decay"] * d).to(x.dtype),
                x0.to(x.dtype))

    def step(self, net, carry: Tuple[Tensor, ...], row: Dict[str, Tensor],
             **kwargs):
        """As :meth:`VSampler.step`; the previous x0 rides in the carry."""
        x, x0_prev = carry
        v, enc = _net_v(net, x, row, kwargs)
        return _stepped(self.update(x, x0_prev, v, row), enc, kwargs)

    def sample(self, params: Dict[str, Tensor], x_noisy: Tensor,
               num_steps: int, show_progress: bool = False, unroll: int = 1,
               encoder_reuse: int = 1, **kwargs) -> Tensor:
        """``encoder_reuse=k`` works as in :class:`VSampler`; the previous
        x0 is carried through the decoder-only steps. ``unroll`` is accepted
        and ignored."""
        return _step_loop(self, params, x_noisy, num_steps, encoder_reuse,
                          show_progress, kwargs)


class ARVSampler(Sampler):
    """Autoregressive chunked sampler with a σ-ladder over the window tail.
    σ rides as an input channel at every step; the net takes no σ
    embedding. The carry stays float32 whatever the net's compute dtype."""

    needs_key = True

    def __init__(self, net: Net, in_channels: int, length: int,
                 num_splits: int):
        if length % num_splits:
            raise ValueError("length must be divisible by num_splits")
        if num_splits % 2:
            raise ValueError(
                "num_splits must be even: the σ ladder keeps the first half "
                "of the splits as clean context")
        self.net = net
        self.in_channels = in_channels
        self.length = length
        self.num_splits = num_splits
        self.split_length = length // num_splits

    def get_sigmas_ladder(self, num_items: int, num_steps_per_split: int,
                          device=None) -> Tensor:
        """[i + 1, b, 1, length] f32, i = ``num_steps_per_split``: a
        staircase of σ over the last half of the splits (lowest noise
        first), the first half at σ = 0 (clean context), and a last row
        that loops the first one back by one split."""
        b, n, l = num_items, self.num_splits, self.split_length
        i, n_half = num_steps_per_split, self.num_splits // 2
        sigmas = linspace(1.0, 0.0, i * n_half, device=device)
        # out[step, b, 1, split·l + t] = sigmas[split·i + step]
        sigmas = sigmas.reshape(n_half, i).T.repeat_interleave(l, dim=-1)
        sigmas = sigmas[:, None, None, :].expand(i, b, 1, n_half * l)
        sigmas = torch.flip(sigmas, dims=[-1])
        looped = torch.cat([torch.zeros_like(sigmas[0, :, :, :l]),
                            sigmas[0, :, :, :-l]], dim=-1)
        sigmas = torch.cat([sigmas, looped[None]], dim=0)
        return torch.cat([torch.zeros_like(sigmas), sigmas], dim=-1)

    def sample_loop(self, params: Dict[str, Tensor], current: Tensor,
                    sigmas: Tensor, show_progress: bool = False,
                    unroll: int = 1, **kwargs) -> Tensor:
        """Denoise ``current`` along a per-position σ trajectory
        [steps + 1, b, 1, t]: σ, in the carry's dtype, is appended as a
        channel at each step."""
        params = cast_inference_params(params, self.net.compute_dtype)
        alphas, betas = alpha_beta(sigmas)

        def loop(step_net):
            x = current
            for i in range(sigmas.shape[0] - 1):
                with span("sampler.step"):
                    channels = torch.cat([x, sigmas[i].to(x.dtype)], dim=1)
                    v = step_net()(channels, None, **kwargs)
                    x_pred = alphas[i] * x - betas[i] * v
                    noise_pred = betas[i] * x + alphas[i] * v
                    x = alphas[i + 1] * x_pred + betas[i + 1] * noise_pred
                    if show_progress:
                        print(f"Sampling (noise="
                              f"{float(sigmas[i, 0, 0, -1]):.2f})")
            return x

        return run_steps(self.net, params, loop)

    def sample_start(self, params: Dict[str, Tensor],
                     generator: torch.Generator, num_items: int,
                     num_steps: int, **kwargs) -> Tensor:
        """Denoise the whole first window on a shared 1 → 0 schedule from
        f32 noise, on the generator's device."""
        b, c, t = num_items, self.in_channels, self.length
        device = generator.device
        sigmas = linspace(1.0, 0.0, num_steps + 1, device=device)
        sigmas = sigmas[:, None, None, None].expand(num_steps + 1, b, 1, t)
        start = noise.normal(generator, (b, c, t), torch.float32, device)
        return self.sample_loop(params, start * sigmas[0], sigmas, **kwargs)

    def sample(self, params: Dict[str, Tensor], generator: torch.Generator,
               num_items: int, num_chunks: int, num_steps: int,
               start: Optional[Tensor] = None, show_progress: bool = False,
               **kwargs) -> Tensor:
        """``num_chunks`` splits [b, c, num_chunks · split_length],
        generated autoregressively: the first window, then one split per
        shift of a rolling window along the σ ladder. ``start`` is accepted
        and ignored, as in the JAX package (and its reference). Draws, in
        order: the start noise, the ladder's entry noise, one fresh split
        per shift."""
        n, l, b = self.num_splits, self.split_length, num_items
        if num_chunks < n:
            raise ValueError(f"required at least {n} chunks")
        if num_chunks > n and num_steps < n:
            raise ValueError("num_steps must be at least num_splits")
        params = cast_inference_params(params, self.net.compute_dtype)
        device = generator.device
        window = self.sample_start(params, generator, num_items=b,
                                   num_steps=num_steps,
                                   show_progress=show_progress, **kwargs)
        if num_chunks == n:
            return window
        sigmas = self.get_sigmas_ladder(b, num_steps // n, device=device)
        alphas, betas = alpha_beta(sigmas[0])
        window = alphas * window + betas * noise.normal(
            generator, window.shape, window.dtype, device)
        chunks = []
        for _ in range(num_chunks):
            updated = self.sample_loop(params, window, sigmas,
                                       show_progress=show_progress, **kwargs)
            chunks.append(updated[..., :l])
            fresh = noise.normal(generator, (b, self.in_channels, l),
                                 updated.dtype, device)
            window = torch.cat([updated[..., l:], fresh], dim=-1)
        return torch.cat(chunks, dim=-1)
