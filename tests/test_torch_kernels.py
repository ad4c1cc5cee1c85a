"""The port's fused resnet item (audio_diffusion_torch/ops/kernels/resnet.py)
against the JAX package's: its plain version vs the JAX lax reference and
the Pallas kernel in interpret mode, at fold 1, on the same numpy inputs.

Tolerances. float32: atol = rtol = 2e-4, the bar of tests/test_kernels.py
(measured: ≤ 4.3e-6). bfloat16: the port's plain version rounds where the
Pallas body rounds, so against the interpret-mode kernel it may differ by
one bf16 ulp of the output (measured 0.0156 at max|y| = 10.4); the JAX
lax reference rounds conv 1 before its bias and keeps the residual sum in
f32, so against it the bound is two ulps (measured 0.0625 at max|y| = 10.4).
An ulp is taken at the largest output: 2^-7·max|y|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu.ops.kernels.resnet import (
    fused_resnet_item as jax_fused_resnet_item, group_map,
    resnet_item_reference as jax_resnet_item_reference)
from audio_diffusion_torch.ops.kernels.resnet import (
    _backward_scratch, conv_plan, fused_resnet_item, resnet_item_reference,
    wgrad_plan)

torch.set_num_threads(2)

NAMES = ("x", "gn1s", "gn1b", "k1", "c1b", "gn2s", "gn2b", "k2", "c2b",
         "mods", "modb", "mgs", "mgb")
GROUPS = 8
LENGTH = 256


def make_inputs(c: int, length: int = LENGTH, b: int = 2, seed: int = 0):
    rs = np.random.default_rng(seed)

    def f(*shape, scale=1.0, offset=0.0):
        return (rs.standard_normal(shape) * scale + offset).astype(np.float32)

    w = 1.0 / np.sqrt(3 * c)
    return dict(x=f(b, length, c), gn1s=f(c, scale=.1, offset=1.),
                gn1b=f(c, scale=.1), k1=f(3, c, c, scale=w), c1b=f(c, scale=.1),
                gn2s=f(c, scale=.1, offset=1.), gn2b=f(c, scale=.1),
                k2=f(3, c, c, scale=w), c2b=f(c, scale=.1),
                mods=f(b, c, scale=.2), modb=f(b, c, scale=.2),
                mgs=f(c, scale=.1, offset=1.), mgb=f(c, scale=.1))


def jax_outputs(a, dtype, use_modulation):
    """(lax reference, interpret-mode Pallas kernel) at fold 1, as f32 numpy."""
    j = {k: jnp.asarray(v, dtype) for k, v in a.items()}
    c = a["x"].shape[-1]
    m = jnp.asarray(group_map(1, c, GROUPS))
    vec = lambda k: j[k][None]  # noqa: E731  [C] -> [1, W]
    ref = jax_resnet_item_reference(
        j["x"], vec("gn1s"), vec("gn1b"), j["k1"], vec("c1b"), vec("gn2s"),
        vec("gn2b"), j["k2"], vec("c2b"), m, j["mods"], j["modb"],
        vec("mgs"), vec("mgb"), use_modulation=use_modulation)
    fused = jax_fused_resnet_item(
        j["x"], vec("gn1s"), vec("gn1b"), j["k1"], vec("c1b"), vec("gn2s"),
        vec("gn2b"), j["k2"], vec("c2b"), m, m.T, j["mods"], j["modb"],
        vec("mgs"), vec("mgb"), 1e-5, use_modulation, True)
    return (np.asarray(ref.astype(jnp.float32)),
            np.asarray(fused.astype(jnp.float32)))


def torch_inputs(a, dtype, device="cpu"):
    # Through f32 so both sides see the same bf16 values.
    return [torch.from_numpy(a[k]).to(device=device, dtype=dtype)
            for k in NAMES]


@pytest.mark.parametrize("use_modulation", [True, False])
@pytest.mark.parametrize("channels", [8, 32, 64])
def test_plain_item_matches_jax_f32(channels, use_modulation):
    a = make_inputs(channels, seed=channels)
    ref, fused = jax_outputs(a, jnp.float32, use_modulation)
    out = resnet_item_reference(*torch_inputs(a, torch.float32),
                                groups=GROUPS,
                                use_modulation=use_modulation).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(out, fused, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("use_modulation", [True, False])
@pytest.mark.parametrize("channels", [8, 64])
def test_plain_item_matches_jax_bf16(channels, use_modulation):
    a = make_inputs(channels, seed=channels)
    # Round the inputs to bf16 once, so both packages start from the same.
    a = {k: np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
         for k, v in a.items()}
    ref, fused = jax_outputs(a, jnp.bfloat16, use_modulation)
    out = resnet_item_reference(*torch_inputs(a, torch.bfloat16),
                                groups=GROUPS,
                                use_modulation=use_modulation)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    ulp = 2.0 ** -7 * np.abs(fused).max()
    assert np.abs(out - fused).max() <= ulp
    assert np.abs(out - ref).max() <= 2 * ulp


def test_wrapper_takes_plain_path_on_cpu():
    a = make_inputs(32, length=64, seed=1)
    args = torch_inputs(a, torch.float32)
    before = fused_resnet_item.launches
    out = fused_resnet_item(*args, groups=GROUPS)
    assert fused_resnet_item.launches == before  # no kernel launched
    assert torch.equal(out, resnet_item_reference(*args, groups=GROUPS))
    # Without modulation the modulation inputs may be omitted.
    out = fused_resnet_item(*args[:9], groups=GROUPS, use_modulation=False)
    assert torch.equal(out, resnet_item_reference(
        *args[:9], groups=GROUPS, use_modulation=False))


LEVELS = [(8, 2**18), (32, 2**16), (64, 2**14), (128, 2**12), (256, 2**11),
          (512, 2**10), (512, 2**9), (1024, 2**8), (1024, 2**7)]


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("channels,length", LEVELS)
def test_conv_plan_at_flagship_levels(channels, length, batch):
    """The bf16 forward conv's tile and split-K (conv_plan) at the flagship's
    nine level shapes, at batch 1 (sampling), 2 (the guided pass's
    [cond; fixed]) and 8 (training): the splits cover K = 3·C exactly, without overlap;
    the tile is a wgmma width that covers C; the workspace stays within its
    cap; the grid fills a wave of 132 SMs (at most 4 of them idle) wherever
    one row of 64 per CTA and one K chunk per split could, and a split grid
    stays within two waves."""
    p = conv_plan(batch, length, channels)
    assert p["bn"] % 8 == 0 and 8 <= p["bn"] <= 256
    assert channels % p["bn"] == 0 or p["bn"] >= channels
    assert p["bk"] % 16 == 0 and p["chunks"] * p["bk"] >= channels
    assert (p["chunks"] - 1) * p["bk"] < channels
    # Split s takes chunks [s·cps, min((s+1)·cps, chunks)), all three taps.
    covered = [k for s in range(p["splits"])
               for k in range(s * p["cps"], min((s + 1) * p["cps"],
                                                 p["chunks"]))]
    assert covered == list(range(p["chunks"]))  # each once, none empty
    assert (p["splits"] - 1) * p["cps"] < p["chunks"]
    taps = sorted((t, c) for k in covered for t in range(3)
                  for c in range(k * p["bk"], min((k + 1) * p["bk"],
                                                  channels)))
    assert taps == [(t, c) for t in range(3) for c in range(channels)]
    tiles = batch * -(-length // (64 * p["mt"])) * -(-channels // p["bn"])
    assert p["ctas"] == tiles * p["splits"]
    assert p["workspace_bytes"] <= 16 * 2**20
    assert p["workspace_bytes"] == (
        4 * batch * length * channels * p["splits"] if p["splits"] > 1 else 0)
    # A wave is one CTA per SM, two where a tile leaves room for two; with
    # whole splits the grid may stop one tile-row's worth short of it.
    wave = 132 * p["resident"]
    most = batch * -(-length // 64) * -(-channels // p["bn"]) * p["chunks"]
    if most >= wave:
        assert p["ctas"] >= 0.95 * wave
    assert p["ctas"] <= 2 * wave or p["splits"] == 1


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("channels,length", LEVELS)
def test_wgrad_plan_at_flagship_levels(channels, length, batch):
    """The bf16 weight gradient's tile and slabs (wgrad_plan) at the
    flagship's nine level shapes: every chunk of positions is in exactly one
    slab; the tile covers C (the narrow tile is exactly C wide at C = 8 and
    32, the wgmma tiles 64 input channels by 64 or 128 output ones, the
    latter over 128-position chunks); the f32 partials stay within 16 MiB;
    and no slab count within that cap takes fewer chunk-times, a CTA's
    chunks times the waves its grid needs of the CTAs an H100 holds (five
    per SM of the C = 8 tile, as the occupancy API reports, two of the
    C = 32 and 64 tiles, one of the 64 x 128 tile), so that a grid never
    spills a few CTAs into a second wave (at level 1, batch 8: 256 slabs of
    32 chunks, not 265 of 31)."""
    p = wgrad_plan(batch, length, channels)
    chunks = batch * -(-length // p["chunk"])
    assert p["chunks"] == chunks
    covered = [q for z in range(p["slabs"])
               for q in range(z * p["cps"], min((z + 1) * p["cps"], chunks))]
    assert covered == list(range(chunks))
    assert (p["slabs"] - 1) * p["cps"] < chunks
    if channels <= 32:
        assert p["tile"] == channels and p["chunk"] == (256 if channels == 8
                                                        else 64)
        tiles = 1
    else:
        assert p["tile"] in (64, 128)
        assert p["chunk"] == (128 if p["tile"] == 128 else 64)
        assert p["tile"] >= channels or channels % p["tile"] == 0
        tiles = -(-channels // 64) * -(-channels // p["tile"])
    assert p["resident"] == {8: 5, 32: 2, 64: 2, 128: 1}[p["tile"]]
    assert p["ctas"] == tiles * p["slabs"]
    slab_bytes = 12 * channels * channels
    assert p["partial_bytes"] == (slab_bytes * p["slabs"]
                                  if p["slabs"] > 1 else 0)
    assert p["partial_bytes"] <= 16 * 2**20
    wave = 132 * p["resident"]

    def chunk_times(slabs):
        return -(-tiles * slabs // wave) * -(-chunks // slabs)

    fits = [n for n in range(1, chunks + 1)
            if n == 1 or n * slab_bytes <= 16 * 2**20]
    assert chunk_times(p["slabs"]) == min(map(chunk_times, fits))
    if (channels, batch) == (32, 8):
        assert (p["slabs"], p["cps"]) == (256, 32)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("channels,length", LEVELS)
def test_backward_scratch_at_flagship_levels(channels, length, batch):
    """The bf16 backward's one f32 scratch buffer at the nine level shapes,
    at batch 1 and the train step's batch 8: its regions (dn, the GroupNorm
    backward's partials, column sums and means, the weight gradient's slab
    partials, the data gradient's split-K partials) are disjoint, each on a
    256-byte boundary and as large as its kernel writes; the data
    gradient's plan is the forward conv's, and its split-K partials stay
    within conv_plan's 16 MiB cap."""
    wplan, dplan, offsets, size = _backward_scratch(batch, length, channels,
                                                    8, bf16=True)
    assert dplan == conv_plan(batch, length, channels)
    assert dplan["workspace_bytes"] <= 16 * 2**20
    n_tiles = -(-length // max(1, 8192 // channels))
    need = dict(dn=batch * length * channels,
                red_partial=batch * n_tiles * channels * 3,
                col=batch * channels * 3, means=batch * 8 * 2,
                wpartial=(wplan["slabs"] * 3 * channels**2
                          if wplan["slabs"] > 1 else 0),
                dgrad_ws=(dplan["splits"] * batch * length * channels
                          if dplan["splits"] > 1 else 0))
    assert list(offsets) == list(need)
    spans = sorted((offsets[k], offsets[k] + need[k]) for k in need)
    assert all(o % 64 == 0 for o in offsets.values())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= size
