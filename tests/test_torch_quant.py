"""Int8/int4 weight-only quantization of the port (ops/quant.py) against the
JAX package's, on a 2-level net with self-attention (conv kernels and Dense
weights of every kind) with the same weights (``params_from_jax``).

Bars: the quantized dicts equal the JAX package's bit for bit (int8
values, float32 scales, the set of quantized names), in f32 and in bf16
after dequantization; ``unpack_int4_leaves`` is lossless; a quantized
4-step VSampler and DPMSampler sample in f32 against JAX's: max-abs < 1e-3
and MSE <= 1e-6 (ROADMAP's bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_diffusion_tpu import DiffusionModel as JaxDiffusionModel
from audio_diffusion_tpu import DPMSampler as JaxDPMSampler
from audio_diffusion_tpu import UNetV0 as JaxUNetV0
from audio_diffusion_tpu.ops import quant as jq
from audio_diffusion_torch import (DiffusionModel, DPMSampler, QTensor,
                                   SDESampler, UNetV0, VInpainter,
                                   cast_inference_params, dequantize_params,
                                   params_from_jax, params_to_jax,
                                   quantize_params, unpack_int4_leaves)
from audio_diffusion_torch.ops.quant import (dequantize_step_params,
                                             has_qtensors, quantize_leaf,
                                             storage_bytes)

torch.set_num_threads(2)

LENGTH = 256
STEPS = 4
MIN_SIZE = 256  # the tiny net has no leaf of the default 65,536 elements
CFG = dict(in_channels=2, channels=[8, 32], factors=[1, 4], items=[1, 1],
           attentions=[0, 1], attention_heads=4, attention_features=8,
           modulation_features=64)


def random_tree(net, seed):
    """A seeded random parameter tree of the JAX net's shape."""
    shapes = jax.eval_shape(lambda: net.module.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 2, LENGTH)),
        jnp.zeros((1,))))["params"]
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        a = rs.randn(*s.shape)
        if "freqs" in name:
            return (16.0 * a).astype(np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * a).astype(np.float32)
        fan_in = 3 * s.shape[1] if len(s.shape) == 3 else (
            s.shape[0] if len(s.shape) == 2 else 100)
        return (a / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pair():
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **CFG)
    tree = random_tree(jax_model.net, seed=0)
    return jax_model, tree


_JAX_QUANTIZED = {}


def jax_quantized(tree, bits):
    """The JAX package's quantized tree, made once per bit width. Eagerly,
    as its users call it: under ``jax.jit`` XLA turns the scale's division
    by 127 into a product with the reciprocal, which rounds otherwise."""
    if bits not in _JAX_QUANTIZED:
        _JAX_QUANTIZED[bits] = jq.quantize_params(tree, min_size=MIN_SIZE,
                                                  bits=bits)
    return _JAX_QUANTIZED[bits]


def assert_same_qtensor(got, want, name):
    assert isinstance(got, QTensor) and isinstance(want, QTensor), name
    assert got.bits == want.bits and got.orig_dtype == want.orig_dtype, name
    assert got.shape == want.shape and got.channel_axis == want.channel_axis
    assert got.q.dtype == torch.int8 and got.qscale.dtype == torch.float32
    assert torch.equal(got.q, want.q), name
    assert torch.equal(got.qscale, want.qscale), name


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_jax_bit_for_bit(pair, bits):
    _, tree = pair
    got = quantize_params(params_from_jax(tree), min_size=MIN_SIZE,
                          bits=bits)
    want = params_from_jax(jax_quantized(tree, bits))
    assert list(got) == list(want)
    quantized = {k for k, v in got.items() if isinstance(v, QTensor)}
    assert quantized == {k for k, v in want.items()
                         if isinstance(v, QTensor)}
    # Dense weights (transposed in the port) and conv kernels both appear.
    assert any(k.endswith(".weight") for k in quantized)
    assert any(k.endswith("conv1_kernel") for k in quantized)
    for name in got:
        if name in quantized:
            assert_same_qtensor(got[name], want[name], name)
        else:
            assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantized_leaves_match_jax(pair, bits):
    """f32 and bf16 dequantization equal the JAX package's bit for bit:
    the int8 values and the f32 scales are cast to the compute width and
    multiplied there in both."""
    _, tree = pair
    qtree = jax_quantized(tree, bits)
    q = params_from_jax(qtree)
    got = dequantize_params(q)
    want = params_from_jax(jq.dequantize_params(qtree))
    for name in got:
        assert torch.equal(got[name], want[name]), name
        assert got[name].is_contiguous(), name
    got16 = dequantize_params(q, torch.bfloat16)
    # Eagerly: under jit XLA on the CPU keeps the bf16 product in f32.
    want16 = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        jq.dequantize_params(qtree, jnp.bfloat16)))
    for name, v in q.items():
        if isinstance(v, QTensor):
            assert got16[name].dtype == torch.bfloat16
            assert torch.equal(got16[name].float(), want16[name]), name


def test_unpack_int4_leaves_is_lossless(pair):
    _, tree = pair
    q4 = quantize_params(params_from_jax(tree), min_size=MIN_SIZE, bits=4)
    q8 = unpack_int4_leaves(q4)
    want = params_from_jax(jax.jit(jq.unpack_int4_leaves)(
        jax_quantized(tree, 4)))
    for name, v in q4.items():
        if isinstance(v, QTensor):
            assert q8[name].bits == 8 and q8[name].shape == v.shape
            assert torch.equal(q8[name].qscale, v.qscale)
            assert_same_qtensor(q8[name], want[name], name)
            assert torch.equal(dequantize_params({"w": q8[name]})["w"],
                               dequantize_params({"w": v})["w"])
    assert storage_bytes(q4) < storage_bytes(q8)


def test_leaf_rules_and_guards():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((64, 129)).astype(np.float32))
    for axis in (-1, 0):
        qt = quantize_leaf(w, channel_axis=axis)
        back = dequantize_params({"w": qt})["w"]
        amax = w.abs().amax(dim=0 if axis == -1 else 1, keepdim=True)
        # Symmetric int8: per-channel error at most scale / 2 = amax / 254.
        assert ((back - w).abs() <= amax / 254 + 1e-7).all()
        odd = quantize_leaf(w, bits=4, channel_axis=axis)  # odd input rows
        assert odd.shape == (64, 129)
        assert dequantize_params({"w": odd})["w"].shape == (64, 129)
    zero = quantize_leaf(torch.zeros(16, 256))
    assert not zero.q.any() and not dequantize_params({"w": zero})["w"].any()
    tree = {"big": torch.ones(512, 256), "small": torch.ones(8, 8),
            "bias": torch.ones(2**20), "ints": torch.ones(512, 256,
                                                         dtype=torch.int32)}
    q = quantize_params(tree)
    assert [k for k, v in q.items() if isinstance(v, QTensor)] == ["big"]
    assert has_qtensors(q) and not has_qtensors(tree)
    assert dequantize_step_params(tree, torch.bfloat16) is tree
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        quantize_leaf(w, bits=3)
    with pytest.raises(ValueError, match="orig_shape"):
        QTensor(torch.zeros(2, 2, dtype=torch.int8), torch.ones(1, 2),
                bits=4)
    cast = cast_inference_params(q, torch.bfloat16)
    assert cast["big"] is q["big"] and cast["small"].dtype == torch.bfloat16


def test_convert_round_trip_with_qtensors(pair):
    _, tree = pair
    q = quantize_params(params_from_jax(tree), min_size=MIN_SIZE, bits=4)
    back = params_from_jax(params_to_jax(q))
    for name, v in q.items():
        if isinstance(v, QTensor):
            assert_same_qtensor(back[name], v, name)
        else:
            assert torch.equal(back[name], v), name
    # The JAX package's own QTensor class builds a tree that JAX runs.
    jtree = params_to_jax(q, qtensor=jq.QTensor)
    leaves = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(
        x, jq.QTensor))
    assert sum(isinstance(x, jq.QTensor) for x in leaves) == sum(
        isinstance(v, QTensor) for v in q.values())


@pytest.mark.parametrize("sampler", ["v", "dpm"])
def test_quantized_sample_matches_jax(pair, sampler):
    jax_model, tree = pair
    kw = {} if sampler == "v" else dict(sampler_t=DPMSampler)
    jkw = {} if sampler == "v" else dict(sampler_t=JaxDPMSampler)
    jax_model = JaxDiffusionModel(net_t=JaxUNetV0, **CFG, **jkw)
    model = DiffusionModel(net_t=UNetV0, device="cpu", **CFG, **kw)
    model.net.module.load_state_dict(params_from_jax(tree), strict=True)
    jqtree = jax_quantized(tree, 8)
    noise = np.random.RandomState(3).randn(1, 2, LENGTH).astype(np.float32)
    want = np.asarray(jax_model.sample(jnp.asarray(noise), num_steps=STEPS,
                                       params={"net": jqtree}))
    qparams = quantize_params(model.params, min_size=MIN_SIZE)
    got = model.sample(torch.from_numpy(noise), num_steps=STEPS,
                       params=qparams).numpy()
    err = np.abs(got - want).max()
    assert err < 1e-3 and np.mean((got - want) ** 2) <= 1e-6, err
    exact = model.sample(torch.from_numpy(noise), num_steps=STEPS).numpy()
    assert np.abs(got - exact).max() > 0  # the quantized weights were used
    # The master parameters are untouched.
    for name, p in model.params.items():
        assert torch.equal(p.detach(), params_from_jax(tree)[name]), name


def test_quantized_other_samplers_and_int4():
    """SDE, the inpainter and int4 leaves run on quantized dicts; a
    quantized sample is deterministic."""
    model = DiffusionModel(net_t=UNetV0, device="cpu", **CFG)
    noise = torch.randn(1, 2, LENGTH, generator=torch.Generator()
                        .manual_seed(0))
    for bits in (8, 4):
        q = quantize_params(model.params, min_size=MIN_SIZE, bits=bits)
        a = model.sample(noise, num_steps=3, params=q)
        assert torch.equal(a, model.sample(noise, num_steps=3, params=q))
        assert torch.isfinite(a).all()
    q = quantize_params(model.params, min_size=MIN_SIZE)
    out = SDESampler(model.net, eta=0.5).sample(
        q, torch.Generator().manual_seed(1), noise, 3)
    assert torch.isfinite(out).all()
    mask = torch.ones(1, 2, LENGTH, dtype=torch.bool)
    mask[..., 64:128] = False
    with torch.inference_mode():
        out = VInpainter(model.net).sample(
            q, torch.Generator().manual_seed(2), noise, mask, 2, 2)
    assert torch.isfinite(out).all()
