"""The attention item's kernel wrappers (``ops/kernels/attention.py``) on
the CPU: each runs its plain version there, which is the attention item's
former PyTorch code bit for bit; the routes between kernel path and plain
form follow grad mode, head width and dtype; the wrappers' shape checks and
the core's operator fake. The core's kernel and the library's LayerNorm run
in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from audio_diffusion_torch.ops import layers
from audio_diffusion_torch.ops.attention import (AttentionItem,
                                                 CrossAttentionItem)
from audio_diffusion_torch.ops.kernels import attention as kernels


def _tensor(rs, *shape, dtype=torch.float32, scale=1.0, offset=0.0):
    a = (rs.standard_normal(shape) * scale + offset).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _old_layer_norm(x, scale, bias, eps, dtype):
    """LayerNorm.forward as the port wrote it before the kernel path."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp(xf.square().mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(dtype or torch.promote_types(x.dtype, scale.dtype))


def _old_attention(q, k, v, heads):
    """Attention.forward's core as the port wrote it before the kernel
    path: split, _dot_product_attention, merge."""
    def split(t):
        b, s, _ = t.shape
        return t.reshape(b, s, heads, t.shape[-1] // heads).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    scale = qh.shape[-1] ** -0.5
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    out = torch.matmul(probs, vh)
    b, s, _ = q.shape
    return out.transpose(1, 2).reshape(b, s, q.shape[-1])


@pytest.mark.parametrize("x_dtype,param_dtype,dtype", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32, None),
    (torch.float32, torch.float32, None),
])
@pytest.mark.parametrize("grad", [False, True])
def test_layer_norm_cpu_is_the_former_code(x_dtype, param_dtype, dtype, grad):
    rs = np.random.default_rng(0)
    ln = layers.LayerNorm(48, dtype=dtype, param_dtype=param_dtype)
    with torch.no_grad():
        ln.scale.copy_(_tensor(rs, 48, scale=0.2, offset=1.0))
        ln.bias.copy_(_tensor(rs, 48, scale=0.2))
    x = _tensor(rs, 2, 37, 48, dtype=x_dtype, scale=3.0, offset=0.5)
    want = _old_layer_norm(x, ln.scale.detach(), ln.bias.detach(), 1e-6, dtype)
    with torch.set_grad_enabled(grad):
        got = ln(x)
        direct = kernels.layer_norm(x, ln.scale, ln.bias, 1e-6, want.dtype)
    assert got.dtype == want.dtype and torch.equal(got.detach(), want)
    assert torch.equal(direct.detach(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_core_cpu_is_the_former_code(dtype, cross):
    rs = np.random.default_rng(1)
    heads, d = 2, 16
    if cross:
        q = _tensor(rs, 2, 40, heads * d, dtype=dtype)
        k, v = (_tensor(rs, 2, 7, heads * d, dtype=dtype) for _ in range(2))
    else:
        q, k, v = _tensor(rs, 2, 40, 3 * heads * d, dtype=dtype).chunk(3, -1)
    want = _old_attention(q, k, v, heads)
    got = kernels.attention_core(q, k, v, heads)
    assert got.shape == (2, 40, heads * d) and torch.equal(got, want)


@pytest.mark.parametrize("cross", [False, True])
def test_attention_item_cpu_bits_unchanged(cross):
    """A whole item under inference_mode equals the same item under
    autograd (the plain route) bit for bit on the CPU."""
    rs = np.random.default_rng(2)
    common = dict(dtype=torch.bfloat16)
    item = (CrossAttentionItem(32, 12, 2, 16, **common) if cross
            else AttentionItem(32, 2, 16, **common))
    with torch.no_grad():
        for p in item.parameters():
            p.copy_(_tensor(rs, *p.shape, scale=0.2,
                            offset=float(p.dim() == 1)))
    x = _tensor(rs, 2, 24, 32, dtype=torch.bfloat16)
    args = (x, _tensor(rs, 2, 5, 12)) if cross else (x,)
    with torch.inference_mode():
        fast = item(*args)
    slow = item(*args)
    assert slow.requires_grad
    assert torch.equal(fast, slow.detach())


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("dtype,head_features,mode,core,norms", [
    (torch.bfloat16, 16, "inference", 1, 2),
    (torch.bfloat16, 64, "no_grad", 1, 2),
    (torch.bfloat16, 16, "frozen", 1, 2),      # grad on, nothing requires it
    (torch.bfloat16, 16, "grad", 0, 0),        # training: the plain form
    (torch.bfloat16, 8, "inference", 0, 2),    # head width outside the kernel
    (torch.bfloat16, 136, "inference", 0, 2),
    (torch.float32, 16, "inference", 0, 2),    # float32 attention: plain form
    (torch.bfloat16, 16, "uncast", 1, 0),      # f32 LayerNorm parameters
])
def test_routes_follow_grad_width_and_dtype(monkeypatch, dtype, head_features,
                                            mode, core, norms):
    core_spy = _Spy(kernels.attention_core)
    norm_spy = _Spy(kernels.layer_norm)
    monkeypatch.setattr(kernels, "attention_core", core_spy)
    monkeypatch.setattr(kernels, "layer_norm", norm_spy)
    item = AttentionItem(32, 2, head_features,
                         dtype=None if dtype == torch.float32 else dtype)
    layers.init_module(item, torch.Generator().manual_seed(0))
    if mode != "uncast":  # as the sampler casts its parameters
        item.to(dtype)
    if mode == "frozen":
        item.requires_grad_(False)
    x = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(1))
    ctx = {"inference": torch.inference_mode, "uncast": torch.inference_mode,
           "no_grad": torch.no_grad}.get(mode, torch.enable_grad)
    with ctx():
        item(x.to(dtype))
    assert (core_spy.calls, norm_spy.calls) == (core, norms)


@pytest.mark.parametrize("x_dtype,param_dtype,dtype,taken", [
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.float32, None, True),
    (torch.bfloat16, torch.float32, torch.bfloat16, False),  # uncast params
    (torch.bfloat16, torch.float32, None, False),            # f32 output
    (torch.float16, torch.float16, None, False)])
def test_layer_norm_route_by_dtype(monkeypatch, x_dtype, param_dtype, dtype,
                                   taken):
    """The library's LayerNorm takes one dtype throughout, float32 or
    bfloat16 (the sampler casts the parameters to the compute dtype); any
    width."""
    spy = _Spy(kernels.layer_norm)
    monkeypatch.setattr(kernels, "layer_norm", spy)
    with torch.inference_mode():
        for c in (12, 4096):
            ln = layers.LayerNorm(c, dtype=dtype, param_dtype=param_dtype)
            ln(torch.ones(1, 3, c, dtype=x_dtype))
    assert spy.calls == (2 if taken else 0)


@pytest.mark.parametrize("case,kernel", [
    ("inference", True), ("no_grad_mode", True), ("grad", False),
    ("float32", False), ("head_width_8", False), ("head_width_144", False)])
def test_routes_pick_kernel_or_plain(case, kernel):
    """One place decides each route: the kernel's wrapper without a
    gradient where the kernel takes the inputs, else the plain version."""
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    d = {"head_width_8": 8, "head_width_144": 144}.get(case, 64)
    wants_grad = case in ("no_grad_mode", "grad")
    q = torch.zeros(1, 8, 2 * d, dtype=dtype, requires_grad=wants_grad)
    x = torch.zeros(1, 8, 32, dtype=dtype, requires_grad=wants_grad)
    p = torch.ones(32, dtype=dtype)
    ctx = torch.enable_grad if case == "grad" else torch.no_grad
    with ctx():
        core = kernels.attention_core_route(q, q, q, 2)
        norm = kernels.layer_norm_route(x, p, p, dtype)
    assert core is (kernels.attention_core if kernel
                    else kernels.attention_core_reference)
    # The library's LayerNorm takes float32 and bfloat16, every width.
    assert norm is (kernels.layer_norm if case != "grad"
                    else kernels.layer_norm_reference)


def test_core_geometry_reads_packed_chunks():
    qkv = torch.zeros(2, 48, 3 * 4 * 16, dtype=torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    assert kernels._core_geometry(q, k, v, 4) == (2, 48, 48, 16)
    ctx = torch.zeros(2, 5, 64, dtype=torch.bfloat16)
    assert kernels._core_geometry(q, ctx, ctx, 4) == (2, 48, 5, 16)


@pytest.mark.parametrize("case", ["heads", "keys", "rank", "transposed",
                                  "row_stride"])
def test_core_geometry_rejects(case):
    q = torch.zeros(1, 32, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    heads = 4
    if case == "heads":
        heads = 3
    elif case == "keys":
        v = torch.zeros(1, 9, 64, dtype=torch.bfloat16)
    elif case == "rank":
        q = q[0]
    elif case == "transposed":
        q = torch.zeros(1, 64, 32, dtype=torch.bfloat16).transpose(1, 2)
    else:
        q = torch.zeros(1, 32, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError):
        kernels._core_geometry(q, k, v, heads)


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 4, 16, device="meta", dtype=torch.bfloat16)
    p = torch.zeros(16, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="for device meta"):
        kernels.layer_norm(x, p, p, 1e-6, torch.bfloat16)
    with pytest.raises(ValueError, match="for device meta"):
        kernels.attention_core(x, x, x, 1)


def test_operator_fake():
    """What a trace records: the core's operator fake gives the kernel's
    output shape and dtype."""
    with FakeTensorMode():
        qkv = torch.empty(2, 40, 3 * 128, dtype=torch.bfloat16)
        q, k, v = qkv.chunk(3, -1)
        out = torch.ops.audio_diffusion_torch.attention_core(q, k, v, 2)
        assert out.shape == (2, 40, 128) and out.dtype == torch.bfloat16
        assert out.is_contiguous()
