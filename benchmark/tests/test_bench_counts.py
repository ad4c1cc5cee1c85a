"""The frozen operation and byte counts against a count by hand."""
import pytest

from counts import item, net, peaks

# Two levels: channels [4, 8], factors [1, 2], one item each, self-attention
# at level 1 with 2 heads of 4, modulation features 6, stereo in and out.
SMALL = dict(in_channels=2, channels=[4, 8], factors=[1, 2], items=[1, 1],
             attentions=[0, 1], attention_heads=2, attention_features=4,
             modulation_features=6)


def test_forward_flops_by_hand():
    b, t = 3, 16
    f = 6
    l0, l1 = 16, 8
    sigma = 2 * b * (257 * f + f * f)
    down = 2 * b * l0 * 1 * 2 * 4 + 2 * b * l1 * 2 * 4 * 8
    item0 = 12 * b * l0 * 4 * 4 + 2 * b * f * 2 * 4
    item1 = 12 * b * l1 * 8 * 8 + 2 * b * f * 2 * 8
    inner = 8
    attn = (2 * b * l1 * 8 * 3 * inner + 2 * 2 * b * l1 * l1 * inner
            + 2 * b * l1 * inner * 8 + 2 * 2 * b * l1 * 8 * 32)
    items = 2 * item0 + 2 * (item1 + attn)
    skip = 2 * b * f * 4
    up = 2 * b * l0 * 4 * 1 * 4 + 2 * b * l1 * 8 * 2 * 4
    out = 2 * b * t * 3 * 4 * 2
    want = sigma + down + items + skip + up + out
    assert net.forward_flops(SMALL, b, t) == want
    assert net.train_flops(SMALL, b, t) == 3 * want


def test_cross_attention_flops_by_hand():
    cfg = dict(SMALL, attentions=[0, 0], cross_attentions=[0, 1],
               embedding_features=5, embedding_max_length=3)
    b, l1, inner, n, e = 1, 8, 8, 3, 5
    cross = (2 * b * l1 * 8 * inner + 2 * 2 * b * n * e * inner
             + 2 * 2 * b * l1 * n * inner + 2 * b * l1 * inner * 8
             + 2 * 2 * b * l1 * 8 * 32)
    plain = dict(SMALL, attentions=[0, 0])
    assert net.forward_flops(cfg, 1, 16) - net.forward_flops(plain, 1, 16) \
        == 2 * cross


def test_item_shapes_of_the_nine_levels():
    cfg = dict(channels=[8, 32, 64, 128, 256, 512, 512, 1024, 1024],
               factors=[1, 4, 4, 4, 2, 2, 2, 2, 2],
               items=[1, 2, 2, 2, 2, 2, 2, 4, 4])
    shapes = list(net.item_shapes(cfg, 1, 2**18))
    assert len(shapes) == 42
    assert shapes[0] == (1, 2**18, 8) and shapes[20] == (1, 2**7, 1024)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_item_bounds_by_hand(dtype):
    e = 2 if dtype == "bfloat16" else 4
    b, l, c = 2, 4096, 128
    fwd_bytes = (2 * b * l * c + 6 * c * c + 8 * c + 2 * b * c) * e
    fwd_flops = 12 * c * c * l * b
    bound, nbytes, flops = item.forward(b, l, c, dtype)
    assert (nbytes, flops) == (fwd_bytes, fwd_flops)
    assert bound == max(fwd_bytes / peaks.HBM_BYTES_PER_S,
                        fwd_flops / peaks.FLOPS[dtype])
    bwd_bytes = (5 * b * l * c + 12 * c * c + 22 * c) * e
    bound, nbytes, flops = item.backward(b, l, c, dtype)
    assert (nbytes, flops) == (bwd_bytes, 24 * c * c * l * b)
