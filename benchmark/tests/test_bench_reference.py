"""The frozen reference against the program's CPU path on a tiny net: the
same weights, made by the benchmark, give the same net outputs, samples,
replies and training steps."""
import pytest
import torch

from harness import core
from reference.unet import denoise, net_forward, param_spec
from tiny import NET, TEXT_NET, cell, run_cell

CELLS = ["uncond-sample-b1", "text-cfg-sample-b1", "uncond-train-b8",
         "uncond-serve-poisson"]


@pytest.mark.parametrize("net", [NET, TEXT_NET], ids=["uncond", "text"])
def test_net_and_sampler(net):
    device = torch.device("cpu")
    weights = core.make_weights(param_spec(net), 5, device)
    config = dict(name="tiny", dtype="float32", net=net,
                  text_encoder="StubTextEncoder")
    model = core.build_model(config, weights, device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, 64, generator=gen)
    sig = torch.rand(2, generator=gen)
    cond = {}
    if "embedding_features" in net:
        cond = dict(embedding=torch.randn(2, 4, 12, generator=gen),
                    embedding_scale=3.0)
    with torch.no_grad():
        got = model.net(model.params, x, sig, **cond)
        want = net_forward(weights, net, x, sig, **cond)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)
        sample = model.sample(x, num_steps=3, **cond)
        ref = denoise(weights, net, x, 3, **cond)
        torch.testing.assert_close(sample, ref, rtol=1e-4, atol=2e-5)


def test_weights_follow_the_spec_and_the_seed():
    spec = param_spec(NET)
    a = core.make_weights(spec, 7, "cpu")
    b = core.make_weights(spec, 7, "cpu")
    c = core.make_weights(spec, 8, "cpu")
    assert list(a) == [name for name, *_ in spec]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["inner.down_0.kernel"], c["inner.down_0.kernel"])
    assert torch.allclose(a["inner.out_gn_scale"].mean(),
                          torch.tensor(1.0), atol=0.1)


@pytest.mark.parametrize("workload", CELLS)
def test_whole_cell_on_the_cpu_is_correct(workload):
    """A tiny cell run end to end in float32: every compared number far
    under its limit (float32 rounding only)."""
    run, _ = run_cell(workload)
    assert run.correct, run.compared
    for c in run.compared:
        assert c["value"] < 0.1 * c["limit"], c
    assert run.attempted >= 1 and run.failed == 0


def test_inputs_follow_the_seed():
    from drivers import sample

    c = cell("text-cfg-sample-b1")
    runs = [core.Run(c, s, 1.0, False, torch.device("cpu"), 0.0)
            for s in (3, 3, 4)]
    (n0, e0), (n1, e1), (n2, e2) = (sample._inputs(r, 0) for r in runs)
    assert torch.equal(n0, n1) and torch.equal(e0, e1)
    assert not torch.equal(n0, n2)
    rows = (e0.abs().sum(-1) > 0).sum(-1)
    assert ((1 <= rows) & (rows <= 3)).all()
