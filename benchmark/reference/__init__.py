"""The benchmark's plain PyTorch reference: the net, the sampler, the
training step and the service's derivations, in float32, importing nothing
of the program under test."""
