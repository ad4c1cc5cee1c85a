"""The benchmark's frozen arithmetic: the chip's peaks, and the operations
and bytes that the net and its fused resnet item need, counted from shapes
alone. No kernel name and no launch count enters it, so a change that
fuses, renames or removes a kernel leaves these numbers as they are.

What is counted, and why:

- Operations are the multiply-adds of the matrix products (2 FLOPs each):
  the k=3 convolutions (3·Cin·Cout per output position), the
  down- and upsampling projections, the skip and modulation gates, the
  attention's projections, its logits and its product with the values,
  the feed-forward, the σ embedding's two Dense layers and the output
  convolution. Normalizations, activations and the sampler's update are
  elementwise and not counted: they are bytes, not operations.
- A training step counts the forward three times over (the forward, and
  a backward of twice its products), with no recomputation.
- An item's bytes count each input once and each output once, whatever a
  kernel reads again: forward, x read and the output written, both
  kernels, the vectors and the modulation rows; backward, the incoming
  gradient and x, h, y read and dx written, both kernels read and their
  gradients written, the vectors and their gradients.
"""
