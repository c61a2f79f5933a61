"""Tensor ops: bilinear upsampling, NNE inference and the fused kernels'
wrappers (`szn_fused`, `block1_fused`, built by `_kernels`)."""
