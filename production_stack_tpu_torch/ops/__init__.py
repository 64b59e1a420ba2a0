"""Tensor ops of the forward pass and the paged-attention kernels."""
