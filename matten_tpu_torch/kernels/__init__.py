"""Hand-written CUDA kernels for Hopper with their plain PyTorch versions.

Import the kernel modules directly (e.g. `matten_tpu_torch.kernels.fused_conv`);
nothing is built or loaded until a kernel is first launched.
"""
