"""Tensor ops of the port: plain PyTorch, plus the K1 CUDA kernel wrapper in
:mod:`dawn_tpu_torch.ops.local_attention`."""
