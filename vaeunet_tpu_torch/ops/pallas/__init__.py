"""Wrappers of the hand-written CUDA kernels, each beside its plain PyTorch
version.  Port of ``vaeunet_tpu/ops/pallas/`` (the module names follow the
Pallas files whose kernels they replace; ``bn_train`` replaces none, the
JAX package leaving the training BN to XLA)."""

from vaeunet_tpu_torch.ops.pallas.bn_relu import fused_bn_relu
from vaeunet_tpu_torch.ops.pallas.reparam import normal, reparameterize
from vaeunet_tpu_torch.ops.pallas.resize_mm import resize, resize_h, resize_w

__all__ = ["fused_bn_relu", "normal", "reparameterize", "resize", "resize_h", "resize_w"]
