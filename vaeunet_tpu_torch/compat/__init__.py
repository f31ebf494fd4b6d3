from vaeunet_tpu_torch.compat.jax_weights import (
    convert_jax_pretrain,
    convert_jax_unet,
    convert_jax_unet_resnet,
    load_jax_variables,
)
from vaeunet_tpu_torch.compat.loading import load_model, load_state
from vaeunet_tpu_torch.compat.torch_weights import (
    convert_resnet34_backbone,
    load_reference_checkpoint,
)

__all__ = ["convert_jax_pretrain", "convert_jax_unet",
           "convert_jax_unet_resnet", "load_jax_variables", "load_model", "load_state",
           "load_reference_checkpoint", "convert_resnet34_backbone"]
