from vaeunet_tpu_torch.compat.jax_weights import (
    convert_jax_unet,
    convert_jax_unet_resnet,
    load_jax_variables,
)

__all__ = ["convert_jax_unet", "convert_jax_unet_resnet", "load_jax_variables"]
