from vaeunet_tpu_torch.models.efficientnet import EfficientNetEncoder
from vaeunet_tpu_torch.models.resnet import ResNetEncoder
from vaeunet_tpu_torch.models.unet import UNet, build_unet
from vaeunet_tpu_torch.models.vae_unet import (
    DecoderBlock,
    UNetResNet,
    build_encoder,
    build_model,
    capture_attention,
)

__all__ = ["EfficientNetEncoder", "ResNetEncoder", "DecoderBlock", "UNet", "UNetResNet",
           "build_encoder", "build_model", "build_unet", "capture_attention"]
