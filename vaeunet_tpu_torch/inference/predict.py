"""Whole-image prediction and N-sample segmentation distributions.  Port of
``vaeunet_tpu/inference/predict.py``.

- predict_full_image          <- visualize_vae.py:61-87
- segmentation_distribution   <- visualize_vae.py:578-652: encode once,
  draw N tempered latents in one fused kernel launch, decode each (tiled
  for an image larger than the patch), take sigmoids
- uncertainty_maps            <- visualize_vae.py:90-117
- predict_image               forward -> sigmoid -> threshold, for the
  VAE-UNet (z = mu, or a sampled z) and the plain UNet (the milesial
  predict.py path, JAX ``predict.py:57-70``)

Images are NHWC at these functions ([H,W,C] or [B,H,W,C]); maps come back
NHWC.  Every entry point runs on CUDA unless called with ``device="cpu"``.

``segmentation_distribution`` records the span ``serve.distribution``, with
``serve.latent`` (the whole-image encode and the draw) and the tiled
request's spans (``inference/tiled.py``) inside it, and ``uncertainty_maps``
the span ``serve.maps`` (``utils/profiling.py``; only while a
``torch.profiler`` session runs).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from vaeunet_tpu_torch.device import as_image, check_serving_model, resolve_device
from vaeunet_tpu_torch.inference.tiled import predict_tiled_ensemble
from vaeunet_tpu_torch.models.unet import UNet
from vaeunet_tpu_torch.models.vae_unet import UNetResNet
from vaeunet_tpu_torch.utils.profiling import span
from vaeunet_tpu_torch.vae_utils import sample_latents, to_nchw, to_nhwc


@torch.inference_mode()
def predict_full_image(model: UNetResNet, image, z: torch.Tensor, device=None) -> torch.Tensor:
    """Encoder -> decode(z) -> sigmoid at the input size.  image [H,W,C] or
    [B,H,W,C]; z [B,D].  (visualize_vae.py:61-87)"""
    device = resolve_device(device)
    check_serving_model(model, device)
    image = as_image(image, device)
    batched = image.dim() == 4
    x = to_nchw(image if batched else image[None])
    _, _, features = model.encode_with_features(x)
    z = torch.as_tensor(z, dtype=torch.float32, device=device)
    logits = model.decode_features(z, features, output_hw=tuple(x.shape[2:]))
    probs = to_nhwc(torch.sigmoid(logits.float()))
    return probs if batched else probs[0]


@torch.inference_mode()
def predict_image(model: Union[UNetResNet, UNet], image, out_threshold: float = 0.5,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, binary mask) for one [H,W,C] image (or a [B,H,W,C] batch):
    sigmoid > `out_threshold`.  The VAE-UNet takes the deterministic z = mu
    forward, or a sampled z when a generator is given; the plain UNet has no
    latent and refuses a generator."""
    device = resolve_device(device)
    check_serving_model(model, device)
    image = as_image(image, device)
    x = to_nchw(image[None] if image.dim() == 3 else image)
    if not isinstance(model, UNetResNet):
        if generator is not None:
            raise ValueError("a generator samples the VAE-UNet's latent; this model has none")
        logits = model(x)
    elif generator is None:
        logits, _, _ = model(x, sample=False)
    else:
        logits, _, _ = model(x, generator=generator)
    probs = to_nhwc(torch.sigmoid(logits.float()))
    mask = probs > out_threshold
    if image.dim() == 3:
        probs, mask = probs[0], mask[0]
    return probs, mask


@torch.inference_mode()
def segmentation_distribution(model: UNetResNet, image,
                              generator: Optional[torch.Generator] = None,
                              num_samples: int = 5, temperature: float = 1.0,
                              patch_size: Optional[int] = None, tile_batch: int = 8,
                              overlap: Optional[int] = None,
                              eps: Optional[torch.Tensor] = None, device=None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (samples [N,H,W,1] sigmoid maps, mu [D], logvar [D]) for one
    [H,W,C] image.  (visualize_vae.py:578-652)

    Tiled when `patch_size` is given and the image is larger; `overlap`
    overrides the adaptive tile overlap.  `eps` [N,1,D] replaces the noise
    draw (a test hook); otherwise the latents come from `generator`.
    """
    with span("serve.distribution"):
        device = resolve_device(device)
        check_serving_model(model, device)
        image = as_image(image, device)
        h, w = image.shape[0], image.shape[1]
        x = to_nchw(image[None])
        tiled = patch_size is not None and (h > patch_size or w > patch_size)
        with span("serve.latent"):
            if tiled:
                mu, logvar = model.encode(x)
            else:
                mu, logvar, features = model.encode_with_features(x)
            zs = sample_latents(mu, logvar, generator, temperature, num_samples, eps=eps)[:, 0]

        if tiled:
            samples = predict_tiled_ensemble(model, image, zs, patch_size, overlap=overlap,
                                             batch_size=tile_batch, device=device)
        else:
            samples = torch.stack([
                to_nhwc(torch.sigmoid(
                    model.decode_features(z[None], features, output_hw=(h, w)).float()))[0]
                for z in zs])
        return samples, mu[0], logvar[0]


def uncertainty_maps(samples: torch.Tensor, eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """Per-pixel uncertainty decomposition from [N,H,W,1] sigmoid samples.
    (visualize_vae.py:90-117)

    entropy     = H(mean p)                   (total uncertainty)
    exp_entropy = mean_i H(p_i)               (aleatoric)
    mutual_info = entropy - exp_entropy       (epistemic)
    cv          = std / (mean + eps)
    std is the population std (ddof 0), as ``jnp.std``.
    """
    with span("serve.maps"):
        mean = samples.mean(dim=0)
        std = samples.std(dim=0, correction=0)

        def binary_entropy(p):
            p = torch.clamp(p, eps, 1 - eps)
            return -(p * torch.log(p) + (1 - p) * torch.log(1 - p))

        entropy = binary_entropy(mean)
        exp_entropy = binary_entropy(samples).mean(dim=0)
        return {
            "mean": mean,
            "std": std,
            "entropy": entropy,
            "mutual_info": entropy - exp_entropy,
            "cv": std / (mean + eps),
        }
