"""VAE sampling utilities.  Port of ``vaeunet_tpu/vae_utils.py`` (reference
``utils/vae_utils.py``).

- sample_from_latent      <- vae_utils.py:5-10
- sample_latents          N tempered draws in one fused kernel launch
- encode_images           <- vae_utils.py:13-25
- generate_predictions    <- vae_utils.py:28-76, the sample axis written out
                             as a batch dimension
- calculate_latent_stats  <- vae_utils.py:79-103

Images are NHWC at these functions, as in the JAX package; the model is
called in NCHW channels_last.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vaeunet_tpu_torch.models.vae_unet import UNetResNet
from vaeunet_tpu_torch.ops.pallas.reparam import reparameterize
from vaeunet_tpu_torch.ops.sampling import gaussian_like, seed_from_generator

# Inference guard on logvar (vae_utils.py:22-38 of the JAX package): the
# encoder trained on 512^2 patches can blow the logvar head up on a whole
# fundus image; clamping bounds the posterior std to e^1.
LOGVAR_GUARD = 2.0


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,C,H,W] in channels_last memory (a free view of a
    contiguous NHWC tensor)."""
    return images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def sample_from_latent(mu: torch.Tensor, logvar: torch.Tensor,
                       generator: Optional[torch.Generator], temperature: float = 1.0,
                       eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """z = mu + eps * std * T with logvar clamped to +-LOGVAR_GUARD."""
    std = torch.exp(0.5 * torch.clamp(logvar, -LOGVAR_GUARD, LOGVAR_GUARD))
    std = std * temperature
    eps = gaussian_like(generator, std.shape, std.device, eps=eps)
    return mu + eps * std


def sample_latents(mu: torch.Tensor, logvar: torch.Tensor,
                   generator: Optional[torch.Generator], temperature: float = 1.0,
                   num_samples: int = 1, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N, B, D] tempered draws with the guard of sample_from_latent.

    Without `eps`: one launch of the fused reparameterization kernel on
    mu and the clipped logvar broadcast to [N*B, D].  With `eps` [N, B, D]
    (a test hook): the same arithmetic on the given noise.
    """
    n = int(num_samples)
    b, d = mu.shape
    logvar = torch.clamp(logvar, -LOGVAR_GUARD, LOGVAR_GUARD)
    if eps is None:
        if generator is None:
            raise ValueError("sample_latents needs a torch.Generator or eps")
        mu_n = mu.float().expand(n, b, d).reshape(n * b, d).contiguous()
        lv_n = logvar.float().expand(n, b, d).reshape(n * b, d).contiguous()
        z = reparameterize(mu_n, lv_n, seed_from_generator(generator), temperature)
        return z.view(n, b, d)
    std = torch.exp(0.5 * logvar) * temperature
    eps = gaussian_like(None, (n, b, d), mu.device, eps=eps)
    return mu[None] + eps * std[None]


def encode_images(model: UNetResNet, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode encoder on NHWC images -> (mu, logvar)."""
    with torch.inference_mode():
        return model.encode(to_nchw(images))


def mean_tempered_logits(model: UNetResNet, x: torch.Tensor,
                         generator: Optional[torch.Generator], temperature: float = 1.0,
                         num_samples: int = 3, eps: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Mean decoder logits [B,H,W,C] over `num_samples` tempered draws for
    NCHW `x`, in the caller's grad mode.  The encoder runs once; the N
    samples are one decoder batch of N*B (the JAX package vmaps over them).
    With strategy 'none', z = mu.  Under autograd the noise is drawn as eps
    (the fused draw kernel has no backward)."""
    b = x.shape[0]
    mu, logvar, features = model.encode_with_features(x)
    if model.should_sample or model.latent_injection != "none":
        if eps is None and torch.is_grad_enabled():
            eps = gaussian_like(generator, (num_samples, *mu.shape), mu.device)
        zs = sample_latents(mu, logvar, generator, temperature, num_samples, eps=eps)
    else:
        zs = mu[None].expand(num_samples, *mu.shape)
    feats = [f.repeat(num_samples, 1, 1, 1) for f in features]
    logits = model.decode_features(zs.reshape(num_samples * b, -1), feats,
                                   output_hw=tuple(x.shape[2:]))
    preds = logits.view(num_samples, b, *logits.shape[1:])
    return to_nhwc(preds.mean(dim=0))


def generate_predictions(model: UNetResNet, images: torch.Tensor,
                         generator: Optional[torch.Generator], temperature: float = 1.0,
                         num_samples: int = 3, eps: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """:func:`mean_tempered_logits` of NHWC `images` under inference mode."""
    with torch.inference_mode():
        return mean_tempered_logits(model, to_nchw(images), generator, temperature,
                                    num_samples, eps)


def calculate_latent_stats(mu: torch.Tensor, logvar: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Posterior-collapse monitor.  (vae_utils.py:79-103)"""
    mu = mu.float()
    logvar = logvar.float()
    mean_mu = mu.mean(dim=0)
    mean_var = torch.exp(logvar).mean(dim=0)
    active = (mean_mu.abs() > 0.1) | (mean_var < 0.9) | (mean_var > 1.1)
    active_dims = active.sum()
    total_dims = mu.shape[1]
    kl_per_dim = 0.5 * (mean_mu.square() + mean_var - logvar.mean(dim=0) - 1.0)
    return {
        "active_dims": active_dims,
        "total_dims": torch.tensor(total_dims),
        "activity_ratio": active_dims / total_dims,
        "total_kl": kl_per_dim.sum(),
        "mean_mu_abs": mean_mu.abs().mean(),
        "mean_var": mean_var.mean(),
    }
