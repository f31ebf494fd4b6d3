"""Gaussian noise for every sampling site.  Port of
``vaeunet_tpu/ops/sampling.py``.

:func:`gaussian_like` draws one 64-bit seed from the caller's
``torch.Generator`` per call (successive calls differ, a fixed generator
state repeats: the role of ``_seed_from_key``) and hands it to the noise
kernel of ``ops/pallas/reparam.py`` on a CUDA device, or to its plain
version on the CPU.  ``eps=`` injects the noise instead, so tests can feed
the port and the JAX package the same draws.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vaeunet_tpu_torch.ops.pallas.reparam import normal


def seed_from_generator(generator: torch.Generator) -> int:
    """One unsigned 64-bit seed drawn from `generator`."""
    s = torch.randint(-(1 << 63), (1 << 63) - 1, (1,), dtype=torch.int64,
                      generator=generator, device=generator.device)
    return int(s.item()) & ((1 << 64) - 1)


def gaussian_like(generator: Optional[torch.Generator], shape: Sequence[int],
                  device, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """eps ~ N(0, 1) of `shape` on `device`, or the given `eps`."""
    shape = tuple(int(s) for s in shape)
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=device)
        if tuple(eps.shape) != shape:
            raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return eps
    if generator is None:
        raise ValueError("gaussian_like needs a torch.Generator or eps")
    return normal(shape, seed_from_generator(generator), device)
