"""Standard-normal noise and the fused reparameterization: the CUDA kernels'
wrappers and their plain versions.  Port of
``vaeunet_tpu/ops/pallas/reparam.py`` (``normal_pallas`` and
``reparameterize_pallas``).

Both kernels of ``csrc/reparam.cu`` draw their noise from one stream:
Philox4x32-10 under the 64-bit key ``seed``, one call per 4 consecutive
elements.  Counter k = i >> 2 gives words (x, y, z, w); the TPU kernel's
Box-Muller (u1 = (b1 >> 8) * 2^-24 + 2^-25, never 0; u2 = (b2 >> 8) *
2^-24; r = sqrt(-2 ln u1), t = 2 pi u2) turns each pair into both of its
normals: element 4k = r cos t and 4k + 1 = r sin t of (x, y), 4k + 2 and
4k + 3 the same of (z, w).  Element i depends on its index only.  The plain
versions compute the same stream with int64 tensor arithmetic, so on the
card a kernel and its plain version agree element for element up to the
ulps of log, sin, cos and exp.  Neither matches ``jax.random`` or the TPU's
bits: parity with the JAX package is held at the distribution level, or by
feeding both sides the same eps.

A CUDA device goes to the kernel; the CPU to the plain version.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from vaeunet_tpu_torch.ops import _ext

_MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI = 6.283185307179586
# device index -> an empty fp32 tensor there: `new_empty` from it parses
# fewer arguments than torch.empty(shape, dtype=, device=), which is a large
# share of the host time of a small draw
_EMPTY: Dict[int, torch.Tensor] = {}


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values held in int64,
    split in 16-bit halves so no product leaves int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) of counter words c0..c3 (int64
    tensors holding uint32 values) under key (k0, k1) -> 4 output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def philox_words(calls: int, seed: int, device) -> tuple:
    """Words (x, y, z, w) of Philox4x32-10 at counters (k, 0) for k < `calls`
    (k in the low 64 bits), under key `seed`."""
    k = torch.arange(calls, dtype=torch.int64, device=device)
    zero = torch.zeros_like(k)
    return philox4x32_10(k & _MASK32, (k >> 32) & _MASK32, zero, zero,
                         seed & _MASK32, (seed >> 32) & _MASK32)


def box_muller(b1: torch.Tensor, b2: torch.Tensor) -> tuple:
    """Both normals of the word pairs (b1, b2): (r cos t, r sin t)."""
    u1 = (b1 >> 8).float() * (1.0 / (1 << 24)) + (1.0 / (1 << 25))
    u2 = (b2 >> 8).float() * (1.0 / (1 << 24))
    radius = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI * u2
    return radius * torch.cos(theta), radius * torch.sin(theta)


def _check_seed(seed: int) -> int:
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must be a 64-bit unsigned integer, got {seed}")
    return seed


def normal_plain(shape: Sequence[int], seed: int, device="cpu") -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    x, y, z, w = philox_words(-(-n // 4), _check_seed(seed), device)
    lanes = (*box_muller(x, y), *box_muller(z, w))
    return torch.stack(lanes, dim=1).view(-1)[:n].view(shape)


def _empty_f32(shape: Sequence[int], device: torch.device) -> torch.Tensor:
    index = device.index if device.index is not None else _ext._current_device()
    proto = _EMPTY.get(index)
    if proto is None:
        with torch.inference_mode(False):
            proto = _EMPTY[index] = torch.empty(0, dtype=torch.float32,
                                                device=torch.device("cuda", index))
    return proto.new_empty(shape)


def normal(shape: Sequence[int], seed: int, device) -> torch.Tensor:
    """Standard-normal fp32 tensor of `shape` on `device` from `seed`.  It
    has no tensor input, so autograd has nothing to lose here: the draw is
    a constant of the graph."""
    if not isinstance(device, torch.device):
        device = torch.device(device)
    seed = _check_seed(seed)
    if device.type == "cpu":
        return normal_plain(shape, seed, device)
    if device.type != "cuda":
        raise ValueError(f"normal: unsupported device {device}")
    out = _empty_f32(shape, device)
    n = out.numel()
    if n == 0:
        return out
    _ext.call("reparam", "vaeunet_normal", device, out.data_ptr(), n, seed)
    _ext.count_launch("normal")
    return out


def reparameterize_plain(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                         temperature: float = 1.0) -> torch.Tensor:
    eps = normal_plain(mu.shape, seed, mu.device)
    std = torch.exp(0.5 * logvar) * float(temperature)
    return mu + eps * std


def _check_pair(mu: torch.Tensor, logvar: torch.Tensor) -> None:
    if mu.dim() != 2 or mu.shape != logvar.shape:
        raise ValueError(f"reparameterize expects mu, logvar [B, D] of one shape, "
                         f"got {tuple(mu.shape)} and {tuple(logvar.shape)}")
    for name, t in (("mu", mu), ("logvar", logvar)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"reparameterize: {name} must be contiguous float32")
    if mu.device != logvar.device:
        raise ValueError("reparameterize: mu and logvar on different devices")


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, seed: int,
                   temperature: float = 1.0) -> torch.Tensor:
    """z = mu + eps * exp(0.5 * logvar) * T, eps drawn from `seed`.

    No clamp of logvar, exactly like ``reparameterize_pallas``: callers
    that need a guard (``vae_utils.sample_latents``) clip before the call.
    The kernel has no backward: on CUDA it raises under autograd (training
    draws eps with :func:`normal` and keeps the arithmetic in torch).
    """
    _check_pair(mu, logvar)
    seed = _check_seed(seed)
    if mu.device.type == "cpu":
        return reparameterize_plain(mu, logvar, seed, temperature)
    if mu.device.type != "cuda":
        raise ValueError(f"reparameterize: unsupported device {mu.device}")
    _ext.refuse_autograd("reparameterize", mu, logvar)
    z = torch.empty_like(mu)
    if z.numel() == 0:
        return z
    _ext.call("reparam", "vaeunet_reparam", mu.device, mu.data_ptr(), logvar.data_ptr(),
              float(temperature), z.data_ptr(), z.numel(), seed)
    _ext.count_launch("reparam")
    return z
