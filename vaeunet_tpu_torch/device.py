"""Device choice and fp32 numerics for the port's entry points.

New in the port.  Entry points run on CUDA unless the caller passes
``device="cpu"``; with no GPU and no explicit ``"cpu"`` they raise instead
of carrying on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda`` (raises without a GPU); ``"cpu"`` / ``"cuda[:i]"``
    as given; anything else raises."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return device
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def use_fp32_numerics() -> None:
    """Serve in full fp32: cuDNN convolutions default to TF32, which keeps
    about 3 decimal digits and breaks parity with the JAX package; the
    matmul switch is set too so neither depends on the caller's defaults."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def as_image(image, device: torch.device) -> torch.Tensor:
    """An image (numpy or torch, NHWC) as a float32 tensor on `device`."""
    return torch.as_tensor(image, dtype=torch.float32, device=device)


def check_serving_model(model: torch.nn.Module, device: torch.device) -> None:
    """A serving call needs the model in eval mode on the device it asked
    for: a model left elsewhere is an error, never a quiet fallback."""
    if model.training:
        raise ValueError("serving entry points need the model in eval mode")
    p = next(model.parameters())
    if p.device.type != device.type:
        raise ValueError(f"model is on {p.device}, the call asked for {device}")


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded once, on any device: with a Python number for a
    divisor, CUDA tensors multiply by its reciprocal instead (one more
    rounding), so the divisor goes in as a 0-dim tensor on x's device."""
    return x / x.new_full((), d)


def host_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on `device` without waiting for the device: on CUDA
    through pinned memory and a ``non_blocking`` copy (a copy from pageable
    memory would wait for the stream; the caching host allocator keeps the
    pinned block until the copy has run)."""
    if device.type != "cuda" or not t.is_cpu:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
