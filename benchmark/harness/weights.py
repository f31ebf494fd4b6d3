"""Seeded weights, made on the device in four calls.

PyTorch's default init of every convolution (weight and bias uniform in
+-1/sqrt(fan_in), which is what kaiming_uniform(a=sqrt(5)) gives), BN
scale 1 and shift 0.  Running statistics are 0 and 1 for training; for
serving they are drawn (means normal with std 0.5, variances uniform in
[0.5, 2]) so that no BN of a random network saturates the sigmoid.

The shapes come from the reference model, built on the meta device; the
same dictionary loads into the reference and into the program by name.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from benchmark.reference.layers import BatchNorm, Conv


def make(model: nn.Module, seed: int, device, serving: bool) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    convs = [(n, m) for n, m in model.named_modules() if isinstance(m, Conv)]
    bns = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    leaves = [(f"{n}.{k}", getattr(m, k), m.fan_in() ** -0.5)
              for n, m in convs for k in ("weight", "bias") if getattr(m, k) is not None]
    flat = torch.rand(sum(p.numel() for _, p, _ in leaves), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    for (name, p, bound), part in zip(leaves, flat.split([p.numel() for _, p, _ in leaves])):
        out[name] = ((part * 2 - 1) * bound).view(p.shape)
    sizes = [m.weight.numel() for _, m in bns]
    total = sum(sizes)
    if serving:
        means = torch.randn(total, generator=g, device=device) * 0.5
        vars_ = torch.rand(total, generator=g, device=device) * 1.5 + 0.5
    else:
        means = torch.zeros(total, device=device)
        vars_ = torch.ones(total, device=device)
    for (n, _), mean, var in zip(bns, means.split(sizes), vars_.split(sizes)):
        out[f"{n}.weight"] = torch.ones_like(mean)
        out[f"{n}.bias"] = torch.zeros_like(mean)
        out[f"{n}.running_mean"] = mean
        out[f"{n}.running_var"] = var
    return out


@torch.no_grad()
def load(module: nn.Module, weights: Dict[str, torch.Tensor]) -> nn.Module:
    """Copy `weights` into `module`'s parameters and running statistics by
    name; every one of them must be covered, and every weight used."""
    state = {k: v for k, v in module.state_dict(keep_vars=True).items()
             if not k.endswith("num_batches_tracked")}
    missing = sorted(set(state) - set(weights))
    unused = sorted(set(weights) - set(state))
    if missing or unused:
        raise KeyError(f"weights do not match the model: missing {missing[:5]}, "
                       f"unused {unused[:5]}")
    for k, t in state.items():
        t.copy_(weights[k])
    return module
