"""Rematerialization of a block in the backward pass.  New in the port: the
counterpart of flax ``nn.remat`` around the JAX package's residual blocks
(``models/resnet.py:118-141``), decoder blocks (``models/vae_unet.py:243-248,
296-302``) and UNet stages (``models/unet.py:30-36``), with its two
policies:

- ``'full'``: the block keeps nothing for the backward but its inputs; the
  backward runs the block's forward again.
- ``'save_convs'``: the products of every 3x3 conv that feeds a BN are
  kept: the fused conv + moments kernel's (y and its sums,
  ``ops/pallas/conv_bn_stats.py``) and the strided convs' y, the values
  the JAX package names ``checkpoint_name(y, 'remat_save')`` in its blocks
  and keeps by ``save_only_these_names('remat_save')``.  In the recompute
  each such conv hands back its kept product instead of running again
  (``ops/layers.py::conv3x3_bn``), and only the BN -> ReLU epilogues and
  the block's other work run again.  The JAX decoder block also names its
  upsampled input and its gated skip; the port recomputes those two.

Both go through ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``.
Its recompute runs every training-mode BN a second time, which would move
the BN running statistics twice; JAX's remat moves them once.  So the
recompute runs with :func:`bn_frozen` true, and the port's ``BatchNorm``
(``ops/layers.py``) then normalizes as before but leaves its running
statistics and ``num_batches_tracked`` alone.

The state read by :func:`bn_frozen` and :func:`kept` is per thread, like
autograd's grad mode: the recompute runs inside the backward, on whichever
thread autograd runs it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint

POLICIES = ("full", "save_convs")

_STATE = threading.local()


def bn_frozen() -> bool:
    """True inside a recompute: BN must not move its running statistics."""
    return getattr(_STATE, "bn_frozen", False)


class _KeptProducts:
    """The conv products of one checkpointed call under ``'save_convs'``:
    appended in the forward, handed back in the same order in the
    recompute."""

    def __init__(self):
        self.values: List[Tuple[torch.Tensor, ...]] = []
        self.replay: Optional[int] = None     # next index while recomputing

    def take(self, compute: Callable, replay: Callable) -> Tuple[torch.Tensor, ...]:
        if self.replay is None:
            out = compute()
            self.values.append(tuple(t.detach() for t in out))
            return out
        saved = self.values[self.replay]
        self.replay += 1
        return replay(tuple(t.detach() for t in saved))


def kept(compute: Callable, replay: Callable) -> Tuple[torch.Tensor, ...]:
    """``compute()`` -> a tuple of tensors.  In the recompute of a
    ``'save_convs'`` block, ``replay(saved)`` instead, with the tuple its
    forward kept: it must hand `saved` back with the autograd node the
    backward needs, saving the tensors ``compute`` saved (the checkpoint
    matches them by order and shape).  Anywhere else ``compute()``."""
    store = getattr(_STATE, "store", None)
    return compute() if store is None else store.take(compute, replay)


@contextlib.contextmanager
def _scope(store: Optional[_KeptProducts], recompute: bool) -> Iterator[None]:
    prev = (getattr(_STATE, "bn_frozen", False), getattr(_STATE, "store", None))
    _STATE.bn_frozen = prev[0] or recompute
    _STATE.store = store
    if store is not None:
        store.replay = 0 if recompute else None
    try:
        yield
    finally:
        _STATE.bn_frozen, _STATE.store = prev


def check_policy(policy: str) -> str:
    if policy not in POLICIES:
        raise ValueError(f"remat_policy {policy!r}: expected one of {POLICIES}")
    return policy


def checkpoint(fn: Callable, *args, policy: str = "full"):
    """``fn(*args)``, rematerialized in the backward by `policy`.  Without
    a graph to record (no grad mode) it is just the call."""
    check_policy(policy)
    if not torch.is_grad_enabled():
        return fn(*args)
    store = _KeptProducts() if policy == "save_convs" else None

    def contexts():
        return _scope(store, recompute=False), _scope(store, recompute=True)

    # the blocks draw no random numbers, so no RNG state is stashed
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=contexts, preserve_rng_state=False)
