"""What no process of the benchmark may hold: JAX and the JAX package.
Names are compared by their top-level part whole, since the port's name,
``vaeunet_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "vaeunet_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})
