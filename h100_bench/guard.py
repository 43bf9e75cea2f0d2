"""What a run may not load: JAX, or the JAX package the port was made from.
Names are compared whole by their top level (the part before the first
dot), so the port, ``ssdn_tpu_torch``, is not the JAX package
``ssdn_tpu``."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ssdn_tpu"})


def jax_modules(names=None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
