"""The run's refusal of the JAX package and of JAX itself: what the process
has imported, compared by whole top-level module names (the part before
the first dot), so ``mrcc_tpu_torch`` is not ``mrcc_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "mrcc_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The imported modules (``sys.modules`` unless ``names`` is given)
    whose top-level name is forbidden."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
