"""What a run may not load: JAX, its libraries, or the JAX package.  A
module counts by its top-level name (the part before the first dot),
compared whole: ``ukbb_cardiac_tpu_torch`` is the port and is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "ukbb_cardiac_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
