"""The import guard: the benchmark measures the port alone.

A run fails when the process holds JAX, its libraries or the JAX package,
compared by whole top-level module names (the part before the first
dot): `mrg_slam_tpu_torch`, the port, begins with the JAX package's name
and passes.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mrg_slam_tpu"})


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    names = {m.split(".", 1)[0]
             for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
