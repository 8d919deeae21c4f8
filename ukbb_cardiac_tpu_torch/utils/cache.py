"""Where the port keeps its compiled kernels.

Counterpart of ``ukbb_cardiac_tpu/utils/cache.py``, which turns on JAX's
persistent compilation cache.  The port's compiled programs are its
kernel libraries: ``kernels.py`` builds each ``csrc/*.cu`` with nvcc and
``native/`` builds ``hostops.cc`` with g++, at first use, into
``build/kernels/`` and ``build/native/`` at the root of the checkout,
under file names that carry a digest of the source and flags.  A later
process finds a current build there and loads it without compiling.
"""

from __future__ import annotations

from pathlib import Path


def enable_compilation_cache(cache_dir: str | None = None) -> bool:
    """Keep the compiled kernel and host-op libraries in ``cache_dir``
    (one directory for both: their file names differ), or, without one,
    where they are (``build/``).  Returns True."""
    if cache_dir:
        from ukbb_cardiac_tpu_torch import kernels, native

        kernels.BUILD_DIR = Path(cache_dir)
        native.BUILD_DIR = Path(cache_dir)
    return True
