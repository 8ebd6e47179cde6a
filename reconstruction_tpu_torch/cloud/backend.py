"""Cloud-stage backend selection (counterpart of
`reconstruction_tpu/cloud/backend.py`).

The cloud stages exist in two formulations:

  * "torch"  - streaming voxel-grid neighbor reduces on the points' device
               (cloud/neighbors.py), the card in the pipeline;
  * "native" - the C++/OpenMP exact k-NN grid on the host
               (native/src/cloud_stats.cpp), built at first use.

"auto" is "torch".  The backend comes from the configuration alone; an
explicit "native" raises when the library cannot be built, and nothing
falls back from one backend to the other.
"""

from __future__ import annotations

BACKENDS = ("torch", "native")


def resolve_backend(backend: str = "auto") -> str:
    if backend == "auto":
        return "torch"
    if backend == "native":
        from reconstruction_tpu_torch import native
        native.load()      # raises when the library cannot be built
        return "native"
    if backend not in BACKENDS:
        raise ValueError(f"unknown cloud backend {backend!r}; "
                         f"use 'auto', {', '.join(map(repr, BACKENDS))}")
    return backend
