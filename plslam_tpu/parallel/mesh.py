"""Device-mesh helpers for the distributed solvers.

The SLAM-domain sharding map (SURVEY.md §2.4): landmarks ("lm" axis) are
the data-parallel dimension of bundle adjustment — every landmark block
carries its own observations, Hessian blocks, and Schur contributions, and
only the small reduced camera system is psum-reduced across devices.
Keyframe-sequence blocks use the same axis for the pose-graph solver.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis: str = "lm") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of the default
    backend (all of them by default).  Raises when the backend has fewer:
    a mesh never moves to another backend behind the caller's back.
    (Tests get 8 devices from JAX_PLATFORMS=cpu with a forced host
    device count.)"""
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: need {n} devices, the default backend "
            f"({devs[0].platform}) has {len(devs)}")
    return Mesh(np.asarray(devs[:n]), (axis,))


def shard_leading(mesh: Mesh, x, axis: str = "lm"):
    """Place an array sharded along its leading dim over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))
