"""Device mesh helpers (SURVEY.md P8: the reference has no distributed
backend -- rayon shared-memory only; the equivalent here is a
jax.sharding.Mesh over the cards with XLA collectives)."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def default_mesh(n_devices: int | None = None, axis_name: str = "dp") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))
