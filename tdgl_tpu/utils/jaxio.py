"""Device->host transfer helpers."""

from __future__ import annotations

from typing import Any

import jax
import numpy as np


def to_numpy(x) -> np.ndarray:
    """Fetch a jax array (or pass through a host value) as a numpy array."""
    return np.asarray(x)


def tree_to_numpy(tree: Any) -> Any:
    """``to_numpy`` over every leaf of a pytree."""
    return jax.tree.map(to_numpy, tree)


def host_scalar(x) -> float:
    """Fetch a scalar jax value as a python number."""
    return np.asarray(x).item()
