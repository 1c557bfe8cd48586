"""Carry state between the JAX package's numpy form and the port's tensors.

numpy has no ``bfloat16`` without ``ml_dtypes`` (absent on the card's
host), so bfloat16 crosses as its 16-bit pattern: an array whose dtype is
named ``"bfloat16"`` is viewed as ``uint16`` and the tensor made with
``.view(torch.bfloat16)``; the other way, a bfloat16 tensor comes back as
``uint16`` storage. Bytes never change in either direction.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core import dtypes
from .core.tree import map_leaves


def array_to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    entry = dtypes.of_array(a)
    flat = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    t = torch.from_numpy(flat.copy()).view(entry.torch).reshape(a.shape)
    return t.to(device)


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    entry = dtypes.of_tensor(t)
    b = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return b.numpy().copy().view(entry.storage).reshape(tuple(t.shape))


def from_numpy_state(tree: Any, device: torch.device) -> Any:
    """Every numpy array leaf of ``tree`` as a tensor on ``device`` (the
    caller names it: ``"cuda"`` for the card, ``"cpu"`` only when asked
    for); other leaves unchanged."""
    return map_leaves(lambda x: array_to_tensor(x, device)
                      if isinstance(x, np.ndarray) else x, tree)


def to_numpy_state(tree: Any) -> Any:
    """Every tensor leaf of ``tree`` as a host numpy array (bfloat16 as
    ``uint16`` storage); other leaves unchanged."""
    return map_leaves(lambda x: tensor_to_array(x)
                      if isinstance(x, torch.Tensor) else x, tree)
