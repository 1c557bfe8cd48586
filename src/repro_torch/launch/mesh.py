"""Device meshes for sharded state: a grid of virtual device ids.

The JAX package lays state out on a ``jax.sharding.Mesh`` of devices; on
one host its tests force several CPU devices into one process
(``--xla_force_host_platform_device_count=8``). The port's :class:`Mesh`
is the counterpart: a numpy grid of *virtual device ids* ``0 .. n-1``,
the axis names, and the one ``torch.device`` every id lives on (the card,
or the CPU when the caller asks for it). Ids are laid out in row-major
order, as ``jax.make_mesh`` lays out a host's devices, so a shard's
owning id is the same number in both packages.

Defined as functions, so importing this module touches no device.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: an int array of virtual device ids, one axis a name of
    ``axis_names``; ``device``: where every id's shards live."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        devices = np.asarray(devices, dtype=np.int64)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        if sorted(devices.reshape(-1).tolist()) != list(range(devices.size)):
            raise ValueError("mesh device ids must be 0 .. n-1, each once")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # the card a tensor made "on cuda" lands on, so shards compare
            # equal to it
            device = torch.device("cuda", torch.cuda.current_device())
        self.devices = devices
        self.axis_names = axis_names
        self.device = device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self, device_id: int) -> Dict[str, int]:
        """Axis name -> position of ``device_id`` along that axis."""
        pos = np.argwhere(self.devices == device_id)[0]
        return dict(zip(self.axis_names, (int(p) for p in pos)))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) \
            and self.axis_names == other.axis_names \
            and self.device == other.device \
            and np.array_equal(self.devices, other.devices)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({dims}, device={self.device})"


def make_mesh(dims: Sequence[int], axes: Sequence[str],
              device: torch.device = "cuda") -> Mesh:
    """``jax.make_mesh``'s counterpart: ``prod(dims)`` virtual devices in
    row-major order on ``device`` (the card unless the caller asks for the
    CPU; a card that is not there raises)."""
    from repro_torch.core.checkpoint import resolve_device

    dims: Tuple[int, ...] = tuple(int(d) for d in dims)
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh dims must be >= 1, got {dims}")
    ids = np.arange(math.prod(dims), dtype=np.int64).reshape(dims)
    return Mesh(ids, axes, resolve_device(device))


def make_host_mesh(data: int = 1, model: int = 1, n_devices: int = 8,
                   device: torch.device = "cuda") -> Mesh:
    """A (data, model) mesh over ``n_devices`` virtual devices, each axis
    cut to what the devices allow."""
    data = min(data, n_devices)
    model = min(model, n_devices // data)
    return make_mesh((data, model), ("data", "model"), device)
