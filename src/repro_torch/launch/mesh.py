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
    return Mesh(_virtual_ids(dims), axes, resolve_device(device))


def _virtual_ids(dims: Sequence[int]) -> np.ndarray:
    dims: Tuple[int, ...] = tuple(int(d) for d in dims)
    if any(d < 1 for d in dims):
        raise ValueError(f"mesh dims must be >= 1, got {dims}")
    return np.arange(math.prod(dims), dtype=np.int64).reshape(dims)


def make_abstract_mesh(dims: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh on the ``meta`` device, which holds no data: the layout of
    state the dry run only counts, on a host with or without a card."""
    return Mesh(_virtual_ids(dims), axes, torch.device("meta"))


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device = "cuda") -> Mesh:
    """16x16 = 256 devices ``("data", "model")``; multi-pod 2x16x16 = 512
    with ``"pod"`` first (the reference's production mesh), on ``device``,
    or on ``meta`` (:func:`make_abstract_mesh`) where the caller asks for
    it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if torch.device(device).type == "meta":
        return make_abstract_mesh(shape, axes)
    return make_mesh(shape, axes, device)


def make_host_mesh(data: int = 1, model: int = 1, n_devices: int = 8,
                   device: torch.device = "cuda") -> Mesh:
    """A (data, model) mesh over ``n_devices`` virtual devices, each axis
    cut to what the devices allow."""
    data = min(data, n_devices)
    model = min(model, n_devices // data)
    return make_mesh((data, model), ("data", "model"), device)


# The roofline's rates, one NVIDIA H100 80GB HBM3 (SXM) at its 700.00 W
# power limit, from NVIDIA's H100 data sheet (dense, without sparsity).
#: bf16 tensor-core peak, FLOP/s a card
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, bytes/s a card
HBM_BW = 3.35e12
#: NVLink 4, one direction, bytes/s a card (900 GB/s both ways)
NVLINK_BW = 450e9
#: the card these rates are for
HW_NAME = "NVIDIA H100 80GB HBM3, 700.00 W"


def make_device_mesh(dims: Sequence[int], axes: Sequence[str],
                     device: torch.device = "cuda"):
    """A ``torch.distributed`` ``DeviceMesh`` of ``dims`` named ``axes``
    over the initialised process group, ranks laid out row-major, so rank
    ``r`` is virtual device ``r`` of :func:`make_mesh` of the same dims
    and owns the same region of every leaf. ``device`` is the card unless
    the caller asks for the CPU; every rank of a ``cuda`` mesh uses the
    card ``rank % device_count`` (all of them the one card of a one-card
    host). Raises unless a group is initialised and its world is
    ``prod(dims)``. A ``cuda`` mesh over a ``gloo`` group routes
    ``DTensor``'s collectives through gloo's own
    (:mod:`repro_torch.sharding.gloo_cuda`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.checkpoint import resolve_device
    dims = tuple(int(d) for d in dims)
    if len(dims) != len(tuple(axes)):
        raise ValueError(f"mesh of dims {dims} needs {len(dims)} axis "
                         f"names, got {tuple(axes)}")
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs an initialised process "
                           "group (repro_torch.launch.spmd)")
    world = dist.get_world_size()
    if world != math.prod(dims):
        raise ValueError(f"a mesh of dims {dims} needs a world of "
                         f"{math.prod(dims)} ranks, the group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        if dist.get_backend() == "gloo":
            from repro_torch.sharding import gloo_cuda
            gloo_cuda.install()
    return init_device_mesh(dev.type, dims, mesh_dim_names=tuple(axes))


def mesh_ranks(device_mesh) -> np.ndarray:
    """A ``DeviceMesh``'s grid of ranks, read with every dispatch mode
    set aside: the grid is a real tensor, which a fake-tensor mode (the
    dry run's trace) refuses and a counting mode would count."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        return np.asarray(device_mesh.mesh.tolist(), dtype=np.int64)


def virtual_mesh(device_mesh) -> Mesh:
    """The port's :class:`Mesh` of a ``DeviceMesh``: its ranks as virtual
    ids (row-major, as :func:`make_device_mesh` lays them out; another
    layout raises) on the ``meta`` device."""
    ranks = mesh_ranks(device_mesh)
    if not np.array_equal(ranks.reshape(-1), np.arange(ranks.size)):
        raise ValueError(f"device mesh ranks {ranks.tolist()} are not "
                         f"0 .. n-1 in row-major order")
    return Mesh(ranks, device_mesh.mesh_dim_names, torch.device("meta"))
