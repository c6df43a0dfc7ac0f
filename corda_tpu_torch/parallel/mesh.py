"""Mesh construction and batch sharding over torch devices.

Counterpart of corda_tpu/parallel/mesh.py. A `Mesh` holds its devices
in an array of the mesh's shape beside its axis names; the batch axis of
every verify operand splits over every mesh axis, in the order of
`devices.flat`, into contiguous slices of equal length, one per device
(`shard_operand`). There is no collective and no virtual device: a
caller who wants the CPU passes CPU devices such as
`torch.device("cpu", k)`, whose index keys the device ledger while the
tensors land on "cpu".
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

BATCH_AXIS = "batch"
DCN_AXIS = "dcn"
ICI_AXIS = "ici"


class Mesh:
    """`devices`: an object array of torch devices in the mesh's shape;
    `axis_names`: one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def device_list(self) -> list:
        """The devices in mesh order: the order their slices take."""
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def cuda_devices() -> list:
    """Every visible card as `torch.device("cuda", k)`; raises where
    there is none (the mesh never falls back to the CPU by itself)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "CUDA is not available: a mesh runs on the cards (pass CPU "
            "devices such as torch.device('cpu', k) to run on the CPU)"
        )
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _device_array(devices: Optional[Sequence]) -> np.ndarray:
    """The devices (default: every card) as a 1-D object array."""
    devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    arr = np.empty(len(devices), dtype=object)
    for k, d in enumerate(devices):
        arr[k] = d
    return arr


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh over every card (or the given devices)."""
    return Mesh(_device_array(devices), (BATCH_AXIS,))


def make_mesh_2d(dcn: int, ici: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D (dcn × ici) mesh: the leading axis spans host groups, the
    trailing axis each group's cards. The batch still splits over both
    axes with no collective; row-major order puts each group's cards,
    and so its rows, next to each other."""
    devices = _device_array(devices)
    if len(devices) != dcn * ici:
        raise ValueError(
            f"mesh {dcn}x{ici} needs {dcn * ici} devices, have {len(devices)}"
        )
    return Mesh(devices.reshape(dcn, ici), (DCN_AXIS, ICI_AXIS))


def batch_spec_axes(mesh: Mesh):
    """The mesh axes a batch dimension splits over: the bare axis name on
    a 1-D mesh, the tuple of every axis otherwise."""
    names = tuple(mesh.axis_names)
    return names[0] if len(names) == 1 else names


class BatchSharding:
    """How an operand of `ndim` dimensions splits over `mesh` along
    `batch_axis`; asks nothing of a device."""

    def __init__(self, mesh: Mesh, ndim: int, batch_axis: int = -1):
        self.mesh = mesh
        self.ndim = ndim
        self.axis = batch_axis % ndim

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        """The shape of each device's slice of an operand of `shape`."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != self.ndim:
            raise ValueError(f"shape {shape} is not {self.ndim}-D")
        per = self.rows_per_device(shape[self.axis])
        return shape[: self.axis] + (per,) + shape[self.axis + 1 :]

    def rows_per_device(self, rows: int) -> int:
        n = self.mesh.size
        if rows % n:
            raise ValueError(f"{rows} rows do not split evenly over {n} devices")
        return rows // n

    def row_ranges(self, rows: int) -> list:
        """[(start, stop)] of each device's rows, in mesh order."""
        per = self.rows_per_device(rows)
        return [(k * per, (k + 1) * per) for k in range(self.mesh.size)]


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = -1) -> BatchSharding:
    """The split `shard_operand` places operands with, also usable alone
    to ask how an operand would split (`shard_shape`) without moving it."""
    return BatchSharding(mesh, ndim, batch_axis)


def shard_operand(mesh: Mesh, x, batch_axis: int = -1) -> list:
    """`x` (numpy or torch) as one contiguous slice of its batch axis per
    device, in mesh order, each on its device."""
    t = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    sharding = batch_sharding(mesh, t.dim(), batch_axis)
    out = []
    for dev, (lo, hi) in zip(mesh.device_list(), sharding.row_ranges(t.shape[sharding.axis])):
        part = t.narrow(sharding.axis, lo, hi - lo).contiguous()
        out.append(part.to(dev) if dev.type == "cuda" else part.clone())
    return out
