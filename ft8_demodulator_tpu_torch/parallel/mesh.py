"""Device meshes over the ranks of a torch.distributed group.

Port of ``ft8_demodulator_tpu/parallel/mesh.py``.  Axis conventions:

* ``stream`` — contiguous time segments of one long audio stream
  (sequence parallelism with overlap-save halos),
* ``channel`` — independent audio channels / receivers (data parallelism),
* ``freq`` — one slot's frequency grid in bands (tensor parallelism),
* ``stage`` — the two halves of the decode (pipeline parallelism).

A mesh takes the first ``need`` ranks of the default group, row-major, as
the JAX mesh takes the first ``need`` devices, and returns a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX axis names.  One
rank is one device: ``parallel/launch.py run_ranks`` starts the ranks
(NCCL, one rank a card; gloo for CPU ranks or ranks sharing a card).
Building a mesh creates its sub-groups, which is collective: every rank of
the default group calls it, also a rank that falls outside the mesh; that
rank's ``get_coordinate()`` is None, and the entry points return None on
it.  Not ported: the re-exports ``P`` and ``NamedSharding`` (JAX sharding
specs; the port slices its shards by mesh coordinate).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.device import entry_device

__all__ = ["make_mesh", "make_freq_mesh", "make_stage_mesh", "axis"]


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(sizes: tuple[int, ...], names: tuple[str, ...], device,
          what: str) -> DeviceMesh:
    """A mesh of the first prod(sizes) ranks (``mesh.py:24-53``)."""
    need = math.prod(sizes)
    have = _world_size()
    if need > have:
        raise ValueError(f"{what} needs {need} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what}: no torch.distributed group is initialised (start the "
            "ranks with parallel.launch.run_ranks, or pass mesh=None to "
            "decode on this process alone)")
    return DeviceMesh(entry_device(device).type,
                      torch.arange(need).reshape(sizes),
                      mesh_dim_names=names)


def make_mesh(stream: int = 1, channel: int = 1,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """A (channel, stream) mesh of ranks on ``device`` (``mesh.py:24``)."""
    return _mesh((channel, stream), ("channel", "stream"), device,
                 f"mesh {channel}x{stream}")


def make_stage_mesh(stages: int = 2,
                    device: str | torch.device = "cuda") -> DeviceMesh:
    """1-D ``stage`` mesh for the pipelined decode (``mesh.py:37``)."""
    return _mesh((stages,), ("stage",), device, "stage mesh")


def make_freq_mesh(freq: int,
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """1-D ``freq`` mesh for the tensor-parallel slot decode
    (``mesh.py:46``): the slot's frequency grid is split over it."""
    return _mesh((freq,), ("freq",), device, "freq mesh")


def axis(mesh: DeviceMesh | None, name: str):
    """(group, index, size) of this rank along the mesh dimension ``name``.

    ``mesh`` None is one rank with no collective: (None, 0, 1).  On a rank
    outside ``mesh`` the index is None.  A group's ranks are in mesh order
    (``new_group`` sorts them, and a row-major mesh numbers them in
    order), so a collective's i-th slot is coordinate i.
    """
    if mesh is None:
        return None, 0, 1
    dim = mesh.mesh_dim_names.index(name)
    coord = mesh.get_coordinate()
    if coord is None:
        return None, None, mesh.size(dim)
    return mesh.get_group(name), coord[dim], mesh.size(dim)
