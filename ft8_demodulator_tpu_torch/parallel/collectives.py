"""The collectives of the parallel decodes, along one mesh dimension.

The JAX package writes them inside ``shard_map`` (``ppermute``, ``psum``);
here they are ``torch.distributed`` calls on the group of one dimension of
a ``DeviceMesh`` (``mesh.py axis``).  A collective over several dimensions
runs along each in turn.  With ``mesh`` None (one rank, no group) each is
the identity, and the halo is zeros.

* :func:`shift_left`: rank i receives rank i+1's tensor, the last rank
  zeros (``streaming.py:174-177``, ``composed.py:145-148``);
* :func:`gather`: every rank's tensor in mesh order, by
  ``all_gather_into_tensor``.  It replaces JAX's disjoint scatter +
  ``psum`` (``streaming.py:206-214``, ``tensor.py:89-93``), which exists
  for ``shard_map``'s replication checker;
* :func:`all_sum`: ``all_reduce`` (``tensor.py:106-109``, the yield
  counter);
* :func:`broadcast` from one coordinate, and :func:`isend` / :func:`recv`
  between two (the pipeline).

gloo's send, recv and all_gather take host tensors only (PyTorch's backend
table), so under gloo a CUDA tensor is copied to the host and the result
back to its device: gloo's contract, not a fallback.  The decode stays on
the card; only these packets cross.  Under NCCL tensors stay on the card.

Decode results travel as one int32 tensor (:func:`pack_result`): the
integers as integers, the score's float32 bits as int32, so that a gather
is one collective and exact (no float32 round trip, ``pipeline.py:125``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..demod.types import SlotDecodeResult
from ..protocol import constants as C
from .mesh import axis

__all__ = ["shift_left", "gather", "all_sum", "broadcast", "isend", "recv",
           "pack_result", "unpack_result", "RESULT_COLS"]

# packed result columns: success, crc, crc_extracted, ldpc_errors,
# abs_time, abs_freq, score bits, candidate_valid, 10 payload bytes
RESULT_COLS = 8 + C.PAYLOAD_BYTES


def _on_host(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _send_buf(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    return x.cpu() if _on_host(group) else x


def _recv_buf(like: torch.Tensor, shape, group) -> torch.Tensor:
    device = "cpu" if _on_host(group) else like.device
    return torch.empty(shape, dtype=like.dtype, device=device)


def shift_left(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Along ``name``: coordinate i receives coordinate i+1's ``x``, the
    last coordinate zeros (one ``batch_isend_irecv`` per rank)."""
    group, i, n = axis(mesh, name)
    out = torch.zeros_like(x)
    if group is None or n == 1:
        return out
    ops = []
    if i > 0:
        ops.append(dist.P2POp(dist.isend, _send_buf(x, group),
                              dist.get_global_rank(group, i - 1), group))
    if i < n - 1:
        buf = _recv_buf(x, x.shape, group)
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, i + 1), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if i < n - 1:
        out = buf.to(x.device)
    return out


def gather(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Every coordinate's ``x`` (at least 1-D) along ``name``, stacked in
    mesh order: (n, *x.shape) on the device of ``x``."""
    group, _, n = axis(mesh, name)
    if group is None:
        return x[None]
    out = _recv_buf(x, (n * x.shape[0], *x.shape[1:]), group)
    dist.all_gather_into_tensor(out, _send_buf(x, group), group=group)
    return out.reshape(n, *x.shape).to(x.device)


def all_sum(x: torch.Tensor, mesh, names: tuple[str, ...]) -> torch.Tensor:
    """The sum of ``x`` over the mesh dimensions ``names``."""
    for name in names:
        group, _, _ = axis(mesh, name)
        if group is None:
            continue
        buf = _send_buf(x, group).clone()
        dist.all_reduce(buf, group=group)
        x = buf.to(x.device)
    return x


def broadcast(x: torch.Tensor, mesh, name: str, src: int) -> torch.Tensor:
    """Coordinate ``src``'s ``x`` along ``name`` on every coordinate (``x``
    gives the shape and dtype elsewhere)."""
    group, _, _ = axis(mesh, name)
    if group is None:
        return x
    buf = _send_buf(x, group).clone()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(x.device)


def isend(x: torch.Tensor, mesh, name: str, dst: int):
    """Send ``x`` to coordinate ``dst`` along ``name`` without waiting;
    returns a function that waits for the send (and keeps its buffer
    alive until then)."""
    group, _, _ = axis(mesh, name)
    buf = _send_buf(x, group)
    work = dist.isend(buf, dist.get_global_rank(group, dst), group=group)

    def wait(buf=buf):
        work.wait()
    return wait


def recv(like: torch.Tensor, mesh, name: str, src: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from coordinate
    ``src`` along ``name``, onto ``like``'s device."""
    group, _, _ = axis(mesh, name)
    buf = _recv_buf(like, like.shape, group)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def pack_result(res: SlotDecodeResult) -> torch.Tensor:
    """(..., K) SlotDecodeResult -> (..., K, RESULT_COLS) int32."""
    i32 = lambda t: t.to(torch.int32)
    cols = [i32(res.success), i32(res.crc), i32(res.crc_extracted),
            i32(res.ldpc_errors), i32(res.abs_time), i32(res.abs_freq),
            res.score.to(torch.float32).view(torch.int32),
            i32(res.candidate_valid)]
    return torch.cat([torch.stack(cols, dim=-1), i32(res.payload)], dim=-1)


def unpack_result(packed: torch.Tensor) -> SlotDecodeResult:
    """The inverse of :func:`pack_result`."""
    col = lambda j: packed[..., j].contiguous()
    return SlotDecodeResult(
        success=col(0).bool(), payload=packed[..., 8:].to(torch.uint8),
        crc=col(1), crc_extracted=col(2), ldpc_errors=col(3),
        abs_time=col(4), abs_freq=col(5), score=col(6).view(torch.float32),
        candidate_valid=col(7).bool())
