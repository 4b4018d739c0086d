"""Parallelism over torch.distributed ranks: device meshes, the sharded
stream (channels x stream blocks), the tensor-parallel slot (frequency
bands), the pipelined decode (two stages) and the composed (channel x
stream x freq) decode; ``launch.run_ranks`` starts the ranks."""

from .composed import (decode_stream_composed,
                       decode_stream_composed_sharded, make_composed_mesh)
from .mesh import make_freq_mesh, make_mesh, make_stage_mesh
from .pipeline import decode_slots_pipelined
from .streaming import decode_stream, decode_stream_sharded
from .tensor import decode_slot_tp

__all__ = ["make_mesh", "make_freq_mesh", "make_stage_mesh",
           "make_composed_mesh",
           "decode_stream", "decode_stream_sharded", "decode_slot_tp",
           "decode_slots_pipelined", "decode_stream_composed",
           "decode_stream_composed_sharded"]
