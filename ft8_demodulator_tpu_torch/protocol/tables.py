"""The protocol's tables on a device, each copied there once.

Every read of a raw table of ``protocol/constants.py`` on a device goes
through :func:`device_table`; the tables that ``ops/`` derives from them
(the BP routing, the OSD basis, the LLR index sets) are cached per device
in the module that derives them.  No call copies a constant from host
memory, so no decode waits for one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import constants as C


@functools.lru_cache(maxsize=None)
def device_table(name: str, device: torch.device,
                 dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """The table ``C.<name>`` as a ``dtype`` tensor on ``device``, built
    once per (name, device, dtype)."""
    return torch.as_tensor(np.asarray(getattr(C, name)), dtype=dtype,
                           device=device)
