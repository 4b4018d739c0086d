"""NaN debugging: fail loudly at the first NaN a decode stage produces.

Port of ``ft8_demodulator_tpu/utils/debug.py``.  The JAX package turns on
``jax_debug_nans``, which re-runs a jitted stage op by op and raises at
the first primitive that produced a NaN.  Here a
``torch.overrides.TorchFunctionMode`` checks the floating (and complex)
tensors each torch call returns and raises ``FloatingPointError`` naming
the call.  Every check reads its result, so on the card each call
synchronises: a debugging mode, not a production one.

A hand kernel's output (``ops/*_cuda.py``) is written outside torch, so
it is checked by the first torch call that reads it; the uninitialised
buffers of ``torch.empty`` and its kin are not checked.  The mode is
entered in the calling thread.

Exposed three ways:

* env var ``FT8_DEBUG_NANS=1`` (checked at package import),
* :func:`enable_nan_debugging` / :func:`disable_nan_debugging` and the
  :func:`nan_debugging` context manager,
* the CLI flag ``--debug-nans``.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["enable_nan_debugging", "disable_nan_debugging", "nan_debugging",
           "nan_debugging_enabled", "init_from_env"]

# factory calls whose result is uninitialised memory until written
_UNCHECKED = {"empty", "empty_like", "new_empty", "empty_strided",
              "new_empty_strided"}


def _name(func) -> str:
    return getattr(func, "__qualname__", None) or getattr(
        func, "__name__", repr(func))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _NanCheckMode(TorchFunctionMode):
    """Raise at the first torch call that returns a NaN."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "__name__", "") in _UNCHECKED:
            return out
        for t in _tensors(out):
            if (t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN produced by torch call {_name(func)} "
                    f"(output shape {tuple(t.shape)}, {t.dtype}, {t.device})")
        return out


_mode: _NanCheckMode | None = None


def enable_nan_debugging() -> None:
    """Fail loudly at the first NaN any torch call produces."""
    global _mode
    if _mode is None:
        _mode = _NanCheckMode()
        _mode.__enter__()


def disable_nan_debugging() -> None:
    global _mode
    if _mode is not None:
        _mode.__exit__(None, None, None)
        _mode = None


def nan_debugging_enabled() -> bool:
    return _mode is not None


@contextlib.contextmanager
def nan_debugging():
    """Context manager: NaN checking on inside, restored state outside."""
    prev = nan_debugging_enabled()
    enable_nan_debugging()
    try:
        yield
    finally:
        if not prev:
            disable_nan_debugging()


def init_from_env() -> bool:
    """Enable NaN debugging if FT8_DEBUG_NANS is set truthy; returns state."""
    if os.environ.get("FT8_DEBUG_NANS", "").strip() not in ("", "0", "false"):
        enable_nan_debugging()
        return True
    return False
