"""Utilities: building and loading the CUDA kernels, the entry points'
device, the slot metrics, NaN debugging and profiling."""

from .debug import disable_nan_debugging, enable_nan_debugging, nan_debugging
from .metrics import SlotMetrics, summarize_slot
from .profiling import time_jitted, trace

__all__ = ["SlotMetrics", "summarize_slot", "time_jitted", "trace",
           "enable_nan_debugging", "disable_nan_debugging", "nan_debugging"]
