"""Utilities: building and loading the CUDA kernels, the entry points'
device, the slot metrics, NaN debugging and profiling."""
