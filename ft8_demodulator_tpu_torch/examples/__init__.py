"""Runnable examples of the whole chain (``python -m
ft8_demodulator_tpu_torch.examples.<name>``)."""
