"""The benchmark of ft8_demodulator_tpu_torch on one H100: see README.md."""
