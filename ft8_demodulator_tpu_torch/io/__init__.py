"""Host I/O: WAV files and the SDR adapter seam."""

from .wav import read_wave_file, write_wave_file

__all__ = ["read_wave_file", "write_wave_file"]
