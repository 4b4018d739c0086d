"""The benchmark's plain reference: a frozen FT8 transmitter (``tx``), the
protocol's tables (``constants``) and a plain PyTorch decoder (``front``,
``ldpc``, ``decode``) that imports nothing of the program under test."""
