"""Frozen, hashable decoder configurations.

Port of ``ft8_demodulator_tpu/config.py``: one NamedTuple of what the slot
decoder needs besides the signal, and the two presets.
"""

from __future__ import annotations

from typing import NamedTuple

from .ops.waterfall import WaterfallParams, waterfall_params

__all__ = ["DecoderConfig", "STANDARD", "DEEP_SEARCH", "WaterfallParams",
           "waterfall_params"]


class DecoderConfig(NamedTuple):
    """Everything the slot decoder needs besides the signal itself."""

    bins_per_tone: int = 2       # frequency oversampling
    steps_per_symbol: int = 2    # time oversampling
    max_candidates: int = 20     # fixed K for top-k selection
    min_score: float = 10.0      # sync-score acceptance threshold
    max_iterations: int = 20     # LDPC BP iterations
    use_osd: bool = False        # ordered-statistics decode after BP
    use_mf: bool = False         # matched-filter LLR retry after BP(+OSD)
    mf_first: bool = False       # decode ALL candidates from MF LLRs in one
                                 # pass (the boxcar-grid route)
    mf_refine: bool = False      # sub-grid (dt, df) offset search before MF
                                 # extraction
    coherent: bool = False       # coherent MF retry

    def waterfall(self, fs: float) -> WaterfallParams:
        return waterfall_params(fs, self.bins_per_tone,
                                self.steps_per_symbol)


# the reference's standard operating point
STANDARD = DecoderConfig()
# high-sensitivity preset
DEEP_SEARCH = DecoderConfig(bins_per_tone=4, steps_per_symbol=4,
                            max_candidates=40, min_score=1.0, use_osd=True,
                            use_mf=True)
