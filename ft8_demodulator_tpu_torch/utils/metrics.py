"""Structured per-slot decode metrics.

Copy of ``ft8_demodulator_tpu/utils/metrics.py`` (numpy only, same names):
the metrics are derived from a fixed-shape SlotDecodeResult after the fact.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

__all__ = ["SlotMetrics", "summarize_slot"]


@dataclass(frozen=True)
class SlotMetrics:
    candidates_found: int       # candidates above min_score
    decodes: int                # accepted (LDPC+CRC) candidates
    unique_messages: int        # distinct message hashes among decodes
    best_score: float
    mean_score: float
    mean_ldpc_errors: float     # over rejected candidates

    def asdict(self) -> dict:
        return asdict(self)


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def summarize_slot(result) -> SlotMetrics:
    """SlotDecodeResult (host or device arrays) -> SlotMetrics."""
    valid = _host(result.candidate_valid)
    success = _host(result.success)
    score = _host(result.score)
    ldpc = _host(result.ldpc_errors)
    crc = _host(result.crc)
    n_valid = int(valid.sum())
    rejected = valid & ~success
    return SlotMetrics(
        candidates_found=n_valid,
        decodes=int(success.sum()),
        unique_messages=len(set(crc[success].tolist())),
        best_score=float(score[valid].max()) if n_valid else float("-inf"),
        mean_score=float(score[valid].mean()) if n_valid else float("nan"),
        mean_ldpc_errors=float(ldpc[rejected].mean()) if rejected.any()
        else 0.0,
    )
