"""Entry ``slots``: the program's batch entry, ``decode_slots``.

Set-up makes the traffic's pool of batches on the device; a call decodes
the next batch of the pool and reads each slot's success mask and payloads
back to the host, as a skimmer would.  The whole result of every call stays
on the device until the window closes; then a sample of slots drawn from the
seed is decoded again by the plain reference and compared
(``compare.compare_slots``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bounds, compare, generator
from ..reference import decode as ref_decode
from ..reference import front

__all__ = ["Entry"]


class Entry:
    """One cell's ``decode_slots`` traffic, calls and check."""

    reference_precision_key = "decode_slots"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from ft8_demodulator_tpu_torch.demod import decode as prog
        from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fs = float(traffic["fs"])
        self.pool, _ = generator.make_slots(
            traffic, seed, int(traffic["pool_batches"]), device)
        n = self.pool[0].shape[-1]
        p = waterfall_params(self.fs, cfg["bins_per_tone"],
                             cfg["steps_per_symbol"])
        run = cfg["decode_slots"]
        self.mf_first = bool(run["mf_first"])
        self.chunk = min(int(run["chunk"]), self.pool[0].shape[0])
        self.kwargs = dict(
            p=p, num_frames=p.num_frames(n),
            max_candidates=cfg["max_candidates"],
            min_score=float(cfg["min_score"]),
            max_iterations=cfg["max_iterations"], use_osd=cfg["use_osd"],
            mf_first=self.mf_first, chunk=self.chunk,
            bp_chunk=int(run["bp_chunk"]))
        self.decode_slots = prog.decode_slots
        self.units_per_call = self.pool[0].shape[0]
        self.results: list = []

    def warm(self) -> None:
        """One call on every batch of the pool (every shape and every
        allocation size the window meets), not kept."""
        for x in self.pool:
            res = self.decode_slots(x, **self.kwargs)
            res.success.cpu()
            res.payload.cpu()

    def call(self, i: int) -> int:
        res = self.decode_slots(self.pool[i % len(self.pool)], **self.kwargs)
        res.success.cpu()
        res.payload.cpu()
        self.results.append(res)
        return self.units_per_call

    def kernel_bounds(self) -> dict[str, bounds.Bound]:
        """Each hand kernel's least time per launch at this cell's shapes."""
        rp = front.geometry(self.fs, self.cfg["bins_per_tone"],
                            self.cfg["steps_per_symbol"])
        n = self.pool[0].shape[-1]
        nf = rp.num_frames(n)
        g = front.search_grid(rp.num_freq_bins, nf, rp.time_osr,
                              rp.freq_osr)
        key = "k3" if self.mf_first else "k1"
        return {key: bounds.waterfall(rp, self.chunk, n, self.mf_first),
                "k5": bounds.sync(g, self.chunk, nf, rp.num_freq_bins)}

    def sample(self, seed: int) -> list[tuple[int, int]]:
        """(call, slot) pairs of the window's calls, drawn from the seed."""
        total = len(self.results) * self.units_per_call
        rng = np.random.default_rng([seed, 1])
        picks = np.sort(rng.choice(total, min(int(self.traffic["sample"]),
                                              total), replace=False))
        return [(int(k) // self.units_per_call, int(k) % self.units_per_call)
                for k in picks]

    def program_outputs(self, picks) -> dict:
        parts = [compare.slot_fields(self.results[c], torch.tensor([s]))
                 for c, s in picks]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    def reference_outputs(self, picks, precision: str, dtype=torch.float32):
        waves = torch.stack([self.pool[c % len(self.pool)][s]
                             for c, s in picks])
        with ref_decode.exact_float32():
            return ref_decode.decode_slots(waves, self.fs, self.cfg,
                                           self.mf_first, precision, dtype)

    def free(self) -> None:
        """Drop the program's results once the sample has been read."""
        self.results.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def check(self, seed: int, limits: dict, precision: str) -> dict:
        """The compared numbers on the seed's sample of the window."""
        picks = self.sample(seed)
        prog = self.program_outputs(picks)
        self.free()
        ref = self.reference_outputs(picks, precision)
        return compare.compare_slots(prog, ref, limits["score_gap"],
                                     float(self.cfg["min_score"]))
