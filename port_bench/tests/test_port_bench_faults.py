"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the look for a card
skipped, a tiny pool, a window of one call) with one fault planted in the
program: half of the batch left out (in the host API, which takes one
capture, half of the candidate rows), and every answer altered where it is
produced (a payload bit flipped as ``finish_decode`` packs it).  The same
run without a fault is correct.  A decode carries no state from call to
call and runs on one card, so the other faults of the contract (a state
returned unchanged, an exchange between cards left out) have no place in
these cells."""

from __future__ import annotations

import pytest
import torch

from port_bench import run
from conftest import TINY

CELLS = ["standard.busy", "deep.weak", "standard.station"]


def _half_batch(monkeypatch, cell):
    from ft8_demodulator_tpu_torch.demod import decode as prog

    slots, finish = prog.decode_slots, prog.finish_decode

    def left_out(waves, *a, **kw):
        res = slots(waves, *a, **kw)
        keep = torch.arange(waves.shape[0]) < waves.shape[0] // 2
        none = ~keep.to(res.success.device)[:, None]
        return res._replace(success=res.success & ~none,
                            candidate_valid=res.candidate_valid & ~none)

    def rows_left_out(llrs, *a, **kw):
        res = finish(llrs, *a, **kw)
        keep = torch.arange(res.success.shape[-1]) < res.success.shape[-1] // 2
        return res._replace(success=res.success & keep.to(res.success.device))

    if cell.endswith("station"):
        monkeypatch.setattr(prog, "finish_decode", rows_left_out)
    else:
        monkeypatch.setattr(prog, "decode_slots", left_out)


def _altered(monkeypatch):
    from ft8_demodulator_tpu_torch.demod import decode as prog

    finish = prog.finish_decode

    def altered(*a, **kw):
        res = finish(*a, **kw)
        return res._replace(payload=res.payload ^ torch.tensor(
            [0x80] + [0] * 9, dtype=torch.uint8, device=res.payload.device))

    monkeypatch.setattr(prog, "finish_decode", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "half_batch", "altered"])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "half_batch":
        _half_batch(monkeypatch, cell)
    elif fault == "altered":
        _altered(monkeypatch)
    out = run.run(cell, 2 ** 31 + 17, 0.0, False, device="cpu",
                  overrides=TINY[cell])
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checks"]
