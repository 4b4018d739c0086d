"""The control (the plain reference one precision step below the stated
one, in the program's place) fails every cell's check, and the program
passes it: on the CPU at a test's size, and on the card at the cell's own
size (``cuda``: run on the chip with
``python -m pytest -m cuda port_bench/tests/test_port_bench_control.py``)."""

from __future__ import annotations

import pytest

from port_bench import compare, control, run
from conftest import TINY

CELLS = ["standard.busy", "deep.weak", "standard.station"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes_cpu(cell):
    limits = run.cell(cell)["limits"]
    ctrl = control.control_numbers(cell, 2 ** 31 + 23, "cpu", TINY[cell])
    assert not compare.within(ctrl, limits), ctrl
    prog = control.program_numbers(cell, 2 ** 31 + 29, 1, "cpu", TINY[cell])
    assert compare.within(prog, limits), prog


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes_card(cell, card):
    limits = run.cell(cell)["limits"]
    over = {"traffic": {"pool_batches": 1}}
    for seed in (2 ** 31 + 31, 2 ** 31 + 37, 2 ** 31 + 41):
        ctrl = control.control_numbers(cell, seed, card, over)
        assert not compare.within(ctrl, limits), ctrl
    calls = 8 if cell.endswith("station") else 1
    prog = control.program_numbers(cell, 2 ** 31 + 43, calls, card, over)
    assert compare.within(prog, limits), prog
