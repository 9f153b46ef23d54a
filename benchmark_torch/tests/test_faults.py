"""The check, with the timed path broken underneath: each fault a cell
can have makes a run's ``correct`` false, on each engine; the control
(the reference a precision step down in the program's place) fails the
limits that the program meets."""

from __future__ import annotations

import pytest

from benchmark_torch import check, faults, spec


@pytest.mark.parametrize("cell", ["tiny-mega", "tiny-big"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_makes_the_run_incorrect(tiny_root, run_line, cell,
                                                 fault):
    entry = spec.load_cell(tiny_root, cell).cell["entry"]
    with faults.planted(entry, fault):
        res = run_line(tiny_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["tiny-mega", "tiny-big"])
def test_the_control_fails_the_limits_the_program_meets(tiny_root, cell):
    c = spec.load_cell(tiny_root, cell)
    kind, seed = spec.kind(tiny_root, c), 2 ** 31 + 11
    prog = kind.setup(c, seed, "cpu")
    ids = kind.checked(c, prog["text"], seed, "cpu")
    img = kind.values(prog["render"](1, {}), ids)
    ref = kind.reference_values(c, prog["text"], seed, [1], ids, "cpu")
    ctl = kind.reference_values(c, prog["text"], seed, [1], ids, "cpu",
                                check.CONTROL[c.config["precision"]])
    limits = c.cell["limits"]
    sound, checks = check.judge(check.agreement(img, ref), limits)
    assert sound, checks
    control, checks = check.judge(check.agreement(ctl, ref), limits)
    assert not control, checks
