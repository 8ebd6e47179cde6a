"""On the card: a short run of each cell at its own size comes out
correct, and the control does not (the run's own comparison)."""

import pytest

from tinycell import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["myself.pairs", "dome32.pairs", "myself.takes"])
def test_cell_and_control(card, workload):
    from portbench import run
    line = run.run_cell(workload, 2**31 + 77, 1.0, False, root=REPO)
    assert line["correct"] is True, line["check"]
    line = run.run_cell(workload, 2**31 + 77, 1.0, False, control="bfloat16", root=REPO)
    assert line["correct"] is False, line["check"]
