"""chip_smoke.py's kernel counting on synthetic profiler rows where the
profiler has dropped records: a kernel may miss one record over several
calls and still count its launches per call, but a kernel that ran on only
some of the calls raises."""
import pytest

import chip_smoke as cs


@pytest.mark.parametrize("rows,launches", [
    ([(500.0, 5.0, "ssd")], {"ssd": 1}),
    ([(400.0, 4.0, "ssd"), (40.0, 9.0, "fill")], {"ssd": 1, "fill": 2}),
    ([(400.0, 4.0, "ssd"), (40.0, 10.0, "fill")], {"ssd": 1, "fill": 2}),
    ([], {}),
])
def test_launches_of_rounds_away_dropped_records(rows, launches):
    assert cs.launches_of(rows, 5) == launches


@pytest.mark.parametrize("rows", [
    [(500.0, 5.0, "ssd"), (3.0, 1.0, "stray")],
    [(500.0, 5.0, "ssd"), (6.0, 2.0, "stray")],
    [(300.0, 3.0, "ssd")],
    [(600.0, 6.0, "ssd")],
])
def test_launches_of_refuses_kernels_of_some_calls(rows):
    with pytest.raises(AssertionError, match="times in 5 calls"):
        cs.launches_of(rows, 5)
