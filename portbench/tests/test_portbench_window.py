"""The window's arithmetic."""

import numpy as np
import pytest

from harness import window


@pytest.mark.parametrize("n", [1, 2, 7, 20, 241])
def test_percentile_is_numpys_over_all_values(n):
    xs = np.random.default_rng(n).exponential(size=n)
    for q in (0, 50, 95, 100):
        assert window.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_percentile_takes_every_pass_not_chunks():
    # three slow passes in 40, all in the last quarter: the 95th percentile
    # of all passes sees them, a median of four chunks' would not
    xs = [0.05] * 37 + [0.5] * 3
    assert window.percentile(xs, 95) == pytest.approx(0.5)


def test_end_to_end():
    got = window.end_to_end([0.1] * 30 + [0.2] * 10, 4.5, 1280 * 720 * 4, 12.5)
    assert got["msamples_per_s"] == pytest.approx(40 * 1280 * 720 * 4 / 4.5 / 1e6)
    assert got["pass_p95_ms"] == pytest.approx(200.0)
    assert got["setup_s"] == 12.5


def test_no_passes_is_an_error():
    with pytest.raises(ValueError):
        window.percentile([], 95)
