"""The wide_dense case of test_torch_partial.py's
test_partial_ops_on_dense_and_wide_levels, in a file of its own: it takes
most of that file's time, and the test runner (pytest-xdist, --dist
loadfile) hands whole files to its workers, so the two now run side by
side."""

import pytest

from test_torch_partial import partial_ops_on_dense_and_wide_levels


@pytest.mark.parametrize("name", ["wide_dense"])
def test_partial_ops_on_dense_and_wide_levels(name):
    partial_ops_on_dense_and_wide_levels(name)
