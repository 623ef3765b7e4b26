"""The port's legacy step against the JAX legacy step: the first four
uint8 views.

Inputs and tolerances: ``tests/_torch_legacy.py``.
"""

import pytest

from _torch_legacy import BOUNDS, runs, uint8_views


@pytest.mark.parametrize("field", list(BOUNDS)[:4])
def test_uint8_views(runs, field):
    uint8_views(runs, field)
