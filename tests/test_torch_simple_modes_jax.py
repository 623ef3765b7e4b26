"""The first four simple modes (in name order) over three steps
against the JAX modes.

Inputs and tolerances: ``tests/_torch_simple_modes.py``.
"""

import pytest

from _torch_simple_modes import CARRY, mode_matches_jax_over_three_steps


@pytest.mark.parametrize("mode", sorted(CARRY)[:4])
def test_mode_matches_jax_over_three_steps(mode):
    mode_matches_jax_over_three_steps(mode)
