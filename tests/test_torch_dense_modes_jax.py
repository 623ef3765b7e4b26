"""The first four dense Farneback modes (in name order) over three
frames against the JAX modes, both sides fed the JAX flows.

Inputs and tolerances: ``tests/_torch_dense_modes.py``.
"""

import pytest

from _torch_dense_modes import CARRY, mode_matches_jax_over_three_frames


@pytest.mark.parametrize("mode", sorted(CARRY)[:4])
def test_mode_matches_jax_over_three_frames(mode, monkeypatch):
    mode_matches_jax_over_three_frames(mode, monkeypatch)
