"""The port's stream and engine against the JAX fused path (Pallas in
interpret mode), for each stream preset.

Inputs and tolerances: ``tests/_torch_farneback.py``.
"""

from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.convert import expansions_from_numpy
from ripcurrents_tpu_torch.flow import farneback as tfb

from _torch_farneback import H, STREAM_BOUNDS, W, _flow_dev, tpu_stream


def test_stream_matches_tpu_fused_path(tpu_stream):
    """farneback_stream end to end against the JAX engine as the TPU runs
    it. The new frame's tables differ by one-ULP bf16 flips (mean < 1e-5),
    which the chaotic winsize-3 legacy preset amplifies at a few pixels.
    Measured at 192x256: legacy median 1.2e-7 / mean 0.0018 px with 0.22%
    of pixels above 0.1 px; windowed 3.6e-7 / 0.0010 px with 0.004%."""
    preset, want, _, got, nxt = tpu_stream
    assert got.shape == (H, W, 2) and len(nxt) == 3
    med, mean, frac = _flow_dev(got.numpy(), want)
    bounds = STREAM_BOUNDS[preset]
    assert med < bounds[0] and mean < bounds[1] and frac < bounds[2], \
        (med, mean, frac)


def test_engine_matches_tpu_fused_path(tpu_stream):
    """From the same expansion tables (the JAX ones of both frames) the
    port's pyramid loop agrees with the TPU's fused engine. Measured at
    192x256: median <= 1.2e-7 px, mean <= 2.1e-5 px, nothing above
    0.1 px."""
    preset, want, (e0, e1), _, _ = tpu_stream
    same = tfb.farneback_from_expansions(
        expansions_from_numpy(e0), expansions_from_numpy(e1), (H, W),
        getattr(FarnebackParams, preset)())
    med, mean, frac = _flow_dev(same.numpy(), want)
    assert med < 1e-4 and mean < 1e-4 and frac == 0.0, (med, mean, frac)
