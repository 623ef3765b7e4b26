"""``detector_mask_scan`` against JAX's, and the ninth slice's modules
and factories (no jax import; the card by default).

Inputs and tolerances: ``tests/_torch_android.py``.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from ripcurrents_tpu.config import FarnebackParams as JaxParams
from ripcurrents_tpu.pipelines.common import (detector_mask_scan as
                                              jax_detector_mask_scan)
from ripcurrents_tpu_torch.config import FarnebackParams
from ripcurrents_tpu_torch.pipelines import android
from ripcurrents_tpu_torch.pipelines.common import (MODES, ModeConfig,
                                                    detector_mask_scan)

from _torch_android import (DETECTOR_SHARE, H, J, NEW_MODES, REPO, W,
                            _detector_grays, jfb)


def test_detector_mask_scan_matches_jax():
    """8 frames, warmup 2, legacy preset: the JAX scan as the TPU runs it
    (fused Pallas kernels in interpret mode) and the port's host loop;
    measured 99.97% of pixels equal, mask share 0.47."""
    grays = _detector_grays()
    mp = pytest.MonkeyPatch()
    mp.setattr(jfb, "_pallas_ok",
               functools.lru_cache(maxsize=1)(lambda: True))
    try:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(jax_detector_mask_scan(
                J(grays), JaxParams.legacy(), warmup=2))
    finally:
        mp.undo()
    got = detector_mask_scan(grays, FarnebackParams.legacy(), warmup=2,
                             device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (H, W)
    got = got.numpy()
    assert 0.05 < (got > 0).mean() < 0.95
    assert (got == want).mean() >= DETECTOR_SHARE, (got == want).mean()


def test_new_modules_import_without_jax():
    """The modules this slice adds import with jax and the JAX package
    blocked (None in sys.modules makes their import raise), and register
    their modes."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'ripcurrents_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import ripcurrents_tpu_torch.pipelines.android\n"
        "import ripcurrents_tpu_torch.analysis.motion\n"
        "import ripcurrents_tpu_torch.flow.phasecorr\n"
        "import ripcurrents_tpu_torch.ops.warp\n"
        "import ripcurrents_tpu_torch.synthetic\n"
        "from ripcurrents_tpu_torch.pipelines import runner\n"
        "print(' '.join(sorted(runner.MODES)))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert set(NEW_MODES) <= set(r.stdout.split())


def test_new_factories_default_to_the_card():
    """make_android and the five new factories take device="cuda" by
    default, which raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    for mode in NEW_MODES:
        with pytest.raises(RuntimeError):
            MODES[mode](ModeConfig(xdim=W, ydim=H))
    with pytest.raises(RuntimeError):
        android.make_android(ModeConfig(xdim=W, ydim=H))
    with pytest.raises(RuntimeError):
        detector_mask_scan(_detector_grays(2), FarnebackParams.legacy())
