"""K3's weight table on the CPU.

The device weight table ``wtab`` (``sampling.weight_table``, one row per
``fy * 32 + fx``) equals ``float32(w1[fy, ty] * w1[fx, tx])`` of the
float64 taps, bit for bit, for every interpolation: the value K3 formed
per pixel from the float64 table before it read the float32 one, and
the value the plain version reads (``remap_window_plain`` equals
``remap_plain``: tests/test_torch_window.py).
"""

import numpy as np
import pytest
import torch

import transform360_tpu_torch as P
from transform360_tpu_torch.config import Interpolation, StereoFormat, TransformConfig
from transform360_tpu_torch.ops import window
from transform360_tpu_torch.sampling import INTER_TAB_SIZE, _TAPS, _tap_weights

MONO = dict(input_stereo_format=StereoFormat.MONO, output_stereo_format=StereoFormat.MONO)


@pytest.mark.parametrize("interp", list(Interpolation))
def test_weight_table_is_the_float64_products_rounded(interp):
    cfg = TransformConfig(interpolation_alg=interp, **MONO)
    pp = P.build_plan(cfg, 256, 128, 96, 64, "gray").luma
    wp = window.build_window_plan(pp.spec, pp.fill)
    T = _TAPS[interp]
    w1 = np.stack(_tap_weights(interp, np.arange(INTER_TAB_SIZE) / INTER_TAB_SIZE, np),
                  axis=1).astype(np.float64)
    assert w1.shape == (INTER_TAB_SIZE, T)
    want = np.empty((INTER_TAB_SIZE**2, T * T), np.float32)
    for fy in range(INTER_TAB_SIZE):
        for fx in range(INTER_TAB_SIZE):
            for ty in range(T):
                for tx in range(T):
                    want[fy * INTER_TAB_SIZE + fx, ty * T + tx] = np.float32(
                        w1[fy, ty] * w1[fx, tx])
    assert wp.wtab.dtype == np.float32 and wp.wtab.shape == want.shape
    assert np.array_equal(wp.wtab.view(np.uint32), want.view(np.uint32))
    wt = window.WindowTables.from_plan(wp, "cpu")
    assert torch.equal(wt.wtab.view(torch.int32), torch.from_numpy(want).view(torch.int32))
