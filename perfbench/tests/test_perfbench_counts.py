"""The yardstick's arithmetic: FLOPs of the reference at the published
widths, and the kernels' bound bytes at the shapes of the port's kernel
table (``PERF.md``)."""
from __future__ import annotations

import json

import pytest

from perfbench import flops, roofline
from perfbench.tests.conftest import ROOT

CNN = json.loads((ROOT / "perfbench/configs/eamm-cnn.json").read_text())


def conv(h, w, cin, cout, k):
    """Operations of a k x k convolution at h x w output (2 a
    multiply-add)."""
    return 2 * h * w * cin * cout * k * k


def test_render_per_frame_at_published_widths():
    """The decode's count is the layers' own: six bottleneck ResBlocks
    (58.0 GFLOP a frame), two UpBlocks (19.3), the final 7x7 conv, the
    warped features and dense motion.  The whole render at a 32-frame clip
    reads 89.01 GFLOP a frame: the port's own count, 91.3, adds the extra
    operations of its folded eval forms (a stride-4 final conv over a
    phase-expanded kernel, the dense-motion heads as one conv_s2d), which
    are not the model's work."""
    res = 12 * conv(64, 64, 256, 256, 3)
    ups = conv(128, 128, 256, 128, 3) + conv(256, 256, 128, 64, 3)
    assert res / 1e9 == pytest.approx(58.0, rel=1e-3)
    assert ups / 1e9 == pytest.approx(19.3, rel=3e-3)
    per_clip, per_frame = flops.render_line(CNN)
    total32 = flops.render(CNN, 32)
    assert total32 == pytest.approx(per_clip + 32 * per_frame, rel=1e-9)
    assert total32 / 32 / 1e9 == pytest.approx(89.01, rel=1e-3)
    final = conv(256, 256, 64, 3, 7)
    assert per_frame > res + ups + final


def test_train_step_counts_forward_and_backward():
    tp = json.loads((ROOT / "perfbench/workloads/cnn-finetune-train.json")
                    .read_text())["train_params"]
    step = flops.train_step(CNN, tp, 6, 16)
    assert 11.0e12 < step < 13.0e12


@pytest.mark.parametrize("what,args,ms", [
    ("K1", (roofline.warp_forward, [[1, 64, 64, 256], [32, 64, 64, 2]],
            ["c10::BFloat16", "c10::BFloat16"]), 0.0208),
    ("K1b", (lambda s, d: roofline.warp_backward(s, d, True, True),
             [[24, 64, 64, 256], [24, 64, 64, 256], [24, 64, 64, 2]],
             ["float", "float", "float"]), 0.0906),
    ("K3b", (roofline.kp_expectation_backward,
             [[96, 10, 58, 58], [96, 10, 4, 58, 58], [], [96, 10, 2],
              [96, 10, 2, 2]], ["float", "float", "Scalar", "float",
                                "float"]), 0.0386),
])
def test_bounds_match_the_kernel_table(what, args, ms):
    fn, shapes, dtypes = args
    assert fn(shapes, dtypes) * 1e3 == pytest.approx(ms, rel=5e-3)
