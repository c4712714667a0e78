"""The port's eval metrics (``vwfd_tpu_torch.metrics``, plain path on the
CPU) against ``vwfd_tpu.metrics`` on the same seeded numpy inputs.

Tolerances: the confusion counts, the F1 sweep and ``mask_scores`` are
exact (integer counts below 2²⁴ pixels are exact in JAX's float32 sums too,
and the float32 formulas run in the same order); SSIM within 1e-6 (the same
121-term window chain in float32, the means taken in double here and in
float32 there); ``edge_accuracy`` exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vwfd_tpu.metrics import metrics as jm
from vwfd_tpu_torch import metrics as tm
from vwfd_tpu_torch.kernels import PLAIN, f1, ssim as kssim


def _boundary_pred(rng, shape):
    """Predictions holding every k/255 (float32 division), its neighbours
    one ulp away, values outside [0, 1] and NaN pixels; the rest
    uniform."""
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    special = np.concatenate([
        k, np.nextafter(k, np.float32(2)), np.nextafter(k, np.float32(-1)),
        np.array([-0.5, 1.5, np.inf, -np.inf, np.nan, np.nan], np.float32)])
    pred = rng.random(int(np.prod(shape)), dtype=np.float32)
    pred[:special.size] = special
    rng.shuffle(pred)
    return pred.reshape(shape)


def _masks(rng, shape):
    gt = (rng.random(shape) < 0.3).astype(np.float32)
    return {"random": gt, "empty": np.zeros(shape, np.float32)}


SHAPE = (2, 2, 16, 24, 1)


@pytest.mark.parametrize("mask", ["random", "empty"])
def test_f1_sweep_equals_jax_exactly(mask):
    rng = np.random.default_rng(0)
    pred = _boundary_pred(rng, SHAPE)
    gt = _masks(rng, SHAPE)[mask]
    ts_ref, f1_ref = jm.f1_sweep(jnp.asarray(pred), jnp.asarray(gt))
    ts, f1s = tm.f1_sweep(torch.from_numpy(pred), torch.from_numpy(gt))
    assert f1s.dtype == torch.float32 and f1s.shape == (9,)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ts_ref))
    np.testing.assert_array_equal(f1s.numpy(), np.asarray(f1_ref))
    if mask == "empty":
        assert not f1s.any()
    else:
        assert (f1s > 0).all() and (f1s < 1).all()


def test_threshold_levels_are_the_references():
    ts = np.asarray(tm.DEFAULT_THRESHOLDS, np.float32)
    levels = [tm.threshold_level(t) for t in ts]
    assert levels == [25, 51, 76, 102, 127, 153, 178, 204, 229]
    want = np.floor(255.0 * jnp.asarray(ts))
    np.testing.assert_array_equal(levels, np.asarray(want))
    # a Python float multiplies in float64, then the floor sees float32
    assert tm.threshold_level(0.5) == 127.0


@pytest.mark.parametrize("thresh", [0.5, 0.3, 0.7, 0.0])
@pytest.mark.parametrize("mask", ["random", "empty"])
def test_mask_confusion_and_scores_equal_jax(thresh, mask):
    rng = np.random.default_rng(1)
    pred = _boundary_pred(rng, SHAPE)
    gt = _masks(rng, SHAPE)[mask]
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    got = tm.mask_confusion(p, g, thresh)
    want = jm.mask_confusion(jnp.asarray(pred), jnp.asarray(gt), thresh)
    assert all(v.dtype == torch.int64 for v in got)
    assert [int(v) for v in got] == [float(v) for v in want]
    assert sum(int(v) for v in got) == pred.size
    scores = tm.mask_scores(p, g, thresh)
    ref = jm.mask_scores(jnp.asarray(pred), jnp.asarray(gt), thresh)
    assert scores.keys() == ref.keys()
    for k, v in scores.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]), err_msg=k)


def test_f1_counts_are_exact_above_2_24():
    """F12: 2²⁴ + 3 pixels, all on in both (a broadcast, not a buffer).
    The port counts exactly; JAX sums in float32, which cannot hold the
    count and rounds it to 2²⁴ + 4."""
    n = 2 ** 24 + 3
    pred = torch.tensor(0.9).expand(n)
    tn, tp, fn, fp = tm.mask_confusion(pred, pred, 0.5)
    assert (int(tn), int(tp), int(fn), int(fp)) == (0, n, 0, 0)
    jp = jnp.broadcast_to(jnp.float32(0.9), (n,))
    jtp = float(jm.mask_confusion(jp, jp, 0.5)[1])
    assert jtp == 2 ** 24 + 4 != n


@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_matches_jax(size_average):
    rng = np.random.default_rng(2)
    a = rng.random((3, 20, 28, 3), dtype=np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    b[1, :8, :8] = 0.25  # a flat patch: σ² near 0, the map ~1 there
    a[1, :8, :8] = 0.25
    got = tm.ssim(torch.from_numpy(a), torch.from_numpy(b),
                  size_average=size_average)
    want = np.asarray(jm.ssim(jnp.asarray(a), jnp.asarray(b),
                              size_average=size_average))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    same = tm.ssim(torch.from_numpy(a), torch.from_numpy(a))
    assert abs(float(same) - 1.0) < 1e-6


def test_ssim_window_and_conv_are_the_references():
    np.testing.assert_array_equal(tm.metrics._ssim_window(11).numpy(),
                                  jm._ssim_window(11))
    x = np.random.default_rng(3).random((2, 9, 13, 3), dtype=np.float32)
    w = jm._ssim_window(11)
    got = tm.metrics._depthwise_same_conv(torch.from_numpy(x),
                                          torch.from_numpy(w))
    want = np.asarray(jm._depthwise_same_conv(jnp.asarray(x), w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    # the kernel's separable taps: the same gaussian, one dimension
    g = kssim.window_1d().double()
    np.testing.assert_allclose(torch.outer(g, g).numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "both_empty", "pred_empty"])
def test_edge_accuracy_matches_jax(case):
    rng = np.random.default_rng(4)
    inputs = rng.random((2, 12, 12, 1), dtype=np.float32)
    outputs = np.clip(inputs + 0.3 * rng.standard_normal(inputs.shape),
                      0, 1).astype(np.float32)
    if case == "both_empty":
        inputs, outputs = inputs * 0.4, outputs * 0.4
    elif case == "pred_empty":
        outputs = outputs * 0.4
    got = tm.edge_accuracy(torch.from_numpy(inputs), torch.from_numpy(outputs))
    want = jm.edge_accuracy(jnp.asarray(inputs), jnp.asarray(outputs))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "both_empty":
        assert [float(v) for v in got] == [1.0, 1.0]


def test_kernel_sets_agree_on_the_cpu():
    """``KERNELS`` on CPU tensors takes the plain path: the metrics equal
    those through ``PLAIN``, and the kernels' wrappers reject what their
    kernels do not take."""
    rng = np.random.default_rng(5)
    pred = torch.from_numpy(_boundary_pred(rng, SHAPE))
    gt = torch.from_numpy(_masks(rng, SHAPE)["random"])
    assert torch.equal(tm.f1_sweep(pred, gt)[1],
                       tm.f1_sweep(pred, gt, kernels=PLAIN)[1])
    a = torch.rand(2, 12, 12, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tm.ssim(a, a.flip(1)),
                       tm.ssim(a, a.flip(1), kernels=PLAIN))
    with pytest.raises(ValueError):
        f1.f1_sweep(pred, gt[..., :8, :], [1.0])
    with pytest.raises(TypeError):
        f1.f1_sweep(pred.double(), gt.double(), [1.0])
    with pytest.raises(ValueError):
        f1.f1_sweep(pred, gt, [1.0] * (f1.MAX_LEVELS + 1))
    with pytest.raises(ValueError):
        kssim.ssim(a, a[:1])
    with pytest.raises(ValueError):  # not contiguous
        kssim.ssim(a.transpose(1, 2), a.transpose(1, 2))
