"""Parity of the port's DCT-domain data with the JAX package, on the host:
K25 ``blockdct`` (``vwfd_tpu_torch/native.py``) against its numpy plain
version and ``vwfd_tpu.native``, ``DCTDomainDataset`` items, the
cvtransforms train and val pipelines under the same ``random`` seed, and the
port's cv2-style resize against ``cv2.resize`` on float32 planes.

Tolerances and why:

* K25: 1e-4 of the coefficients' max (8-term sums in another order than
  numpy's einsum and than the JAX package's ``-march=native`` build, which
  may contract them into FMAs);
* the dataset's items: 1e-3 absolute on the standardised coefficients
  (their DCT rounds as above; a band's standardisation divides by its
  spread, which is small for the synthetic images' high frequencies);
* the resize: 1e-5 of the plane's max (OpenCV's vector code may contract
  the taps' products into FMAs; the port rounds each);
* the pipelines: 1e-4 absolute, their resizes and DCTs as above.
"""

import random

import cv2
import numpy as np
import pytest

from vwfd_tpu import native as jnative
from vwfd_tpu.data import cvtransforms as JT
from vwfd_tpu.data import jpeg_data as jjd
from vwfd_tpu_torch import native
from vwfd_tpu_torch.data import cvtransforms as T
from vwfd_tpu_torch.data import jpeg_data
from vwfd_tpu_torch.ops.dct import _dct_matrix_np


def _planes(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255 - 128).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(8, 8), (64, 48), (256, 256),
                                   (3, 32, 24)])
def test_blockdct_matches_numpy_and_the_jax_native_kernel(shape):
    x = _planes(0, shape)
    before = native.COUNT.n
    got = native.blockwise_dct(x)
    assert native.COUNT.n == before + 1
    want = native.blockwise_dct_plain(x)
    assert got.shape == want.shape == (*shape[:-2], shape[-2] // 8,
                                       shape[-1] // 8, 64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    planes = x.reshape((-1,) + shape[-2:])
    ref = np.stack([jnative.blockwise_dct(p) if jnative.available()
                    else jjd.blockwise_dct_np(p) for p in planes])
    np.testing.assert_allclose(got.reshape(ref.shape), ref, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_array_equal(_dct_matrix_np(8), jjd._dct_matrix8())


def test_blockdct_refuses_shapes_and_never_falls_back(monkeypatch, tmp_path):
    with pytest.raises(ValueError):
        native.blockwise_dct(np.zeros((12, 16), np.float32))
    with pytest.raises(ValueError):
        native.blockwise_dct(np.zeros((16,), np.float32))
    # no compiler: the build raises, with no numpy path behind it
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.blockwise_dct(np.zeros((8, 8), np.float32))
    # a compiler that fails: raises with its output
    monkeypatch.setattr(native.shutil, "which", lambda name: "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.blockwise_dct(np.zeros((8, 8), np.float32))


def test_blockwise_dct_np_is_the_host_kernel():
    x = _planes(1, (32, 16))
    before = native.COUNT.n
    np.testing.assert_array_equal(jpeg_data.blockwise_dct_np(x),
                                  native.blockwise_dct(x))
    assert native.COUNT.n == before + 2


@pytest.mark.parametrize("size,idx", [(64, 0), (64, 2), (256, 1)])
def test_dct_domain_dataset_matches_jax(size, idx):
    got = jpeg_data.DCTDomainDataset(size=size, synthetic_length=3)
    want = jjd.DCTDomainDataset(size=size, synthetic_length=3)
    assert len(got) == len(want) == 3
    before = native.COUNT.n
    a, b = got[idx], want[idx]
    assert native.COUNT.n == before + 2  # Y, then Cb and Cr in one call
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == np.float32
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("shape", [(32, 32, 64), (16, 16, 64), (13, 21, 5),
                                   (32, 32)])
@pytest.mark.parametrize("interp", ["BILINEAR", "BICUBIC"])
def test_resize_plane_matches_cv2(shape, interp):
    a = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    flag = cv2.INTER_LINEAR if interp == "BILINEAR" else cv2.INTER_CUBIC
    for hw in [(4, 4), (16, 16), (32, 32), (64, 64), (7, 11), (24, 9)]:
        want = cv2.resize(a, (hw[1], hw[0]), interpolation=flag)
        if want.ndim != a.ndim:
            want = want[..., None]
        got = T.resize_plane(a, hw, interp)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=str(hw))


def _item(size=64, idx=0):
    d = jpeg_data.DCTDomainDataset(size=size, synthetic_length=2)[idx]
    return d["dct_y"], d["dct_cb"], d["dct_cr"]


def _train(mod, rng, channels, pattern):
    kw = {} if rng is None else {"rng": rng}
    return mod.Compose([
        mod.UpsampleCbCr(),
        mod.SubsetDCT2(channels=channels, pattern=pattern),
        mod.RandomResizedCropDCT(size=32, **kw),
        mod.Aggregate2(),
        mod.RandomHorizontalFlip(**kw),
        mod.RandomVerticalFlip(p=0.3, **kw),
        mod.ToTensorDCT2(),
        mod.NormalizeDCT(np.linspace(-1, 1, 192), np.linspace(1, 2, 192),
                         channels=channels, pattern=pattern),
    ])


def _val(mod, channels, pattern, interp):
    return mod.Compose([
        mod.UpsampleCbCr(interpolation=interp),
        mod.SubsetDCT(channels=channels, pattern=pattern),
        mod.Resize(6, interpolation=interp),
        mod.CenterCropDCT(size=32),
        mod.Aggregate(),
        mod.ToTensorDCT2(),
        mod.Lambda(lambda t: t * 2.0),
    ])


@pytest.mark.parametrize("channels,pattern", [(24, "square"),
                                              (48, "triangle")])
def test_train_pipeline_matches_jax_under_the_same_seed(channels, pattern):
    item = _item(256)
    for seed in range(6):
        random.seed(seed)
        want = _train(JT, None, channels, pattern)(item)
        got = _train(T, random.Random(seed), channels, pattern)(item)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("interp", ["BILINEAR", "BICUBIC"])
def test_val_pipeline_matches_jax(interp):
    item = _item(64, 1)
    want = _val(JT, 48, "triangle", interp)(item)
    got = _val(T, 48, "triangle", interp)(item)
    assert got.shape == want.shape == (48, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_tuple_transforms_and_subsets_match_jax():
    item = _item(64)
    for c, p in ((24, "square"), (6, "triangle"), (64, "learned")):
        assert T.subset_indices(c, p) == JT.subset_indices(c, p)
    up = T.UpsampleCbCr()(item)
    jup = JT.UpsampleCbCr()(item)
    for a, b in zip(up, jup):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    tt = T.ToTensorDCT()(up)
    for a, b in zip(tt, JT.ToTensorDCT()(jup)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    kw = dict(cb_mean=np.full(64, 0.5), cb_std=np.full(64, 2.0),
              cr_mean=np.full(64, -0.5), cr_std=np.full(64, 4.0))
    norm = T.NormalizeDCT(np.zeros(64), np.ones(64), **kw)(tt)
    jnorm = JT.NormalizeDCT(np.zeros(64), np.ones(64), **kw)(tt)
    for a, b in zip(norm, jnorm):
        np.testing.assert_array_equal(a, b)
    random.seed(3)
    jcrop = JT.RandomResizedCropDCT(64)(up)
    crop = T.RandomResizedCropDCT(64, rng=random.Random(3))(up)
    for a, b in zip(crop, jcrop):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    with pytest.raises(TypeError):  # the draws need an explicit rng
        T.RandomHorizontalFlip()
