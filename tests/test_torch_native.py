"""The port's native host library (fr_tpu_torch/native) against fr_tpu's
(fr_tpu/native): both compile the same C++ source with g++, so every score,
gather and decode must be the same bits. Also the library's build place and
its numpy fallbacks under FR_TPU_NO_NATIVE, which the scoring functions of
eval/verification.py take; those give the native bits too, and stay within
1e-12 of fr_tpu's numpy path (which sums pairwise)."""

import ctypes.util
import shutil
from pathlib import Path

import numpy as np
import pytest

from fr_tpu import native as jax_native
from fr_tpu.eval import verification as jax_verification
from fr_tpu_torch import native
from fr_tpu_torch.eval import verification

REPO = Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native library")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries, built (or found built) before any test compares
    them."""
    assert native.available(), "the port's native library did not build"
    assert jax_native.available(), "fr_tpu's native library did not build"


def _unit(rng, n, d):
    e = rng.standard_normal((n, d)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_library_builds_with_gpp_into_the_build_dir():
    so = native.library_path()
    assert so.is_file()
    assert so.parent == REPO / "fr_tpu_torch" / "_build" / "native"
    # libjpeg is present here, so the decode pool is in
    assert native.jpeg_available() == (ctypes.util.find_library("jpeg")
                                       is not None)


@pytest.mark.parametrize("n,d", [(500, 64), (1000, 512)])
def test_pair_score_bits_equal_fr_tpu(n, d):
    rng = np.random.default_rng(n)
    e1, e2 = _unit(rng, n, d), _unit(rng, n, d)
    labels = rng.integers(0, 2, n)
    ref = jax_native.pair_score_native(e1, e2, labels)
    _equal(native.pair_score_native(e1, e2, labels), ref)
    _equal(verification.pair_score(e1, e2, labels), ref)


@pytest.mark.parametrize("n,d,classes", [(60, 32, 7), (300, 128, 40)])
def test_cross_score_bits_equal_fr_tpu(n, d, classes):
    rng = np.random.default_rng(n)
    emb = _unit(rng, n, d)
    labels = rng.integers(0, classes, n).astype(np.int64)
    ref = jax_native.cross_score_native(emb, labels)
    _equal(native.cross_score_native(emb, labels), ref)
    _equal(verification.cross_score(emb, labels), ref)
    _equal(verification.cross_score(emb, labels.astype(np.int32)), ref)


def test_gather_u8_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (40, 8, 8, 3)).astype(np.uint8)
    np.save(tmp_path / "images.npy", imgs)
    mm = np.load(tmp_path / "images.npy", mmap_mode="r")
    idx = np.sort(rng.integers(0, 40, 24))
    ours = native.gather_u8_native(mm, idx)
    np.testing.assert_array_equal(ours, jax_native.gather_u8_native(mm, idx))
    np.testing.assert_array_equal(ours, imgs[idx])


@pytest.mark.parametrize("src,out", [(16, 16), (24, 16), (12, 20)])
def test_jpeg_decode_bitwise(src, out):
    cv2 = pytest.importorskip("cv2")
    if not native.jpeg_available():
        pytest.skip("the native library built without libjpeg")
    rng = np.random.default_rng(src)
    blobs = []
    for _ in range(5):
        img = rng.integers(0, 256, (src, src, 3)).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", img)
        assert ok
        blobs.append(buf.tobytes())
    ours = native.decode_jpegs_native(blobs, out)
    assert ours.shape == (5, out, out, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours,
                                  jax_native.decode_jpegs_native(blobs, out))


def test_decode_failure_returns_none():
    if not native.jpeg_available():
        pytest.skip("the native library built without libjpeg")
    assert native.decode_jpegs_native([b"not a jpeg"], 8) is None
    assert native.decode_jpegs_native([b""], 8) is None


@pytest.fixture
def no_native(monkeypatch):
    """FR_TPU_NO_NATIVE set, and the loader's once-per-process decision
    reset, so the next load() reads the variable again; the fixture's
    teardown restores the loaded library."""
    monkeypatch.setenv("FR_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native.load() is None and not native.available()


def _fr_tpu_numpy_path(monkeypatch):
    """fr_tpu's loader reports no library from here on, so its scoring
    takes its numpy path (which sums pairwise)."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)


def test_no_native_pair_score_fallback(no_native, monkeypatch):
    rng = np.random.default_rng(5)
    e1, e2 = _unit(rng, 700, 512), _unit(rng, 700, 512)
    labels = rng.integers(0, 2, 700)
    assert native.pair_score_native(e1, e2, labels) is None
    ours = verification.pair_score(e1, e2, labels)
    _equal(ours, jax_native.pair_score_native(e1, e2, labels))
    _fr_tpu_numpy_path(monkeypatch)
    ref = jax_verification.pair_score(e1, e2, labels)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-12)


def test_no_native_cross_score_fallback(no_native, monkeypatch):
    rng = np.random.default_rng(6)
    emb = _unit(rng, 200, 512)
    labels = rng.integers(0, 30, 200).astype(np.int64)
    assert native.cross_score_native(emb, labels) is None
    ours = verification.cross_score(emb, labels)
    _equal(ours, jax_native.cross_score_native(emb, labels))
    _fr_tpu_numpy_path(monkeypatch)
    ref = jax_verification.cross_score(emb, labels)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ours[3], ref[3])


def test_no_native_gather_and_decode_decline(no_native):
    imgs = np.zeros((4, 2, 2, 3), np.uint8)
    assert native.gather_u8_native(imgs, np.arange(2)) is None
    assert native.decode_jpegs_native([b"x"], 2) is None
    assert not native.jpeg_available()
