"""The port's native host library (``rehrseg_tpu_torch.native``) against the
JAX package's (``rehrseg_tpu.native``), on the same inputs: the cases of
tests/test_native.py. Both bind the same ``csrc/rehrseg_host.cpp``; the
port builds it into its own build directory. gzip round trips and the
z-score are bit-equal, the spline, blur and resize at that file's
tolerances; the NIfTI reader's gunzip path, a truncated stream, two
processes building the library at once, and the numpy / zlib forms that
run without it."""

import gzip
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from rehrseg_tpu import native as jnative
from rehrseg_tpu_torch import native as tnative

pytestmark = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="native build unavailable (no g++ or zlib)")


def test_builds_into_the_ports_build_dir():
    from rehrseg_tpu_torch import kernels
    assert tnative.available() and tnative.build_error() is None
    assert tnative.library_path().parent == kernels.BUILD_DIR
    assert tnative.library_path().is_file()


def test_gunzip_gzip_roundtrip_bit_equal(rng):
    payload = rng.integers(0, 255, size=100_000, dtype=np.uint8).tobytes()
    gz = gzip.compress(payload)
    assert tnative.gunzip(gz) == jnative.gunzip(gz) == payload
    ours = tnative.gzip_compress(payload)
    assert ours == jnative.gzip_compress(payload)
    assert gzip.decompress(ours) == payload
    # a hint smaller than the output still inflates (the buffer grows)
    big = bytes(1 << 20)
    assert tnative.gunzip(gzip.compress(big), hint_size=16) == big


def test_spline_filter(rng):
    from scipy.ndimage import spline_filter1d
    x = rng.normal(size=(4, 37, 5)).astype(np.float32)
    got = tnative.spline_filter_axis(x, axis=1)
    np.testing.assert_array_equal(got, jnative.spline_filter_axis(x, axis=1))
    ref = spline_filter1d(x, order=3, axis=1, mode="mirror",
                          output=np.float32)
    assert np.allclose(got, ref, atol=2e-4)


def test_blur(rng):
    from rehrseg_tpu_torch.ops.blur import blur_axis_np, parse_kernel
    k = parse_kernel(None, "rf-pulse-slr", 3.873)
    x = rng.normal(size=(3, 24, 7)).astype(np.float32)
    got = tnative.blur_axis(x, k, axis=1)
    np.testing.assert_array_equal(got, jnative.blur_axis(x, k, axis=1))
    assert np.allclose(got, blur_axis_np(x, k, axis=1), atol=1e-5)


def test_resize_axis(rng):
    from rehrseg_tpu_torch.ops.bspline import as_fraction, resize_matrix
    M = resize_matrix(16, as_fraction(4.0), 3)
    x = rng.normal(size=(2, 16, 9)).astype(np.float32)
    got = tnative.resize_axis_matrix(x, M, axis=1)
    np.testing.assert_array_equal(got, jnative.resize_axis_matrix(x, M, 1))
    ref = np.moveaxis(np.tensordot(M, np.moveaxis(x, 1, 0), axes=(1, 0)),
                      0, 1)
    assert got.shape == (2, 4, 9)
    assert np.allclose(got, ref, atol=1e-4)


def test_zscore_inplace_bit_equal(rng):
    x = rng.normal(3, 2, size=(64, 64)).astype(np.float32)
    got = tnative.zscore_inplace(x.copy())
    np.testing.assert_array_equal(got, jnative.zscore_inplace(x.copy()))
    assert abs(got.mean()) < 1e-4 and abs(got.std() - 1) < 1e-3


def test_nifti_gz_reads_through_native(tmp_path, rng, monkeypatch):
    """The port's reader inflates .nii.gz through native.gunzip and reads
    the file the JAX package wrote; the gzip module path gives the same
    array."""
    from rehrseg_tpu.io import nifti as jnifti
    from rehrseg_tpu_torch.io import nifti as tnifti
    data = rng.normal(size=(16, 16, 8)).astype(np.float32)
    p = str(tmp_path / "x.nii.gz")
    jnifti.save(jnifti.NiftiImage(data=data), p)
    calls = []
    real = tnative.gunzip
    monkeypatch.setattr(tnative, "gunzip",
                        lambda raw: calls.append(len(raw)) or real(raw))
    img = tnifti.load(p)
    assert calls and np.array_equal(img.data, data)
    monkeypatch.setattr(tnative, "gunzip", gzip.decompress)
    assert np.array_equal(tnifti.load(p).data, data)


def test_gunzip_truncated_input_raises():
    """A truncated stream must not hang the retry loop: it falls back to
    the gzip module, which raises, in both packages."""
    payload = bytes(range(256)) * 64
    blob = gzip.compress(payload)
    for mod in (tnative, jnative):
        with pytest.raises(Exception):
            mod.gunzip(blob[:len(blob) // 2])
        assert mod.gunzip(blob) == payload


def test_two_processes_build_at_once(tmp_path):
    """Two fresh processes build the library into one empty build directory
    at the same time: both load a whole library and inflate correctly."""
    code = textwrap.dedent("""
        import gzip, sys
        from rehrseg_tpu_torch import native
        ok = native.available()
        data = bytes(range(256)) * 512
        sys.exit(0 if ok and native.gunzip(gzip.compress(data)) == data
                 else 1)
    """)
    env = {**os.environ, "REHRSEG_TORCH_BUILD_DIR": str(tmp_path / "build"),
           "PYTHONPATH": str(Path(__file__).resolve().parents[1])}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env)
             for _ in range(2)]
    assert [p.wait(timeout=240) for p in procs] == [0, 0]
    # one library, and no temporary file left behind
    libs = list((tmp_path / "build").glob("*.so"))
    assert [p.name[:15] for p in libs] == ["librehrseg_host"]


@pytest.mark.parametrize("entry", ["gunzip", "gzip", "spline", "blur",
                                   "resize", "zscore"])
def test_fallbacks_match_the_library(monkeypatch, rng, entry):
    """Without the library each entry point's numpy / zlib form gives what
    the library gives (available() then False)."""
    from rehrseg_tpu_torch.ops.blur import parse_kernel
    from rehrseg_tpu_torch.ops.bspline import as_fraction, resize_matrix
    x = rng.normal(size=(3, 24, 7)).astype(np.float32)
    payload = x.tobytes()
    cases = {
        "gunzip": (lambda: tnative.gunzip(gzip.compress(payload)), 0),
        "gzip": (lambda: gzip.decompress(tnative.gzip_compress(payload)), 0),
        "spline": (lambda: tnative.spline_filter_axis(x, 1), 2e-4),
        "blur": (lambda: tnative.blur_axis(
            x, parse_kernel(None, "rf-pulse-slr", 3.873), 1), 1e-5),
        "resize": (lambda: tnative.resize_axis_matrix(
            x, resize_matrix(24, as_fraction(4.0), 3), 1), 1e-4),
        "zscore": (lambda: tnative.zscore_inplace(x.copy()), 1e-5),
    }
    fn, tol = cases[entry]
    want = fn()
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", True)
    assert not tnative.available()
    got = fn()
    if tol == 0:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, atol=tol)


def test_installed_copy_without_source(monkeypatch, tmp_path):
    """A copy of the package without the checkout's csrc/ reports the
    library unavailable, with the reason, and still inflates."""
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "none.cpp")
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "_ERROR", None)
    assert not tnative.available()
    assert "not found" in tnative.build_error()
    assert tnative.gunzip(gzip.compress(b"abc")) == b"abc"


def test_refuses_what_the_c_side_cannot_take(rng):
    """Sizes and layouts are checked before a pointer reaches the library:
    a resize matrix whose width is not the axis's length, a z-score of a
    non-contiguous or float64 array."""
    from rehrseg_tpu_torch.ops.bspline import as_fraction, resize_matrix
    x = rng.normal(size=(2, 16, 9)).astype(np.float32)
    with pytest.raises(ValueError, match="resize matrix"):
        tnative.resize_axis_matrix(x, resize_matrix(12, as_fraction(4.0), 3),
                                   axis=1)
    for bad in (x[:, ::2], x.astype(np.float64)):
        with pytest.raises(ValueError, match="C-contiguous float32"):
            tnative.zscore_inplace(bad)
