"""The port's host I/O vs ``cbim_tpu``'s, on the CPU: its own copies of
the NIfTI reader and writer (the writer compresses ``.nii.gz`` at gzip
level 1) and of the prediction CLI's two resampling functions, held
against the JAX package's on the same seeded inputs."""

import gzip

import numpy as np
import pytest

from cbim_tpu.data import nifti as jax_nifti
from cbim_tpu.data.conversion import utils as jax_conversion
from cbim_tpu_torch.data import conversion, nifti
from test_torch_threads import few_torch_threads  # noqa: F401


def _volume(dtype):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(7, 9, 11)) * 50).astype(dtype)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_written_file_reads_back(tmp_path, suffix, dtype):
    data, spacing = _volume(dtype), (2.5, 0.8, 0.75)
    affine = np.diag([0.75, 0.8, 2.5, 1.0])
    affine[:3, 3] = (-10.0, 4.0, 7.5)
    path = tmp_path / f"v{suffix}"
    nifti.write_nifti(path, data, spacing=spacing, affine=affine)
    img = jax_nifti.read_nifti(str(path))
    np.testing.assert_array_equal(img.data, data)
    assert img.data.dtype == dtype
    assert img.spacing == pytest.approx(spacing)
    np.testing.assert_allclose(img.affine, affine, rtol=1e-6)
    # the uncompressed staging file is gone
    assert [p.name for p in tmp_path.iterdir()] == [path.name]


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_gz_holds_the_jax_package_bytes_at_level_1(tmp_path, dtype):
    data = _volume(dtype)
    ours, theirs = tmp_path / "ours.nii.gz", tmp_path / "theirs.nii.gz"
    nifti.write_nifti(ours, data, spacing=(2.0, 1.0, 1.0))
    jax_nifti.write_nifti(str(theirs), data, spacing=(2.0, 1.0, 1.0))
    assert (gzip.decompress(ours.read_bytes())
            == gzip.decompress(theirs.read_bytes()))
    # gzip header byte 8 (XFL): 4 = fastest level, 2 = best (the default)
    assert ours.read_bytes()[8] == 4 and theirs.read_bytes()[8] == 2


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_port_reads_what_the_jax_package_wrote(tmp_path, suffix, dtype):
    """The reverse direction: ``cbim_tpu`` writes, the port reads; the
    arrays, spacing and affine equal what ``cbim_tpu`` reads back."""
    data, spacing = _volume(dtype), (3.0, 1.25, 0.7)
    affine = np.diag([0.7, 1.25, 3.0, 1.0])
    affine[:3, 3] = (5.0, -2.0, 1.5)
    path = str(tmp_path / f"v{suffix}")
    jax_nifti.write_nifti(path, data, spacing=spacing, affine=affine)
    ours, theirs = nifti.read_nifti(path), jax_nifti.read_nifti(path)
    np.testing.assert_array_equal(ours.data, data)
    assert ours.data.dtype == theirs.data.dtype == dtype
    assert ours.spacing == theirs.spacing
    np.testing.assert_array_equal(ours.affine, theirs.affine)


@pytest.mark.parametrize("spacing, target", [
    ((2.5, 0.8, 0.75), (2.5, 1.0, 1.0)),      # 2D serving: y/x only
    ((1.0, 1.9, 1.9), (1.5, 1.5, 1.5)),       # 3D: every axis
    ((1.5, 1.5, 1.5), (1.5, 1.5, 1.5))])      # on spacing: a copy
def test_resample_to_spacing_matches_jax(spacing, target):
    img = _volume(np.float32)
    ours = conversion.resample_to_spacing(img, spacing, target, order=3)
    theirs = jax_conversion.resample_to_spacing(img, spacing, target, order=3)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("shape", [(7, 9, 11), (7, 13, 6), (4, 20, 20)])
def test_resample_label_to_shape_matches_jax(shape):
    lab = np.random.default_rng(1).integers(0, 4, size=(7, 9, 11)
                                            ).astype(np.uint8)
    ours = conversion.resample_label_to_shape(lab, shape)
    theirs = jax_conversion.resample_label_to_shape(lab, shape)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == shape
    np.testing.assert_array_equal(ours, theirs)
