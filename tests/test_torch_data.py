"""The port's NIfTI writer vs ``cbim_tpu``'s, on the CPU.

The port reads with ``cbim_tpu.data.nifti`` itself and only writes through
its own wrapper, which compresses ``.nii.gz`` at gzip level 1."""

import gzip

import numpy as np
import pytest

from cbim_tpu.data import nifti as jax_nifti
from cbim_tpu_torch.data import nifti


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
