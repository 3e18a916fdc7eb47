"""NIfTI I/O of the port.

Reading is ``cbim_tpu.data.nifti`` itself, a numpy-only module that imports
nothing of JAX.  Writing wraps its ``write_nifti`` and compresses ``.nii.gz``
at gzip level 1: gzip's default level 9 takes seconds on a 160x256x256
label map, and the decompressed bytes are the same.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tempfile

from cbim_tpu.data.nifti import NiftiImage, read_nifti  # noqa: F401
from cbim_tpu.data.nifti import write_nifti as _write_nifti


def write_nifti(path, data, spacing=None, affine=None) -> None:
    """Write (z, y, x)-ordered ``data`` as NIfTI-1; spacing is (z, y, x)."""
    path = str(path)
    if not path.endswith(".gz"):
        _write_nifti(path, data, spacing, affine)
        return
    fd, raw = tempfile.mkstemp(suffix=".nii",
                               dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    try:
        _write_nifti(raw, data, spacing, affine)
        with open(raw, "rb") as src, \
                gzip.open(path, "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 24)
    finally:
        os.remove(raw)
