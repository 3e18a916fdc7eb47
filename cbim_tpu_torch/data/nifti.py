"""NIfTI-1 I/O of the port (.nii / .nii.gz), numpy only.

The port's own copy of ``cbim_tpu/data/nifti.py``: the same header fields,
the same (z, y, x) array order as ``sitk.GetArrayFromImage``, the same
bytes on disk.  One difference: ``.nii.gz`` is written at gzip level 1.
gzip's default level 9 takes seconds on a 160x256x256 label map, and the
decompressed bytes are the same.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """A loaded NIfTI volume.

    data: numpy array in (z, y, x) order (after squeezing trailing dims).
    spacing: (z, y, x) voxel spacing, i.e. reversed from ITK's (x, y, z).
    affine: 4x4 voxel->world matrix (x, y, z homogeneous convention).
    """
    data: np.ndarray
    spacing: tuple
    affine: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def shape(self):
        return self.data.shape


def _open(path, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode, compresslevel=1) if "w" in mode \
            else gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path) -> NiftiImage:
    with _open(path) as f:
        raw = f.read()
    hdr = raw[:348]
    endian = "<"
    if struct.unpack("<i", hdr[0:4])[0] != 348:
        endian = ">"
        if struct.unpack(">i", hdr[0:4])[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")

    dim = struct.unpack(endian + "8h", hdr[40:56])
    ndim = dim[0]
    shape_xyz = [max(1, d) for d in dim[1:1 + max(ndim, 3)]]
    datatype = struct.unpack(endian + "h", hdr[70:72])[0]
    pixdim = struct.unpack(endian + "8f", hdr[76:108])
    vox_offset = int(struct.unpack(endian + "f", hdr[108:112])[0])
    scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
    scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]
    sform_code = struct.unpack(endian + "h", hdr[254:256])[0]
    srow = np.frombuffer(hdr[280:328], dtype=endian + "f4").reshape(3, 4)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    n = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dt, count=n, offset=vox_offset)
    # NIfTI stores x fastest: reshape Fortran-style to (x, y, z, ...)
    data = data.reshape(shape_xyz, order="F")
    while data.ndim > 3 and data.shape[-1] == 1:      # time etc.
        data = data[..., 0]

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    # (x, y, z) -> numpy (z, y, x)
    data = np.ascontiguousarray(np.transpose(data, axes=range(data.ndim)[::-1]))

    spacing_xyz = [float(p) if p > 0 else 1.0 for p in pixdim[1:1 + 3]]
    spacing = tuple(spacing_xyz[::-1])[-data.ndim:]

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    else:
        affine[0, 0], affine[1, 1], affine[2, 2] = spacing_xyz[:3]
    return NiftiImage(data=data, spacing=spacing, affine=affine)


def write_nifti(path, data: np.ndarray, spacing=None,
                affine: np.ndarray | None = None) -> None:
    """Write (z, y, x)-ordered ``data`` as NIfTI-1; spacing is (z, y, x)."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _CODES:
        data = data.astype(np.float32)
    if spacing is None:
        spacing = (1.0,) * data.ndim
    spacing_xyz = list(spacing)[::-1] + [1.0] * (3 - data.ndim)

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    ndim = data.ndim
    dims = [ndim] + list(data.shape[::-1]) + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)   # bitpix
    pix = [1.0] + spacing_xyz[:3] + [0.0] * (7 - 3)
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)                    # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                      # scl_slope
    struct.pack_into("<h", hdr, 252, 1)                        # qform_code
    struct.pack_into("<h", hdr, 254, 1)                        # sform_code
    if affine is None:
        affine = np.eye(4)
        affine[0, 0], affine[1, 1], affine[2, 2] = spacing_xyz[:3]
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].reshape(-1).tolist())
    hdr[344:348] = b"n+1\x00"

    # x fastest on disk: the C order of the (z, y, x) array
    payload = np.ascontiguousarray(data).tobytes(order="C")

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)   # extension flag
        f.write(payload)
