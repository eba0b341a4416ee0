"""Minimal pure-Python NIfTI-1 reader/writer: the port's own copy of
``rehrseg_tpu.io.nifti`` (gzip, struct and numpy; a ``.gz`` read inflates
through the native host library, :mod:`rehrseg_tpu_torch.native`).

The single-file format (.nii / .nii.gz): 348-byte header, optional
extensions, voxel data. Supports the dtypes and fields the pipeline needs
(affine via qform/sform, pixdim spacing, up to 7 dims). As in nibabel,
``data[i, j, k, ...]`` is stored in Fortran order and the affine maps voxel
indices to world (RAS) coordinates; ``scl_slope == 0`` means unscaled, and
two-file ('ni1') headers are refused.

:class:`ItkLikeImage` gives the SimpleITK view: arrays in (z, y, x) order,
spacing in (x, y, z).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

# NIfTI datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


@dataclass
class NiftiHeader:
    dim: tuple
    pixdim: tuple
    dtype: np.dtype
    affine: np.ndarray
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    xyzt_units: int = 10  # mm | sec
    descrip: bytes = b"rehrseg_tpu"
    cal_min: float = 0.0
    cal_max: float = 0.0

    def get_zooms(self):
        nd = self.dim[0]
        return tuple(float(p) for p in self.pixdim[1:nd + 1])


@dataclass
class NiftiImage:
    data: np.ndarray
    affine: np.ndarray | None = None
    header: NiftiHeader | None = None
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.affine is None:
            self.affine = np.eye(4, dtype=np.float64)
        if self.header is None:
            nd = self.data.ndim
            dim = (nd,) + self.data.shape + (1,) * (7 - nd)
            pixdim = (1.0,) * 8
            self.header = NiftiHeader(dim=dim, pixdim=pixdim,
                                      dtype=self.data.dtype, affine=self.affine)

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        d = self.data.astype(dtype)
        h = self.header
        # NIfTI-1 spec (and nibabel): scl_slope == 0 means "scaling unset" —
        # ignore BOTH slope and inter (applying inter anyway would shift
        # every voxel of a scanner-written file with slope=0, inter!=0)
        if (h is not None and h.scl_slope != 0.0
                and (h.scl_slope != 1.0 or h.scl_inter != 0.0)):
            d = d * h.scl_slope + h.scl_inter
        return d

    @property
    def shape(self):
        return self.data.shape


def _open_maybe_gz(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def _read_maybe_gz(path: str) -> bytes:
    """Read (and inflate) file contents; ``.gz`` inflates through the
    native host library (:func:`rehrseg_tpu_torch.native.gunzip`, which
    falls back to the gzip module)."""
    with open(path, "rb") as f:
        raw = f.read()
    if str(path).endswith(".gz"):
        from .. import native
        return native.gunzip(raw)
    return raw


def load(path: str) -> NiftiImage:
    """Read a .nii or .nii.gz file (nibabel.load parity for our use cases)."""
    raw = _read_maybe_gz(path)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    if sizeof_hdr != _HDR_SIZE:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")

    dim = struct.unpack_from("<8h", raw, 40)
    datatype, bitpix = struct.unpack_from("<hh", raw, 70)
    pixdim = struct.unpack_from("<8f", raw, 76)
    (vox_offset,) = struct.unpack_from("<f", raw, 108)
    scl_slope, scl_inter = struct.unpack_from("<ff", raw, 112)
    cal_max, cal_min = struct.unpack_from("<ff", raw, 124)
    descrip = struct.unpack_from("<80s", raw, 148)[0].rstrip(b"\x00")
    qform_code, sform_code = struct.unpack_from("<hh", raw, 252)
    quatern = struct.unpack_from("<6f", raw, 256)
    srow_x = struct.unpack_from("<4f", raw, 280)
    srow_y = struct.unpack_from("<4f", raw, 296)
    srow_z = struct.unpack_from("<4f", raw, 312)
    magic = struct.unpack_from("<4s", raw, 344)[0]
    if magic == b"ni1\x00":
        # two-file (.hdr/.img) NIfTI: the voxels live in a separate .img
        # file this single-file reader would misread header bytes as
        raise ValueError(
            f"{path}: two-file NIfTI (.hdr/.img pair, magic 'ni1') is not "
            "supported — convert to single-file .nii/.nii.gz")
    if magic != b"n+1\x00":
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype])

    nd = dim[0]
    shape = tuple(int(d) for d in dim[1:nd + 1])
    count = int(np.prod(shape)) if shape else 0
    off = int(vox_offset)
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
    data = data.reshape(shape, order="F")

    if sform_code > 0:
        affine = np.array([srow_x, srow_y, srow_z, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        affine = _quatern_to_affine(quatern, pixdim, shape)
    else:
        # "old-style" fallback: diagonal pixdim scaling
        affine = np.diag(list(pixdim[1:4]) + [1.0]).astype(np.float64)

    header = NiftiHeader(dim=dim, pixdim=pixdim, dtype=dtype, affine=affine,
                         scl_slope=scl_slope, scl_inter=scl_inter,
                         descrip=descrip, cal_min=cal_min, cal_max=cal_max)
    return NiftiImage(data=np.array(data), affine=affine, header=header)


def _quatern_to_affine(quatern, pixdim, shape):
    b, c, d, qx, qy, qz = quatern
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
    zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    affine = np.eye(4)
    affine[:3, :3] = R * zooms
    affine[:3, 3] = [qx, qy, qz]
    return affine


def save(img: NiftiImage, path: str) -> None:
    """Write a .nii / .nii.gz file with an sform affine."""
    data = np.asarray(img.data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    nd = data.ndim
    if nd > 7:
        raise ValueError("NIfTI supports at most 7 dims")
    dim = [nd] + list(data.shape) + [1] * (7 - nd)
    hdr = img.header
    if hdr is not None and len(hdr.pixdim) == 8:
        pixdim = list(hdr.pixdim)
    else:
        pixdim = [1.0] * 8
    affine = np.asarray(img.affine if img.affine is not None else np.eye(4), dtype=np.float64)
    # Keep pixdim consistent with affine column norms for the 3 spatial dims
    for i in range(3):
        n = float(np.linalg.norm(affine[:3, i]))
        if n > 0:
            pixdim[i + 1] = n

    dtype_code = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    buf = bytearray(352)
    struct.pack_into("<i", buf, 0, _HDR_SIZE)
    struct.pack_into("<8h", buf, 40, *dim)
    struct.pack_into("<hh", buf, 70, dtype_code, bitpix)
    struct.pack_into("<8f", buf, 76, *pixdim)
    struct.pack_into("<f", buf, 108, 352.0)  # vox_offset
    struct.pack_into("<ff", buf, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<ff", buf, 124, 0.0, 0.0)  # cal_max/min
    descrip = (img.header.descrip if img.header else b"rehrseg_tpu")[:79]
    struct.pack_into("<80s", buf, 148, descrip)
    struct.pack_into("<hh", buf, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", buf, 280, *affine[0])
    struct.pack_into("<4f", buf, 296, *affine[1])
    struct.pack_into("<4f", buf, 312, *affine[2])
    struct.pack_into("<4s", buf, 344, b"n+1\x00")

    # two writes, no concatenation: tobytes(order="F") already serializes
    # any layout, so asfortranarray + concat would make ~3x peak copies of
    # a large SR volume for identical bytes
    with _open_maybe_gz(path, "wb") as f:
        f.write(bytes(buf))
        f.write(data.tobytes(order="F"))


# ---------------------------------------------------------------------------
# SimpleITK-style geometry helpers (z,y,x array order; x,y,z spacing order)
# ---------------------------------------------------------------------------

@dataclass
class ItkLikeImage:
    """Array in z,y,x order + geometry, mirroring the small slice of the
    SimpleITK API the reference relies on (sr_utils.py:75-97, train_all.py:168-181)."""

    array: np.ndarray          # (z, y, x)
    spacing: tuple             # (x, y, z)
    origin: tuple = (0.0, 0.0, 0.0)
    direction: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    def GetSpacing(self):
        return self.spacing

    def GetOrigin(self):
        return self.origin

    def GetDirection(self):
        return self.direction


def read_image_itk(path: str) -> ItkLikeImage:
    """sitk.ReadImage + GetArrayFromImage equivalent for NIfTI files.

    SimpleITK returns arrays in (z, y, x) index order while the image is
    stored (x, y, z); spacing stays (x, y, z). Direction/origin come from the
    affine (LPS vs RAS sign differences don't matter for our round-trips).
    """
    img = load(path)
    data = img.data
    if data.ndim > 3:
        data = np.squeeze(data)
    arr = np.ascontiguousarray(np.transpose(data, tuple(range(data.ndim))[::-1]))
    zooms = img.header.get_zooms()[:3]
    spacing = tuple(float(z) for z in zooms) if len(zooms) == 3 else (1.0, 1.0, 1.0)
    origin = tuple(float(v) for v in img.affine[:3, 3])
    d = img.affine[:3, :3].copy()
    norms = np.linalg.norm(d, axis=0)
    norms[norms == 0] = 1.0
    d = d / norms
    direction = tuple(float(v) for v in d.flatten())
    return ItkLikeImage(array=arr, spacing=spacing, origin=origin, direction=direction)


def write_image_itk(img: ItkLikeImage, path: str) -> None:
    """sitk.WriteImage equivalent: (z,y,x) array + geometry -> NIfTI file."""
    arr = np.asarray(img.array)
    data = np.ascontiguousarray(np.transpose(arr, tuple(range(arr.ndim))[::-1]))
    affine = np.eye(4)
    d = np.array(img.direction, dtype=np.float64).reshape(3, 3)
    affine[:3, :3] = d * np.array(img.spacing)[None, :]
    affine[:3, 3] = img.origin
    nd = data.ndim
    dim = (nd,) + data.shape + (1,) * (7 - nd)
    pixdim = (1.0, *[float(s) for s in img.spacing], *([1.0] * (7 - 3)))
    header = NiftiHeader(dim=dim, pixdim=pixdim, dtype=data.dtype, affine=affine)
    save(NiftiImage(data=data, affine=affine, header=header), path)
