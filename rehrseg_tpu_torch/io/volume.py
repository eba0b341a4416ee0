"""Volume loading, orientation, intensity scaling, HDF5 stores and the SR
outputs: the port's own copy of ``rehrseg_tpu.io.volume``.

:func:`load_volume` returns a :class:`Volume`, the array (or a lazy HDF5
handle) with its anisotropy metadata (slice separation, LR axis, the
slice-profile blur FWHM in voxels); :func:`parse_image` gives the
reference's positional 8-tuple (parse_image_file.py:52-96).
:func:`write_sr_niftis` writes stage-1's pseudo-HR volumes. The HDF5
functions import h5py when called, so the package imports without it; a
host without h5py gets an ImportError naming it at the first HDF5 access.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from . import nifti
from ..ops.blur import blur_fwhm_in_voxels


# ------------------------------------------------------------ intensity

def normalize(x, a=-1, b=1):
    """Affine-map intensities to [a, b]; returns (scaled, orig_min,
    orig_max)."""
    lo = x.min()
    hi = x.max()
    scale = (b - a) / (hi - lo)
    return a + (x - lo) * scale, lo, hi


def inv_normalize(x, orig_min, orig_max, a=-1, b=1):
    """Invert :func:`normalize` given the stored extrema."""
    scale = (orig_max - orig_min) / (b - a)
    return orig_min + (x - a) * scale


# ------------------------------------------------------------ HDF5 store

def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "HDF5 volume stores need h5py, which is not installed") from e
    return h5py


class H5Dataset:
    """Handle to ONE dataset inside an HDF5 file, opened per access (cheap,
    picklable, safe across threads); shape metadata cached eagerly."""

    __slots__ = ("path", "name", "shape", "ndim", "dtype")

    def __init__(self, path: str, name: str):
        self.path = path
        self.name = name
        with _h5py().File(path, "r") as f:
            d = f[name]
            self.shape = tuple(d.shape)
            self.ndim = d.ndim
            self.dtype = d.dtype

    def __getitem__(self, index):
        if index is Ellipsis:
            return self
        with _h5py().File(self.path, "r") as f:
            return f[self.name][index]

    def read(self) -> np.ndarray:
        return self[:]

    def ravel(self) -> np.ndarray:
        return self[:].ravel()


class H5Store:
    """Handle to an HDF5 file of named volumes: ``store["img"]`` yields an
    :class:`H5Dataset`."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def keys(self):
        with _h5py().File(self.path, "r") as f:
            return list(f.keys())

    def __getitem__(self, name: str) -> H5Dataset:
        return H5Dataset(self.path, name)


def write_h5(path: str, **datasets) -> None:
    """Write named arrays to an HDF5 file (stage-intermediate store)."""
    with _h5py().File(path, "w") as f:
        for k, v in datasets.items():
            f.create_dataset(k, data=v)


def read_h5(path: str, *names):
    with _h5py().File(path, "r") as f:
        return tuple(f[n][:] for n in names)


# ------------------------------------------------------------ loading

@dataclass
class Volume:
    """One anisotropic volume plus the metadata every pipeline stage needs.
    ``data`` is a float32 array for NIfTI inputs or an :class:`H5Store`
    (whose header / affine / lr_axis / intensity fields are None)."""

    data: Any
    slice_separation: float
    lr_axis: int | None
    blur_fwhm: float
    header: Any = None
    affine: Any = None
    intensity_min: float | None = None
    intensity_max: float | None = None

    def as_reference_tuple(self):
        """The reference parse_image 8-tuple (parse_image_file.py:52-96)."""
        return (self.data, self.slice_separation, self.lr_axis,
                self.blur_fwhm, self.header, self.affine,
                self.intensity_min, self.intensity_max)


def load_volume(img_file: str, slice_thickness: float,
                target_thickness: float) -> Volume:
    """Open a NIfTI or HDF5 volume with its anisotropy metadata.

    Preserved reference quirk: a 2-long voxel-size tuple selects the LR axis
    by argmax, anything else defaults to axis 0 (parse_image_file.py:57-60).
    """
    path = str(img_file)
    sep = float(slice_thickness / target_thickness)
    fwhm = blur_fwhm_in_voxels(target_thickness, slice_thickness)

    if path.endswith((".nii.gz", ".nii")):
        obj = nifti.load(path)
        zooms = tuple(float(v) for v in obj.header.get_zooms())
        lr_axis = int(np.argmax(zooms)) if len(zooms) == 2 else 0
        image = obj.get_fdata(dtype=np.float32)
        return Volume(image, sep, lr_axis, fwhm, obj.header, obj.affine,
                      image.min(), image.max())
    if path.endswith(".h5"):
        _h5py()
        return Volume(H5Store(path), sep, None, fwhm)
    raise ValueError(f"Unsupported volume file: {img_file}")


def parse_image(img_file: str, slice_thickness: float,
                target_thickness: float):
    """Reference-shaped adapter: returns (image, slice_separation, lr_axis,
    blur_fwhm_voxels, header, affine, orig_min, orig_max)."""
    return load_volume(img_file, slice_thickness,
                       target_thickness).as_reference_tuple()


# ------------------------------------------------------------ orientation

# lr_axis -> (source_axis, destination) np.moveaxis arguments that bring the
# low-resolution axis to position 2 ("z") for a (x, y, z, c) volume
_LR_TO_Z_MOVE = {0: (2, 0), 1: (0, 2)}


def lr_axis_to_z(img: np.ndarray, lr_axis: int) -> np.ndarray:
    """Orient so the low-resolution axis is last-spatial ("z")
    (parse_image_file.py:100-114)."""
    if img.ndim == 5:
        img = np.squeeze(img)
    move = _LR_TO_Z_MOVE.get(lr_axis)
    return np.moveaxis(img, *move) if move else img


def z_axis_to_lr_axis(img: np.ndarray, lr_axis: int) -> np.ndarray:
    """Reverse orientation as the reference does it
    (parse_image_file.py:118-131).

    Preserved quirk: the reference applies the *same* permutation as
    lr_axis_to_z here, not its inverse: an involution only for lr_axis==2.
    """
    if img.ndim == 5:
        img = np.squeeze(img, axis=4)
    move = _LR_TO_Z_MOVE.get(lr_axis)
    return np.moveaxis(img, *move) if move else img


def write_sr_niftis(ref, out_base: str, slice_separation: float, *,
                    img_xyz: np.ndarray | None = None,
                    seg_xyz: np.ndarray | None = None,
                    unc_xyz: np.ndarray | None = None) -> None:
    """Write pseudo-HR SR volumes as ``<out_base>_img/_seg/_uncertainty``
    NIfTIs at HR z-spacing with the source geometry (sr_utils.py:77-101,
    175-196, 225-242).

    ref: an ``nifti.ItkLikeImage`` carrying the source spacing / origin /
    direction. Arrays are (x, y, z); seg binarizes to uint8.
    """
    sp = ref.spacing
    hr_spacing = (sp[0], sp[1], sp[2] / slice_separation)

    def _write(arr_xyz, suffix, dtype):
        nifti.write_image_itk(
            nifti.ItkLikeImage(arr_xyz.transpose(2, 1, 0).astype(dtype),
                               hr_spacing, ref.origin, ref.direction),
            out_base + suffix)

    if img_xyz is not None:
        _write(img_xyz, "_img.nii.gz", np.float32)
    if seg_xyz is not None:
        _write((np.asarray(seg_xyz) > 0).astype(np.uint8),
               "_seg.nii.gz", np.uint8)
    if unc_xyz is not None:
        _write(unc_xyz, "_uncertainty.nii.gz", np.float32)
