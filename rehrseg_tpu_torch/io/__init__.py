from . import nifti  # noqa: F401
