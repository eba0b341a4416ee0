"""Multi-device execution (``rehrseg_tpu.parallel``): meshes for the
TTA-sharded engine, data parallelism over ``torch.distributed``, and
fold-parallel training."""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
