"""REHRSeg serving path in PyTorch for NVIDIA Hopper (H100).

A port of the ``rehrseg_tpu`` package's serving path: the space-to-depth
packed SegModel forward, the parity, aligned and z-slab streamed
sliding-window engines, ``serve.Segmenter``, and stage-1 SR serving (the
FLAVR UNet3D and WDSR forwards, SR volume inference, ``serve.SRVolumizer``).
The JAX package stays the reference; this package imports none of it and
no JAX. Module paths mirror the JAX package's, so ``rehrseg_tpu.X.Y`` has
its counterpart at ``rehrseg_tpu_torch.X.Y``. Its hand-written CUDA
kernels live in ``csrc/`` and are built at first use by
:mod:`rehrseg_tpu_torch.kernels`.
"""
