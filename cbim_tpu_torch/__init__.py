"""CBIM-Torch: the PyTorch + CUDA port of ``cbim_tpu`` for NVIDIA Hopper.

The port mirrors ``cbim_tpu``'s module layout and names, so each module has
an obvious counterpart.  Modules are ``nn.Module``s over NCDHW (3D) or NCHW
(2D) tensors kept in ``torch.channels_last_3d`` / ``torch.channels_last``
memory (physically N(D)HWC, the layout the kernels read); public functions
that stand in for a ``cbim_tpu`` function take and return that function's
channels-last layout.

The kernels that ``cbim_tpu`` wrote in Pallas for the TPU are CUDA kernels
written for sm_90a (``csrc/``), built with nvcc on first use and bound with
ctypes (``ops/kernels``), each model-path kernel a ``torch.library``
custom op (``torch.ops.cbim.*``) that ``torch.export`` traces.  A wrapper
launches its kernel for a CUDA tensor and runs its plain PyTorch version
for a CPU tensor; there is no fallback from one to the other.

This package imports ``torch`` and never ``jax``, and nothing of
``cbim_tpu``: where it needs a numpy/scipy host module of that package
(NIfTI I/O, resampling), it keeps its own copy.
"""

__version__ = "0.1.0"
