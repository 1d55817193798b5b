"""repro_torch: OpenCHK on PyTorch — directive-style checkpoint/restart for
programs whose state lives in ``torch.Tensor``s, on an NVIDIA H100.

The PyTorch port of the ``repro`` package (JAX on a TPU), which stays the
reference.  The two packages write the same CHK5 containers, so a
checkpoint written by one restores bit-exact in the other.  The block hash
and dirty-block pack and unpack of differential checkpointing, and the
flash attention of the training workload (``repro_torch.launch.train``),
run as hand-written CUDA kernels for sm_90a (``repro_torch.kernels``).
The serving workload (``repro_torch.launch.serve``) checkpoints its decode
state through the same directives and hot-swaps weights published to the
object store (``repro_torch.serve``).
"""
__version__ = "0.1.0"
