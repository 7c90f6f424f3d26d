"""yugabyte_tpu_torch: the PyTorch/CUDA port of yugabyte_tpu.

The JAX package `yugabyte_tpu` stays the reference; this package grows
beside it slice by slice, with the same module paths, and imports neither
`jax` nor anything of `yugabyte_tpu`. Its device code is PyTorch plus
kernels written by hand in CUDA C++ for Hopper (`csrc/`, built with nvcc
at first use); every kernel has a plain PyTorch version beside it, which
is what runs for tensors on the CPU.

Slice 1 (this tree): disk-to-disk L0->L1 compaction through
`storage.compaction.run_compaction_job_device_native` with the native
byte shell, no device cache, no run cache and no device block codec.

This module imports nothing heavy: import the submodules you need.
"""

__version__ = "0.1.0"
