"""jn_cuclark_tpu_torch — the CLARK-family metagenomic classifier on PyTorch
and CUDA (NVIDIA Hopper).

A port of the JAX package `jn_cuclark_tpu`, which stays beside it as the
reference.  Module paths and public names follow that package.  This
package imports torch and never jax, and never imports `jn_cuclark_tpu`
(whose import turns on jax's x64 mode).  Host code (scan, pack, `%g`
formatting) is the repository's native C++ runtime, compiled from source at
first use; the device step runs hand-written CUDA kernels
(ops/kernels/classify.cu) on a CUDA device and their plain-PyTorch twins on
the CPU.

Ported so far: `classify` (single-end, paired-end, extended; the table
resident, dense or cycled; over a mesh of devices), the `db` workflows
(set-targets, build, the taxonomy and genome downloads, clean), and the
tools `abundance`, `merge`, `report` and `verify` (README's port section
lists the slices).
"""

from . import params  # noqa: F401

__version__ = "0.1.0"
