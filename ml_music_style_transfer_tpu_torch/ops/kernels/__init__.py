"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their wrappers,
and the ``mmst_torch`` operators that carry them, defined in C++
(``csrc/mmst_ops.cpp``) and loaded by ``_library.ops()``.

Importing this package builds nothing: the operator library is built at
its first use (``_build.py``), so the modules import anywhere.
"""
from . import dropout, fused_conv, gl_glue  # noqa: F401
from ._library import ops  # noqa: F401
