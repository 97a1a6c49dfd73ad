"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their wrappers,
and the ``mmst_torch`` operators that carry the glue and dropout kernels
into traced programs (registered where each wrapper is).

Importing this package builds nothing: a kernel is compiled at its first
launch (``_build.py``), so the modules import where there is no nvcc.
"""
from . import dropout, fused_conv, gl_glue  # noqa: F401
