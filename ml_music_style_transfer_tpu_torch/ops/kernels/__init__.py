"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their wrappers.

Importing this package builds nothing: a kernel is compiled at its first
launch (``_build.py``), so the modules import where there is no nvcc.
"""
from . import dropout, fused_conv, gl_glue  # noqa: F401
