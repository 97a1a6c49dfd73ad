"""PyTorch/CUDA port of ml_music_style_transfer_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference package: it imports torch,
numpy and scipy, never JAX and nothing of ``ml_music_style_transfer_tpu``
(it keeps its own copies of the framework-neutral host code). Module names
mirror the JAX package so each counterpart is easy to find.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; with no card they raise instead of falling back.

The kernels' ``mmst_torch`` operators, which an exported ``.pt2`` program
names, are defined in C++ (``csrc/mmst_ops.cpp``); ``ops.kernels.ops()``
builds and loads them at first use.
"""
from .ops import kernels as _kernels  # noqa: F401

__version__ = "0.1.0"
