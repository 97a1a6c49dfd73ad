"""The ``mmst_torch`` operator library: loaded once, at first use, and its
launch counters.

``ops()`` builds ``libmmst_ops.so`` if it is missing (``_build.build_all``),
loads it with ``torch.ops.load_library`` (its ``TORCH_LIBRARY`` block
defines the operators and registers their CUDA, CPU and Meta
implementations) and attaches the one thing defined from Python: the
gradient of ``dropout_apply``, all inside the set-up span
``setup.library``. It returns ``torch.ops.mmst_torch``. Every
wrapper in this package calls its operator through it, and
``compat/program_export.load_artifact`` loads it before a program that names
the operators.

The counters live in the library, one per operator entry and device, so a
program run from C++ counts its launches too. ``LaunchCounts`` is the
``LAUNCHES`` mapping of each wrapper module: reading an entry reads the
library's CUDA count for it.
"""
from __future__ import annotations

import collections.abc
import functools

import torch


def ops():
    """``torch.ops.mmst_torch``, the library built and loaded first. While
    PyTorch compiles (a ``while_loop`` body under ``torch.export`` is
    traced by dynamo), the library is loaded already: whoever traces loads
    it first (``compat/program_export``)."""
    if torch.compiler.is_compiling():
        return torch.ops.mmst_torch
    return _load()


@functools.cache
def _load():
    from ...utils.profiling import setup_span
    from . import _build

    with setup_span("setup.library"):
        _build.build_all()
        torch.ops.load_library(_build.ops_library_path())
        torch.library.register_autograd("mmst_torch::dropout_apply", _dropout_backward,
                                        setup_context=_dropout_setup)
    return torch.ops.mmst_torch


# The gradient of x * mask is grad * mask: the operator itself on the
# incoming gradient with ``backward=True``, regenerating the mask from
# (seed, call_index, rate), which is all that is saved.

def _dropout_setup(ctx, inputs, output):
    ctx.dropout_args = inputs[1:4]


def _dropout_backward(ctx, grad):
    g = torch.ops.mmst_torch.dropout_apply(grad.contiguous(), *ctx.dropout_args, True)
    return g, None, None, None, None


def launch_count(entry: str, device: str = "cuda") -> int:
    """How often ``entry``'s CUDA implementation has launched its kernel
    (``device="cuda"``) or its CPU implementation has run (``"cpu"``) in
    this process since the entry's last reset."""
    return ops().launch_count(entry, device)


class LaunchCounts(collections.abc.Mapping):
    """Read-only view of the library's CUDA launch counts of ``entries``."""

    def __init__(self, *entries: str):
        self._entries = entries

    def __getitem__(self, entry: str) -> int:
        if entry not in self._entries:
            raise KeyError(entry)
        return launch_count(entry)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return repr(dict(self))

    def reset(self) -> None:
        """Set every entry's counts, CUDA and CPU, to 0."""
        for entry in self._entries:
            ops().reset_launch_count(entry)
