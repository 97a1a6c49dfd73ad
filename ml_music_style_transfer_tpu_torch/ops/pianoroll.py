"""Piano-roll ops on tensors: the port of the JAX package's
``ops/pianoroll.py`` (``binarize`` :23, ``onset_offset`` :29,
``notes_to_pianoroll`` :42).

Counterparts of ``midi/pianoroll.py`` for rolls that are built or
transformed on the device:
  - ``onset_offset``: the frame diff that replaces the reference's O(T)
    Python loop (preprocessing/preprocess.py:150-155);
  - ``notes_to_pianoroll``: rasterization from padded note-event arrays, a
    (frames x notes) interval mask times a (notes x 128) one-hot, so no
    scatter.

Shapes are (..., T, 128). Each function runs on the device of its input.
"""
from __future__ import annotations

import torch

N_PITCHES = 128


def binarize(roll: torch.Tensor) -> torch.Tensor:
    """roll[nonzero] = 1 (reference preprocess.py:148)."""
    return (roll != 0).to(roll.dtype)


def onset_offset(binary_roll: torch.Tensor) -> torch.Tensor:
    """(..., T, 128) binarized roll -> onset/offset matrix in {-1, 0, +1}.

    Frame 0: +1 where active. Frame i > 0: +1 on a note-on edge, -1 on a
    note-off edge (the reference loop, and ``midi.pianoroll.onset_offset``).
    """
    active = binary_roll != 0
    prev = torch.zeros_like(active)
    prev[..., 1:, :] = active[..., :-1, :]
    onoff = (active & ~prev).to(torch.float32) - (~active & prev).to(torch.float32)
    return onoff.to(binary_roll.dtype)


def notes_to_pianoroll(
    pitches: torch.Tensor,
    velocities: torch.Tensor,
    starts: torch.Tensor,
    ends: torch.Tensor,
    fs: int,
    length: int,
) -> torch.Tensor:
    """Rasterize padded note arrays into a (length, 128) float32 velocity roll.

    Inputs are 1-D arrays of one size (pad unused slots with velocity 0). A
    note covers frames [floor(start*fs), floor(end*fs)), as
    ``midi.pianoroll.notes_to_pianoroll``; overlapping notes of one pitch
    add their velocities.
    """
    s = torch.floor(starts.to(torch.float32) * fs).to(torch.int32)
    e = torch.floor(ends.to(torch.float32) * fs).to(torch.int32)
    frames = torch.arange(length, dtype=torch.int32, device=pitches.device)[:, None]
    inside = (frames >= s[None, :]) & (frames < e[None, :])  # (T, n_notes)
    contrib = inside.to(torch.float32) * velocities[None, :].to(torch.float32)
    onehot = torch.nn.functional.one_hot(pitches.long(), N_PITCHES).to(torch.float32)
    return contrib @ onehot
