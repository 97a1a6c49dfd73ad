"""The forward FLOPs of Spectrogram Diffusion, counted from shapes (2 a
multiply-add, every linear and both attention products), over every
position the program computes: all ``max_length`` note positions, padding
included. Peaks are ``roofline.py``'s."""
from __future__ import annotations


def _encoder_flops(cfg: dict, batch: int, length: int, n_layers: int) -> int:
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    tokens = batch * length
    per_layer = tokens * (4 * d * inner + 3 * d * ff) + 2 * batch * length * length * inner
    return 2 * n_layers * per_layer


def forward_flops(cfg: dict, batch: int) -> int:
    """Matmul FLOPs of one forward at ``batch`` segments."""
    d, inner, ff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    n_notes, n_ctx, n_tgt = cfg["max_length"], cfg["targets_context_length"], cfg["targets_length"]
    flops = _encoder_flops(cfg, batch, n_notes, cfg["num_notes_layers"])
    flops += _encoder_flops(cfg, batch, n_ctx, cfg["num_context_layers"])
    flops += 2 * batch * n_ctx * cfg["input_dims"] * d  # context input projection
    keys = n_notes + n_ctx
    tgt = batch * n_tgt
    per_layer = (tgt * (4 * d * inner + 2 * d * inner + 3 * d * ff)  # self q k v o, cross q o, FF
                 + batch * keys * 2 * d * inner                    # cross k v
                 + 2 * batch * n_tgt * n_tgt * inner               # self q k^T, p v
                 + 2 * batch * n_tgt * keys * inner                # cross q k^T, p v
                 + 2 * batch * 4 * d * 2 * d)                      # two FiLM linears
    flops += 2 * cfg["num_decoder_layers"] * per_layer
    flops += 2 * batch * (d * 4 * d + 4 * d * 4 * d)  # the noise-time MLP
    flops += 2 * tgt * cfg["input_dims"] * d * 2      # input and output projections
    return flops
