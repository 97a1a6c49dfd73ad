"""The program's configuration objects built from a configuration file,
checked against the widths the file states (so a run is of the
configuration it names)."""
from __future__ import annotations


def performancenet(cfg: dict):
    from ml_music_style_transfer_tpu_torch.config import ModelConfig

    mc = ModelConfig(depth=cfg["depth"], start_channels=cfg["start_channels"],
                     start_audio_channels=cfg["start_audio_channels"],
                     onset_encoder_depth=cfg["onset_encoder_depth"],
                     dropout_rate=cfg["dropout_rate"], leaky_relu_slope=cfg["leaky_relu_slope"],
                     instance_norm_eps=cfg["instance_norm_eps"],
                     width_mult=cfg.get("width_mult", 1.0),
                     compat_mbr_noop=cfg["compat_mbr_noop"], compute_dtype=cfg["compute_dtype"])
    got = (list(mc.midi_channel_plan), list(mc.audio_channel_plan))
    if got != (cfg["midi_channel_plan"], cfg["audio_channel_plan"]):
        raise ValueError(f"the program's channel plans {got} are not the configuration's")
    return mc


def autoencoder(cfg: dict):
    from ml_music_style_transfer_tpu_torch.models.autoencoder import AutoencoderConfig

    return AutoencoderConfig(n_bins=cfg["n_bins"], width=cfg["width"],
                             compute_dtype=cfg["compute_dtype"])
