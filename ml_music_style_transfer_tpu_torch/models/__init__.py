"""Model families: PerformanceNet (the flagship), the spectrogram
autoencoder and Spectrogram Diffusion."""
from . import autoencoder, layers, performance_net, spectrogram_diffusion  # noqa: F401
from .autoencoder import (AutoencoderConfig, SpectrogramAutoencoder,  # noqa: F401
                          make_autoencoder_train_step)
from .performance_net import PerformanceNet, forward_channel_first, temporal_ladder  # noqa: F401
