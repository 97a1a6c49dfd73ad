"""Plain PyTorch/NumPy reference of the port's served and trained paths.

Frozen copies of the arithmetic, written without any of the port's code:
PerformanceNet and the autoencoder as functions of a parameter dict
(``nets``), the STFT, Griffin-Lim, the mel bank and the piano roll
(``dsp``), the Philox dropout mask (``philox``), Adam and the losses
(``steps``). Nothing here imports the port, JAX or the JAX package.
"""
