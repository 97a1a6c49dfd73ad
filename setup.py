"""Package install for ml_music_style_transfer_tpu (pip install -e .)."""
from setuptools import find_packages, setup

setup(
    name="ml_music_style_transfer_tpu",
    version="0.1.0",
    description="TPU-native piano timbre style-transfer framework (JAX/XLA/Pallas)",
    packages=find_packages(include=["ml_music_style_transfer_tpu*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"ml_music_style_transfer_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy", "scipy", "h5py"],
    entry_points={
        "console_scripts": [
            "mmst-preprocess=ml_music_style_transfer_tpu.data.preprocess:cli",
            "mmst-train=ml_music_style_transfer_tpu.train.cli:main",
            "mmst-infer=ml_music_style_transfer_tpu.infer.cli:main",
        ]
    },
)
