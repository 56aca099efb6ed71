from setuptools import setup, find_packages

setup(
    name="muse-maskgit-pytorch-tpu",
    packages=find_packages(exclude=["tests*"]),
    package_data={"muse_maskgit_pytorch_tpu_torch": ["csrc/*.cu"]},
    version="0.1.0",
    license="MIT",
    description="Muse: Text-to-Image Generation via Masked Generative Transformers — TPU-native (JAX/XLA/Pallas)",
    long_description_content_type="text/markdown",
    keywords=[
        "artificial intelligence",
        "deep learning",
        "transformers",
        "attention mechanism",
        "text-to-image",
        "tpu",
        "jax",
    ],
    install_requires=[
        "jax",
        "flax>=0.12",
        "optax",
        "orbax-checkpoint",
        "chex",
        "einops>=0.7",
        "numpy",
        "pillow",
    ],
    extras_require={
        "hf": ["transformers", "sentencepiece", "torch", "torchvision"],
        "torch": ["torch>=2.4", "numpy"],
    },
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Developers",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3.10",
    ],
)
