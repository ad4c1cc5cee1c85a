from setuptools import find_packages, setup

setup(
    name="audio-diffusion-tpu",
    packages=find_packages(exclude=["tests", "tests.*"]),
    version="0.1.0",
    license="MIT",
    description="Audio diffusion, TPU-native (JAX/XLA/Pallas)",
    long_description_content_type="text/markdown",
    author="audio-diffusion-tpu contributors",
    url="https://github.com/example/audio-diffusion-tpu",
    keywords=["artificial intelligence", "deep learning",
              "audio generation", "diffusion", "tpu", "jax"],
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax>=0.2",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={
        "text": ["transformers>=4.30"],
        "test": ["pytest", "torch", "hypothesis"],
    },
    entry_points={
        "console_scripts": [
            "audio-diffusion-tpu=audio_diffusion_tpu.cli:main",
        ],
    },
    # Ship the native data-loader source (compiled on demand with g++) and
    # the port's CUDA sources (compiled on demand with nvcc).
    package_data={"audio_diffusion_tpu.data": ["wavio.cpp"],
                  "audio_diffusion_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    include_package_data=True,
    classifiers=[
        "Development Status :: 4 - Beta",
        "Intended Audience :: Developers",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
        "License :: OSI Approved :: MIT License",
        "Programming Language :: Python :: 3.10",
    ],
)
