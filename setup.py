"""Packaging for the TPU-native RNb-NeuS2 framework.

Console script `rnb-neus2` matches the reference package's entry point
(reference setup.py:21-25); `rnb-neus2-testbed` exposes the testbed CLI
that the reference ships as a compiled binary. `rnb_neus2_torch` is the
PyTorch/CUDA port; its CUDA sources (`csrc/*.cu`) are built with nvcc and
its host sources (`native/*.cc`) with g++ at first use. Its console
scripts are `rnb-neus2-torch` (the pipeline) and `rnb-neus2-torch-testbed`
(the testbed CLI).
"""

from setuptools import find_packages, setup

setup(
    name="rnb-neus2-tpu",
    version="2.0.0",
    description=("TPU-native multi-view normal/albedo surface "
                 "reconstruction (NeuS2-style neural SDF)"),
    packages=find_packages(include=["rnb_neus2_tpu", "rnb_neus2_tpu.*",
                                    "rnb_neus2_torch", "rnb_neus2_torch.*"]),
    py_modules=["run_pipeline"],
    package_data={"rnb_neus2_tpu": ["configs/*/*.json"],
                  "rnb_neus2_torch": ["csrc/*.cu", "csrc/*.cuh",
                                      "native/*.cc", "configs/*/*.json",
                                      "meshroom/*.py"]},
    python_requires=">=3.10",
    install_requires=[
        "numpy",
        "jax",
        "flax",
        "optax",
        "opencv-python-headless",
        "scipy",
        "torch",
    ],
    entry_points={
        "console_scripts": [
            "rnb-neus2=run_pipeline:main",
            "rnb-neus2-testbed=rnb_neus2_tpu.cli.testbed:main",
            "rnb-neus2-torch=rnb_neus2_torch.cli.run_pipeline:main",
            "rnb-neus2-torch-testbed=rnb_neus2_torch.cli.testbed:main",
        ],
    },
)
