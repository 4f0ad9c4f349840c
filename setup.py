"""pygcn_tpu packaging: pure-Python package + optional native graphkit lib."""

import subprocess
from pathlib import Path

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


class BuildNative(build_py):
    def run(self):
        script = Path(__file__).parent / "native" / "build.sh"
        if script.exists():
            try:
                subprocess.run(["sh", str(script)], check=True)
            except subprocess.SubprocessError:
                print("warning: native graphkit build failed; NumPy fallbacks active")
        super().run()


setup(
    name="pygcn_tpu",
    version="0.1.0",
    description=(
        "TPU-native graph neural network framework (JAX/XLA/Pallas): "
        "GCN model zoo, sparse engine, distributed halo-exchange SpMM, "
        "epidemic-simulation workloads, policy generators"
    ),
    packages=find_packages(include=["pygcn_tpu", "pygcn_tpu.*",
                                    "pygcn_tpu_torch", "pygcn_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these sources at first use
    package_data={"pygcn_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "scipy", "optax"],
    extras_require={
        "data": ["pandas", "scikit-learn", "networkx", "h5py", "matplotlib"],
        "test": ["pytest", "torch"],
    },
    cmdclass={"build_py": BuildNative},
)
