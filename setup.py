"""Packaging for mxnet_tpu (parity: tools/pip_package/ — the reference
ships a setup.py bundling libmxnet.so; here the package is pure python
over jax plus the optional native runtime built by `make`, whose .so is
included as package data when present).

    python setup.py sdist          # source dist
    pip install -e .               # editable install (no deps forced)
"""
import os

from setuptools import find_packages, setup

HERE = os.path.dirname(os.path.abspath(__file__))


def _version():
    # single source: mxnet_tpu/__init__.py __version__
    with open(os.path.join(HERE, "mxnet_tpu", "__init__.py")) as f:
        for line in f:
            if line.startswith("__version__"):
                v = line.split("=")[1].strip().strip("\"'")
                # PEP 440: '1.0.0.tpu0' -> '1.0.0+tpu0' local version
                parts = v.rsplit(".", 1)
                if len(parts) == 2 and not parts[1].isdigit():
                    v = parts[0] + "+" + parts[1]
                return v
    return "0.0.0"


setup(
    name="mxnet-tpu",
    version=_version(),
    description="TPU-native reimplementation of the MXNet API on "
                "jax/XLA/Pallas",
    long_description=open(os.path.join(HERE, "README.md")).read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["_native/*.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"full": ["flax", "optax", "orbax-checkpoint"]},
    entry_points={"console_scripts": []},
    license="Apache-2.0",
)
