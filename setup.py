"""Build the native host-side extensions:
    python setup.py build_ext --inplace
"""

from setuptools import Extension, setup

setup(
    name="catre_tpu",
    version="0.1.0",
    packages=["catre_tpu", "catre_tpu_torch"],
    ext_modules=[
        Extension(
            "catre_tpu.native._catre_rle",
            sources=["catre_tpu/native/rle.c"],
            extra_compile_args=["-O3"],
        ),
    ],
)
