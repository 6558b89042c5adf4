"""PyTorch + CUDA port of ``image_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name (``config``, ``ops.gibbs``, ``models.dvae``, ...)
and is held against it by the ``tests/test_torch_*.py`` parity tests.
The Pallas TPU kernel of the serving path becomes a CUDA C++ kernel
(``csrc/gibbs_sweeps.cu``, bound in ``ops/gibbs_cuda.py``), built with
``nvcc`` at first use.

Importing this package imports nothing heavy: submodules are imported by
their callers.
"""
