"""PyTorch + CUDA port of ``image_generation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name (``config``, ``ops.gibbs``, ``models.dvae``, ...)
and is held against it by the ``tests/test_torch_*.py`` parity tests.
The Pallas TPU kernel of the serving and training paths becomes a CUDA
C++ kernel, the sparse field gather (``csrc/gibbs_sparse.cu``, with the
parallel-tempering energy carry, bound in ``ops/gibbs_sparse.py`` and
reached through ``ops/gibbs_cuda.py``), built with ``nvcc`` at first use.
Ported: warm serving (``app.warm``), training (``training.trainer``)
under plain Gibbs and parallel tempering, the sampler backends
(``samplers``) and the CLI (``python -m image_generation_tpu_torch.app.cli``).

Importing this package imports nothing heavy: submodules are imported by
their callers.
"""
