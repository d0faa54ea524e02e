"""situation3d_tpu_torch — the PyTorch/CUDA port of ``situation3d_tpu``.

Same directory and module names as the JAX package so a reader finds the
counterpart (``sparse/conv.py`` <-> ``sparse/conv.py``). Plain tensor code is
PyTorch; the kernels the JAX package wrote in Pallas live in ``ops/cuda/``
as hand-written CUDA C++ for Hopper (sources under ``csrc/``, compiled at
first use), each beside a plain PyTorch version of the same function.

The port imports ``torch``, ``numpy`` and the standard library — never
``jax``, and nothing of ``situation3d_tpu``. Entry points take an explicit
``device`` that defaults to ``"cuda"`` and raise when no card is there.
"""

__version__ = "0.1.0"

from situation3d_tpu_torch.config import Config, load_config  # noqa: F401
