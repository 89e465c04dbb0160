"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of `deeplearning4j_tpu`.

The JAX package stays the reference; this package mirrors its module
paths (``ops/paged_attention.py`` here is the counterpart of
``deeplearning4j_tpu/ops/paged_attention.py`` there) and keeps only what
the ported slices need.  It imports torch and numpy, never jax and never
the JAX package.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of silently
falling back.  Every Pallas kernel of a ported slice is a hand-written
Hopper kernel under ``csrc/``, built at first use (see
``runtime/kernels.py``); on CPU tensors each kernel wrapper runs the
plain PyTorch version that sits beside it.
"""

__version__ = "0.1.0"
