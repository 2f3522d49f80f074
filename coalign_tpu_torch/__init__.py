"""coalign_tpu_torch — the PyTorch/CUDA port of coalign_tpu.

The port runs beside the JAX package and is checked against it: the same
inputs and the same weights give the same outputs within the tolerances the
JAX tests use. It imports torch, numpy and yaml, never jax and never
coalign_tpu.

Layout and conventions:
  * Feature maps are NCHW, as in the opencood reference and cuDNN; the batch
    dict at the public entry points is the JAX package's: points (B, L, N, 4),
    point_mask (B, L, N), agent_mask (B, L), pairwise_t_matrix
    (B, L, L, 4, 4), transformation_matrix (B, 4, 4).
  * Module parameter names are the reference opencood state-dict keys, so
    reference checkpoints load with ``load_state_dict(strict=True)``.
  * Entry points take ``device=`` and default to CUDA; without a GPU they
    raise unless the caller passes ``device="cpu"``
    (:func:`coalign_tpu_torch.runtime.resolve_device`).
  * Every TPU kernel of the JAX package has a hand-written CUDA counterpart
    under ``csrc/``, wrapped in ``kernels/``, with a plain PyTorch version
    beside it that CPU tensors take.
"""

__version__ = "0.1.0"
