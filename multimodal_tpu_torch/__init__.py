"""PyTorch/CUDA port of ``multimodal_tpu`` for NVIDIA Hopper (H100).

The layout mirrors the JAX package: ``multimodal_tpu_torch/ops/fused_encoder.py``
is the counterpart of ``multimodal_tpu/ops/fused_encoder.py`` and so on. The
package imports ``torch`` and ``numpy`` only; it never imports JAX, Flax or
any module of ``multimodal_tpu``. Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""
