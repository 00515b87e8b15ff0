"""FLAVA scaling configurations (900M -> 10B). A copy of
``multimodal_tpu/models/flava/configs.py``: keyword arguments of
``flava_model`` / ``flava_model_for_pretraining``. The mixture-of-experts
entries are refused by the port's builders until MoE is ported (ROADMAP.md,
queues A4 and A7).
"""

from __future__ import annotations

from typing import Any, Dict


def _cfg(layers: int, hidden: int, ffn: int, heads: int, mm_layers: int) -> Dict[str, Any]:
    return dict(
        image_num_hidden_layers=layers,
        image_hidden_size=hidden,
        image_intermediate_size=ffn,
        image_num_attention_heads=heads,
        text_num_hidden_layers=layers,
        text_hidden_size=hidden,
        text_intermediate_size=ffn,
        text_num_attention_heads=heads,
        multimodal_num_hidden_layers=mm_layers,
        multimodal_hidden_size=hidden,
        multimodal_intermediate_size=ffn,
        multimodal_num_attention_heads=heads,
        text_and_image_proj_size=hidden,
    )


FLAVA_CONFIGS: Dict[str, Dict[str, Any]] = {
    # name: (tower layers, hidden, ffn, heads, mm layers) per reference yaml
    "base": {},  # library defaults (12L/768)
    "900m": _cfg(24, 1024, 4096, 16, 12),
    "1.8b": _cfg(32, 1280, 5120, 16, 16),
    "2.7b": _cfg(40, 1408, 6144, 16, 20),
    "4.8b": _cfg(48, 1664, 8192, 16, 24),
    "10b": _cfg(64, 2048, 10240, 16, 40),
    # Mixture-of-experts towers: every 2nd layer of all three encoders swaps
    # its MLP for a top-2 MoE with experts over the ``ep`` mesh axis.
    "base-moe-8e": dict(
        moe_num_experts=8, moe_top_k=2, moe_interval=2, ep_axis_name="ep"
    ),
    "900m-moe-8e": dict(
        _cfg(24, 1024, 4096, 16, 12),
        moe_num_experts=8, moe_top_k=2, moe_interval=2, ep_axis_name="ep",
    ),
}
