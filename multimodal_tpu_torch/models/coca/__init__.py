from multimodal_tpu_torch.models.coca.coca_model import (
    CoCaForPretraining,
    CoCaModel,
    CoCaModelWithHeads,
    MultimodalOutput,
    coca_for_pretraining,
    coca_vit,
    coca_vit_b_32,
    coca_vit_l_14,
)

__all__ = [
    "CoCaForPretraining",
    "CoCaModel",
    "CoCaModelWithHeads",
    "MultimodalOutput",
    "coca_for_pretraining",
    "coca_vit",
    "coca_vit_b_32",
    "coca_vit_l_14",
]
