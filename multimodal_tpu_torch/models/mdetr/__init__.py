from multimodal_tpu_torch.models.mdetr.model import (
    MDETR,
    MDETRModelOutput,
    mdetr_for_phrase_grounding,
    mdetr_for_vqa,
    mdetr_resnet101,
)

__all__ = [
    "MDETR",
    "MDETRModelOutput",
    "mdetr_for_phrase_grounding",
    "mdetr_for_vqa",
    "mdetr_resnet101",
]
