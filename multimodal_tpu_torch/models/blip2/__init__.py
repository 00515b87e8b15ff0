from multimodal_tpu_torch.models.blip2.blip2 import BLIP2, Blip2Output
from multimodal_tpu_torch.models.blip2.qformer_model import QformerForCLM, QformerModel

__all__ = ["BLIP2", "Blip2Output", "QformerForCLM", "QformerModel"]
