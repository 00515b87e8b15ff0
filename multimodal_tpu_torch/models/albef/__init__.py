from multimodal_tpu_torch.models.albef.model import (
    ALBEFModel,
    ALBEFModelWithSimilarity,
    ALBEFOutput,
    ALBEFQueues,
    ALBEFSimilarity,
    ALBEFWithSimilarityOutput,
    albef_forward_with_momentum,
    init_albef_queues,
)

__all__ = [
    "ALBEFModel",
    "ALBEFModelWithSimilarity",
    "ALBEFOutput",
    "ALBEFQueues",
    "ALBEFSimilarity",
    "ALBEFWithSimilarityOutput",
    "albef_forward_with_momentum",
    "init_albef_queues",
]
