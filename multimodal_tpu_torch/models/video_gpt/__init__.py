from multimodal_tpu_torch.models.video_gpt.model import video_gpt, video_vqvae

__all__ = ["video_gpt", "video_vqvae"]
