"""Model zoo (port of ``repro.models``): dense GQA, MoE, SSM (RWKV6),
hybrid (Zamba2/Mamba2), enc-dec (Whisper), VLM (LLaVA), as
``nn.Module``s on explicit devices."""
from repro_torch.models.registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
