"""Model zoo (port of ``repro.models``): the decoder transformer families —
dense GQA, MoE and VLM (LLaVA) — as ``nn.Module``s on explicit devices."""
from repro_torch.models.registry import ModelAPI, get_model

__all__ = ["ModelAPI", "get_model"]
