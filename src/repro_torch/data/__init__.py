from repro_torch.data.pipeline import DataConfig, TokenPipeline, curve_dataset

__all__ = ["DataConfig", "TokenPipeline", "curve_dataset"]
