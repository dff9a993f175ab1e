from repro_torch.data.pipeline import DataConfig, MemmapSource, Pipeline, SyntheticSource, make_source

__all__ = ["DataConfig", "MemmapSource", "Pipeline", "SyntheticSource", "make_source"]
