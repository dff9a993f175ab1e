from repro_torch.models.build import Model, build_model

__all__ = ["Model", "build_model"]
