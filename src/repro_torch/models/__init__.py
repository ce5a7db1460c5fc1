from repro_torch.models.model_zoo import ModelBundle, build_model

__all__ = ["ModelBundle", "build_model"]
