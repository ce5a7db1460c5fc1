from repro_torch.serve.serve_step import generate

__all__ = ["generate"]
