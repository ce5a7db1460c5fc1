from repro_torch.serve.serve_step import generate, sample_token

__all__ = ["generate", "sample_token"]
