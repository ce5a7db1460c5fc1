from repro_torch.train.data import make_batch

__all__ = ["make_batch"]
