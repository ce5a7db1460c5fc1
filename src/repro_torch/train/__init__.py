from repro_torch.train.data import DataConfig, PrefetchingLoader, make_batch
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state, lr_at)
from repro_torch.train.train_step import (make_chunked_train_fns,
                                          make_train_state, make_train_step)

__all__ = [
    "DataConfig", "OptConfig", "PrefetchingLoader", "apply_updates",
    "init_opt_state", "lr_at", "make_batch", "make_chunked_train_fns",
    "make_train_state", "make_train_step",
]
