"""On-disk task snapshots (format v2) and their resharding onto a mesh."""

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,
                                         CheckpointCorruptError,
                                         load_latest_good, load_snapshot,
                                         save_snapshot, snapshot_candidates)
from repro_torch.ckpt.resharding import (reshard_params,
                                         reshard_snapshot_buffers,
                                         reshard_tree)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "load_latest_good",
           "load_snapshot", "reshard_params", "reshard_snapshot_buffers",
           "reshard_tree", "save_snapshot", "snapshot_candidates"]
