"""On-disk task snapshots (format v2; resharding waits for the mesh)."""

from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,
                                         CheckpointCorruptError,
                                         load_latest_good, load_snapshot,
                                         save_snapshot, snapshot_candidates)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "load_latest_good",
           "load_snapshot", "save_snapshot", "snapshot_candidates"]
