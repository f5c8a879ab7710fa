"""Host fetches of sharded arrays.

Port of the single-process part of pnr_tpu/parallel/multihost.py:
`fetch_replicated`, the one place where the host reads a sharded stage
output. The multi-process runtime (`init_multihost`, `make_global_mesh`,
`shard_volume_global`, `allgather_host_rows`) belongs to a later slice of
the port, on `torch.distributed`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def fetch_replicated(shards: Sequence[torch.Tensor], extent: Optional[int] = None) -> np.ndarray:
    """The shards concatenated along axis 0 on the host, trimmed to the
    first `extent` rows (the volume's before the pipeline padded it to a
    mesh multiple)."""
    out = np.concatenate([t.cpu().numpy() for t in shards], axis=0)
    return out if extent is None else out[:extent]
