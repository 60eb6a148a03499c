"""One embedding space of a host ``VectorIndex``, resident on the device.

Port of the upload half of ``pql/executor.py::Executor._device_arrays``: a
quant-ready ``SpaceSnapshot`` goes up once — int8 codes, their int32 row sums
of squares (computed on the device from the uploaded codes, so the corpus
crosses the bus once), the row validity, and the f32 rows the rescore reads.
:meth:`DeviceIndex.search` quantizes f32 queries under the snapshot's frozen
scale and runs ``scoring.int8_topk_rescored`` (candidates from the stage
``scoring.candidate_route`` picks by shape — kernel B1 up to 512 queries,
B2 above — then the exact f32 rescore).

The host index stays the source of truth; this is a rebuildable projection
of one snapshot generation.
"""

from __future__ import annotations

import numpy as np
import torch

from panoptikon_tpu_torch.index import VectorIndex
from panoptikon_tpu_torch.ops import codec, scoring


class DeviceIndex:
    """Device arrays of ``index``'s space ``space`` at its current snapshot."""

    def __init__(self, index: VectorIndex, space: str, device: torch.device):
        snap = index.snapshot(space)
        if not snap.quant_ready:
            raise ValueError(f"space {space!r} has no int8 arm at full coverage; run build_quant")
        self.index = index
        self.space = space
        self.scale = float(snap.scale)
        self.size = snap.size
        self.device = device
        self.codes = torch.from_numpy(snap.codes).to(device)
        self.sumsq = scoring.row_sumsq_chunked(self.codes)
        self.row_valid = torch.from_numpy(snap.row_valid).to(device)
        self.vectors = torch.from_numpy(snap.vectors).to(device)
        self._group_ids = snap.group_ids

    def search(self, q_f32: torch.Tensor, k: int, *, oversample: int = 8):
        """Cosine top-k rows for (Q, D) f32 queries on this device.
        Returns (dist (Q, k), row (Q, k), valid (Q, k)) tensors."""
        q_f32 = q_f32.to(self.device, torch.float32)
        q_codes = codec.quantize_int8(q_f32, self.scale)
        return scoring.int8_topk_rescored(
            self.codes, self.sumsq, self.row_valid, self.vectors, q_codes, q_f32,
            k=k, oversample=oversample, distance="cosine", scale=self.scale,
        )

    def item_ids(self, rows: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """Result rows -> DB item ids through the rows' group slots (-1 where
        not valid; a result that is not valid may carry a sentinel row)."""
        ok = valid.cpu().numpy()
        rows_np = np.where(ok, rows.cpu().numpy(), 0)
        slots = np.where(ok, self._group_ids[rows_np], -1)
        return self.index.item_id_of_groups(self.space, slots)
