"""Pixel-mask linear operator (port of pfb_imaging_tpu/ops/mask.py): maps
between full images and the vector of unmasked components, an index gather
and its transpose, a scatter into zeros."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


class Mask:
    """image <-> unmasked-component vector, the indices on ``device``."""

    def __init__(self, mask, *, device="cuda"):
        mask = np.asarray(mask)
        self.shape = mask.shape
        self.idx = torch.from_numpy(np.nonzero(mask.ravel())[0]).to(resolve_device(device))
        self.nnz = int(self.idx.numel())

    def dot(self, x):
        """(nx, ny) image -> (nnz,) components."""
        return x.reshape(-1)[self.idx]

    def hdot(self, beta):
        """(nnz,) components -> (nx, ny) image."""
        flat = torch.zeros(int(np.prod(self.shape)), dtype=beta.dtype, device=beta.device)
        return flat.index_copy(0, self.idx, beta).reshape(self.shape)
