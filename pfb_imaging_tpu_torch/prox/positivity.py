"""Positivity proxes (port of pfb_imaging_tpu/prox/positivity.py)."""

from __future__ import annotations

import torch


def positivity(x):
    """Mode 1: clamp negative values to zero."""
    return torch.clamp(x, min=0.0)


def positivity_band(x):
    """Mode 2: zero a pixel in all bands where any band is <= 0."""
    bad = (x <= 0.0).any(dim=0, keepdim=True)
    return torch.where(bad, torch.zeros_like(x), x)


def positivity_prox(mode: int):
    """Map the CLI positivity mode to a prox callable (or None)."""
    if mode == 0:
        return None
    if mode == 1:
        return positivity
    if mode == 2:
        return positivity_band
    raise ValueError(f"Unknown positivity mode {mode}")
