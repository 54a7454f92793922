"""Work counts of the IDG kernels and the chip's published peaks.

The counts are of the work the inputs need, not of the implementation:
padded slots and groups, repeated passes for precision, and the
implementation's own CSR, ``order[]`` and scratch are not counted, so a
kernel that drops any of them keeps its count and reads a higher share.

- Operations: 8 a complex multiply-add, counted once. B1 (patches from
  values) and B2 (values from patches) take S^2 of them for each slot that
  holds a visibility with weight, and the taper-DFT's 2 S^3 for each group
  that holds such a slot.
- Bytes, each read once and each written once: B1 and B2 move the values of
  those slots (one complex64 each) and the S x S complex64 patch of those
  groups; K1 (assembly, its chunk sums included) reads the patches of a
  bin's groups and writes the bin's grid, K2 reads the grid and writes the
  patches. K1 adds 2 operations a patch element (a complex add).
- The least time is the larger of operations / TF32_FLOPS and bytes /
  HBM_BYTES_PER_S.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
COMPLEX64 = 8


def live_slots(cg_idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """(ng, G) bool: the slots whose visibility carries weight. ``cg_idx``
    holds each slot's flat visibility index (``nvis`` marks an empty slot);
    ``wgt`` the weights of those visibilities, flat (nvis,)."""
    w = torch.cat([wgt.reshape(-1).to(torch.float64), wgt.new_zeros(1, dtype=torch.float64)])
    return w[cg_idx.clamp(max=w.numel() - 1)] != 0


def idg_counts(cg_idx: torch.Tensor, bid_bins: list, wgt: torch.Tensor, S: int, nbig: tuple) -> dict:
    """Work of one B1, one B2 and every bin's K1 and K2 over one band's plan.

    ``cg_idx`` (ng, G) slot -> visibility (``nvis`` for an empty slot),
    ``bid_bins`` the (start, count) group range of each bin, ``wgt`` (nvis,)
    the weights, ``nbig`` the bins' grid shape. Returns operations and bytes
    of each kernel family."""
    live = live_slots(cg_idx, wgt)
    per_group = live.sum(1)
    slots = int(per_group.sum())
    groups = int((per_group > 0).sum())
    patch = COMPLEX64 * S * S
    b12_ops = 8 * (S * S * slots + 2 * S**3 * groups)
    b12_bytes = COMPLEX64 * slots + patch * groups
    grid = COMPLEX64 * nbig[0] * nbig[1]
    k_bytes, k1_ops = 0, 0
    for g0, gc in bid_bins:
        g = int((per_group[g0 : g0 + gc] > 0).sum())
        if g:
            k_bytes += patch * g + grid
            k1_ops += 2 * S * S * g
    return dict(b1=(b12_ops, b12_bytes), b2=(b12_ops, b12_bytes), k1=(k1_ops, k_bytes), k2=(0, k_bytes))


def plan_counts(plan, wgt) -> dict:
    """:func:`idg_counts` of a plan with ``cg_idx``, ``bin_gstart``,
    ``bin_gcount``, ``S``, ``nbig_x``, ``nbig_y`` and weights (nrow, nchan)
    of its visibilities."""
    bins = list(zip(plan.bin_gstart, plan.bin_gcount))
    return idg_counts(plan.cg_idx, bins, torch.as_tensor(wgt, device=plan.cg_idx.device), plan.S,
                      (plan.nbig_x, plan.nbig_y))


def add_counts(total: dict, more: dict, times: int = 1) -> dict:
    for k, (ops, nbytes) in more.items():
        o, b = total.get(k, (0, 0))
        total[k] = (o + times * ops, b + times * nbytes)
    return total


def bound_seconds(ops: float, nbytes: float) -> float:
    return max(ops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


def roofline_percent(ops: float, nbytes: float, device_seconds: float):
    """Share of the roofline in percent, or None where nothing ran."""
    if device_seconds <= 0 or (ops <= 0 and nbytes <= 0):
        return None
    return 100.0 * bound_seconds(ops, nbytes) / device_seconds
