"""Bring-up sanitizers (port of pfb_imaging_tpu/utils/debug.py).

  * ``bringup_checks()``: NaN (and optionally Inf) traps on every floating
    output of every aten op inside the block, raising at the op that made
    the first bad value, as JAX's ``jax_debug_nans`` traps at the emitting
    op; the numerics sanitizer for new code paths;
  * ``assert_no_host_sync()``: fails on an operation that makes the host
    wait for the card inside the block (catching accidental
    synchronisation points in solver loops).
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# ops whose outputs are uninitialised memory, not computed values
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_", "set_"}


class _FloatTrap(TorchDispatchMode):
    def __init__(self, nans: bool, infs: bool):
        super().__init__()
        self.nans, self.infs = nans, infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor) or t.device.type == "meta":
                continue
            if not (t.is_floating_point() or t.is_complex()):
                continue
            if self.nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
            if self.infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(f"Inf in the output of {func}")
        return out


@contextmanager
def bringup_checks(nans: bool = True, infs: bool = False):
    """Raise ``FloatingPointError`` at the first aten op inside the block
    whose floating output holds a NaN (and, with ``infs``, an Inf). Each
    check reads a flag back from the device, so this is for bring-up, not
    for timed runs. Nothing is left installed after the block."""
    with _FloatTrap(bool(nans), bool(infs)):
        yield


@contextmanager
def assert_no_host_sync():
    """Fail on an operation that synchronises the host with the card inside
    the block (``torch.cuda.set_sync_debug_mode("error")``, the previous
    mode restored after). Explicit ``torch.cuda.synchronize()`` is not
    flagged. On a machine without a card there is nothing to wait for and
    the block runs unchecked."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
