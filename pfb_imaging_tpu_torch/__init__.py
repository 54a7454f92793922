"""PyTorch/CUDA port of pfb_imaging_tpu for NVIDIA Hopper (H100).

The JAX package ``pfb_imaging_tpu`` beside this one is the reference; this
package mirrors its layout (``ops/``, ``opt/``, ``prox/``, ``deconv/``,
``core/``) and function names so each counterpart is easy to find.

Idiom: plain functions on tensors (the band axis written out where JAX
vmapped it), Python loops where JAX used ``lax.while_loop``, an explicit
``device`` argument wherever tensors are created, explicit
``torch.Generator`` objects for randomness.

Dtype policy: f64 on the CPU (parity with the JAX x64 tests), f32 on CUDA.
TF32 is switched off for matmuls AND cuDNN convolutions at import: the
SARA wavelet convs feed the dot/hdot adjoint that primal-dual relies on,
and cuDNN's TF32 default (~3 decimal digits) would break it — Hopper's
version of the bf16-conv trap that ops/wavelets.py fixed on the TPU.

Hand-written CUDA kernels live in ``csrc/`` and are built at first use by
``kernels/build.py``; no kernel is built or imported at module import.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import span

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def set_envs(nthreads: int | None = None, enable_x64: bool = False) -> None:
    """Process bootstrap with the JAX package's arguments: ``nthreads`` sets
    ``OMP_NUM_THREADS`` where it is unset. ``enable_x64`` has nothing to
    switch here: the working type follows the device (:func:`real_dtype`)."""
    import os

    if nthreads is not None:
        os.environ.setdefault("OMP_NUM_THREADS", str(nthreads))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a card raises
    (entry points default to the card and never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def real_dtype(device) -> torch.dtype:
    """The working real dtype on ``device``: f64 on CPU, f32 on CUDA."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def checked_real_dtype(device, double_precision: bool | None = None) -> torch.dtype:
    """:func:`real_dtype` for an entry point that takes JAX's ``double_precision``:
    None means the device's type; the device's own type may be named; the
    other is refused, before any tensor is made (the card's IDG kernels are
    f32-only, and the CPU runs the f64 of the JAX x64 parity runs)."""
    rdt = real_dtype(device)
    if double_precision is not None and bool(double_precision) != (rdt == torch.float64):
        raise ValueError(f"double_precision={double_precision!r} on {torch.device(device).type}: the port computes "
                         f"in {'f64' if rdt == torch.float64 else 'f32'} there; pass None")
    return rdt


def complex_dtype(real: torch.dtype) -> torch.dtype:
    return torch.complex64 if real == torch.float32 else torch.complex128


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64, torch.int64: np.int64,
             torch.complex64: np.complex64, torch.complex128: np.complex128}


def to_device(a, device, dtype: torch.dtype) -> torch.Tensor:
    """Array-like -> tensor on ``device`` in ``dtype``, cast on the host
    first so a single copy of the final size crosses to the device."""
    return torch.from_numpy(np.array(a, dtype=_NP_DTYPE[dtype])).to(device)


def as_device(a, device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`to_device` for an array-like, ``Tensor.to`` for a tensor (no
    copy when it is already there in ``dtype``)."""
    return a.to(device=device, dtype=dtype) if torch.is_tensor(a) else to_device(a, device, dtype)


def to_device_async(a, device, dtype: torch.dtype) -> torch.Tensor:
    """:func:`to_device` that does not make the host wait for a card: the
    array is cast into pinned host memory and copied on the current stream,
    so the host goes on (reading the next input, queueing the next launch)
    while the card works. The caching host allocator holds the pinned
    buffer until its copy is done."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return to_device(a, dev, dtype)
    a = np.asarray(a)
    host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    host.numpy()[...] = a
    return host.to(dev, non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array of its dtype; from a card through pinned
    host memory, with one wait for the stream."""
    if t.device.type != "cuda":
        return t.numpy()
    with span("fetch"):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()
