"""FISTA with objective-increase backtracking (port of
pfb_imaging_tpu/opt/fista.py).

Used by the NNLS minor cycle. A host loop on tensors, as in JAX: the step
denominator ``beta`` doubles (up to 10x its start) while the smooth
objective increases, then the momentum step and the relative-change stop.
"""

from __future__ import annotations

import math

import torch


def fista(fprime, prox, x0, beta, tol: float = 1e-3, maxit: int = 100, report_freq: int = 10, verbosity: int = 1,
          *, info=None):
    """Minimise f(x) + g(x) with smooth gradient ``fprime`` (returns
    (objective, gradient)) and prox of g. ``beta`` is the Lipschitz estimate.

    Returns the final iterate; the iterations and the backtracking events
    (objective increases that doubled ``beta``) go to ``info["niter"]`` and
    ``info["nbacktrack"]`` when a dict is passed. ``report_freq`` and
    ``verbosity`` keep JAX's positions; neither package's loop logs.
    """
    hessnorm0 = beta
    t = 1.0
    x = x0
    y = x
    eps = 1.0
    fidp, gradp = fprime(x)
    k = nback = 0
    while eps > tol and k < maxit:
        xp = x
        x = prox(y - gradp / beta)
        fid, grad = fprime(x)
        # backtracking: double the step denominator on objective increase
        while float(fid) > float(fidp) and beta < 10 * hessnorm0:
            beta *= 2.0
            nback += 1
            x = prox(y - gradp / beta)
            fid, grad = fprime(x)
        fidp, gradp = fid, grad
        tp = t
        t = (1.0 + math.sqrt(1.0 + 4.0 * tp**2)) / 2.0
        y = x + (tp - 1.0) / t * (x - xp)
        gradp = fprime(y)[1]
        normx = float(torch.linalg.norm(x))
        eps = float(torch.linalg.norm(x - xp)) / normx if normx > 0 else 1.0
        k += 1
    if info is not None:
        info.update(niter=k, nbacktrack=nback, beta=beta)
    return x
