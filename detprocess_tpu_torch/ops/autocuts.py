"""Automated quality cuts on trace batches: iterated sigma clips.

Port of ``detprocess_tpu/ops/autocuts.py`` (``_clip_pass`` :38,
``_iterative_cut`` :50, ``autocuts`` :72, ``autocuts_noise`` :103,
``autocuts_didv`` :110), the replacement of qetpy.autocuts_noise and
autocuts_didv (reference call sites detprocess/core/noise.py:331,
core/didv.py:1631).

Per trace, four metrics in this order: ``std`` (population RMS, ddof 0),
``range`` (max − min), ``slope`` (the mean of the last ``n // 10``
samples minus that of the first) and ``baseline`` (the mean). Each is
clipped in turn: keep the traces within ``nsigma`` standard deviations
(+ 1e-30) of the kept traces' mean, and repeat. ``niter=None`` repeats
until the mask no longer changes, the clip's exact fixed point: the mask
only shrinks, so the loop ends; the host reads one flag a pass. An int
runs that many passes.

The metrics and passes are torch ops on the traces' device (reductions,
not kernels of the JAX package). For [B, C, N] the channels are clipped
independently, batched as a [C, B] mask, and a trace passes only if
every channel passes. ``remove_mean`` (dIdV data) subtracts each
channel's batch mean first.
"""

from __future__ import annotations

from typing import Optional

import torch

METRICS = ("std", "range", "slope", "baseline")


def metrics(traces: torch.Tensor, remove_mean: bool = False) -> torch.Tensor:
    """The metrics [4, ..., B] of traces [B, N] or [B, C, N] (then
    [4, C, B]), in :data:`METRICS` order."""
    x = traces if traces.ndim == 3 else traces[:, None, :]
    if remove_mean:
        x = x - x.mean(dim=0, keepdim=True)
    n = x.shape[-1]
    k = max(n // 10, 1)
    out = torch.stack([
        x.std(dim=-1, correction=0),
        x.amax(dim=-1) - x.amin(dim=-1),
        x[..., -k:].mean(dim=-1) - x[..., :k].mean(dim=-1),
        x.mean(dim=-1),
    ]).transpose(1, 2)                                   # [4, C, B]
    return out if traces.ndim == 3 else out[:, 0]


def clip_pass(metric: torch.Tensor, mask: torch.Tensor,
              nsigma: float) -> torch.Tensor:
    """One sigma-clip pass over the last axis: keep the entries within
    ``nsigma`` of the masked mean and standard deviation."""
    m = mask.to(metric.dtype)
    cnt = m.sum(dim=-1, keepdim=True).clamp(min=1)
    mean = (metric * m).sum(dim=-1, keepdim=True) / cnt
    std = torch.sqrt(((metric - mean) ** 2 * m).sum(dim=-1, keepdim=True)
                     / cnt)
    return mask & ((metric - mean).abs() <= nsigma * std + 1e-30)


def iterative_cut(metric: torch.Tensor, mask: torch.Tensor, nsigma: float,
                  niter: Optional[int]):
    """(mask, passes) of one metric clipped ``niter`` times, or to its
    fixed point for None. Rows of a [C, B] metric clip independently;
    ``passes`` ([C], or a 0-d tensor for [B]) counts each row's passes
    to its fixed point, the last one, which changed nothing, included."""
    passes = torch.zeros(metric.shape[:-1], dtype=torch.int64)
    if niter is not None:
        for _ in range(niter):
            mask = clip_pass(metric, mask, nsigma)
        return mask, passes + niter
    done = torch.zeros(metric.shape[:-1], dtype=torch.bool)
    while True:
        new = clip_pass(metric, mask, nsigma)
        passes += ~done
        # a row whose pass changed nothing is at its fixed point
        done |= ~(new != mask).any(dim=-1).cpu()
        if bool(done.all()):
            return new, passes
        mask = new


def cut_stages(metric_stack: torch.Tensor, nsigma: float = 2.5,
               niter: Optional[int] = None):
    """(stage masks [4, ..., B], passes per metric): the keep-mask after
    each metric's clip, each clip starting from the previous mask."""
    mask = torch.ones(metric_stack.shape[1:], dtype=torch.bool,
                      device=metric_stack.device)
    stages, passes = [], []
    for metric in metric_stack:
        mask, p = iterative_cut(metric, mask, nsigma, niter)
        stages.append(mask)
        passes.append(p)
    return torch.stack(stages), passes


def autocuts(traces: torch.Tensor, nsigma: float = 2.5,
             niter: Optional[int] = None,
             remove_mean: bool = False) -> torch.Tensor:
    """Keep-mask [B] of traces [B, N], or of [B, C, N] where a trace
    passes only if every channel passes."""
    stages, _ = cut_stages(metrics(traces, remove_mean), nsigma, niter)
    final = stages[-1]
    return final.all(dim=0) if traces.ndim == 3 else final


def autocuts_noise(traces: torch.Tensor, nsigma: float = 2.5,
                   niter: Optional[int] = None) -> torch.Tensor:
    """Quality cuts for noise randoms (qetpy.autocuts_noise)."""
    return autocuts(traces, nsigma=nsigma, niter=niter, remove_mean=False)


def autocuts_didv(traces: torch.Tensor, nsigma: float = 2.5,
                  niter: Optional[int] = None) -> torch.Tensor:
    """Quality cuts for dIdV square-wave data, on the traces less their
    batch-mean response (qetpy.autocuts_didv)."""
    return autocuts(traces, nsigma=nsigma, niter=niter, remove_mean=True)
