"""Example user feature-extractor plug-in for the PyTorch port.

The torch twin of ``custom_extractor.py``: the same ``pulse_shape``
written with torch ops, for ``detprocess_tpu_torch``'s
``FeatureProcessing(..., external_file=...)`` or the config's
``feature: external_file:``.

The contract of the port:

    EXTRACTORS = {name: fn}     (else every public callable of the file)
    fn(traces, fs=..., nb_pretrigger_samples=..., **kwargs)
        -> {feature_name: tensor [B]}

- ``traces`` is a ``torch.Tensor`` [B, N]: the spec's channel (or
  compound channel) of one batch, in the run's dtype (float32, or
  float64) on the batch's device: the GPU in a run on the card, the CPU
  in a run on the CPU;
- ``nb_pretrigger_samples`` is the trace group's pretrigger; ``kwargs``
  are the algorithm's config keys (``run``, ``base_algorithm``,
  ``feature_channel``, ``nb_samples`` and ``nb_pretrigger_samples`` are
  not passed);
- every value returned is a tensor [B] on the same device, and becomes
  the column ``{feature_name}_{channel}``. Anything else (a numpy array,
  a tensor of another shape or on another device) is refused by name.

The function runs once per batch and spec, inside the feature step, with
no per-event Python. A JAX function cannot run here: the port imports no
JAX. A name of a built-in algorithm (``baseline``, ``of1x1_nodelay``, ...)
is refused.

Use from YAML:

    feature:
      external_file: /path/to/custom_extractor_torch.py
      Mv2301:
        pulse_shape:
          run: True
          tail_fraction_start_usec: 400.0
"""

import torch


def pulse_shape(traces, fs=None, nb_pretrigger_samples=0,
                tail_fraction_start_usec=400.0, **kwargs):
    """Simple pulse-shape discriminators: peak-to-integral ratio and the
    fraction of area in the tail."""
    pre = int(nb_pretrigger_samples)
    base = traces[:, :max(pre, 1)].mean(dim=-1, keepdim=True)
    x = traces - base
    area = x[:, pre:].sum(dim=-1) / fs
    peak = x.max(dim=-1).values
    tail_start = pre + int(tail_fraction_start_usec * 1e-6 * fs)
    tail = x[:, tail_start:].sum(dim=-1) / fs
    safe = torch.where(area == 0, torch.ones_like(area), area)
    return {
        "peak_over_area": peak / safe,
        "tail_fraction": tail / safe,
    }


EXTRACTORS = {"pulse_shape": pulse_shape}
