"""PyTorch/CUDA port of detprocess_tpu for NVIDIA Hopper GPUs.

Ported so far:

- the of1x1 feature step
  (:class:`detprocess_tpu_torch.pipelines.feature_step.FeatureStep`):
  optimal-filter no-delay and delay-scan fits plus baseline and integral
  on batches of long traces;
- the continuous-data trigger step
  (:class:`detprocess_tpu_torch.pipelines.trigger_step.TriggerStep`):
  overlap-save FIR, Δχ², tiled threshold and pileup merge, and the
  residual re-trigger with its saturation veto;
- the shells over raw files:
  :class:`detprocess_tpu_torch.pipelines.features.FeatureProcessing` and
  :class:`detprocess_tpu_torch.pipelines.triggers.TriggerProcessing`
  (continuous files to a coincidence-merged trigger table, with the
  ``EventBuilder`` and the ``OptimumFilterTrigger`` object API).

The two hand-written CUDA kernels (``csrc/``) are the batched real FFT
(``ops/cuda_fft.py``, also the trigger FIR's segment transform) and the
fused rFFT + no-delay fit (``ops/cuda_of.py``). Every kernel has a plain
PyTorch twin that runs on CPU tensors; CUDA tensors go to the kernel
where it takes their shape, else to cuFFT (``ops/fft.py``).

The package imports torch and numpy only: not JAX, not the JAX package,
not h5py, pandas or yaml.
"""
