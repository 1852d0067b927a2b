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
  ``EventBuilder`` and the ``OptimumFilterTrigger`` object API);
- filter generation, noise, randoms, templates and salting
  (``FilterDataProcessing``, ``Noise``, ``Randoms``, ``Template``,
  ``Salting``);
- the dIdV, IV-sweep and noise-model fits (``DIDVAnalysis``,
  ``IVSweepProcessing``, ``IVSweepAnalysis``, ``NoiseModel``,
  ``FilterBuilder``): the trace work (cuts, PSDs, offsets, lock-in) on
  the GPU, the fits on the CPU in float64, as the JAX package pins them;
- the command line (``python -m detprocess_tpu_torch.cli``, which chains
  every workload as the JAX one does), the multi-node launcher
  (``python -m detprocess_tpu_torch.launch``), feature-table merging
  (``pipelines/merge``) and the plots (``utils/plotting``, matplotlib
  imported when a plot is drawn). Besides the JAX file forms (pytesdaq
  HDF5, YAML, HDF5 filter files and tables), which need h5py or PyYAML,
  it reads and writes forms of its own that numpy and ``json`` serve:
  flat raw groups with JSON manifests, JSON setups, ``.npz`` filter files
  and tables.

The two hand-written CUDA kernels (``csrc/``) are the batched real FFT
(``ops/cuda_fft.py``, also the trigger FIR's segment transform) and the
fused rFFT + no-delay fit (``ops/cuda_of.py``). Every kernel has a plain
PyTorch twin that runs on CPU tensors; CUDA tensors go to the kernel
where it takes their shape, else to cuFFT (``ops/fft.py``).

The package imports torch and numpy only: not JAX, not the JAX package,
not h5py, pandas, yaml or matplotlib (adapters import them when called).
"""

_EXPORTS = {
    "FeatureProcessing": "detprocess_tpu_torch.pipelines.features",
    "TriggerProcessing": "detprocess_tpu_torch.pipelines.triggers",
    "EventBuilder": "detprocess_tpu_torch.pipelines.triggers",
    "OptimumFilterTrigger": "detprocess_tpu_torch.pipelines.oftrigger",
    "Randoms": "detprocess_tpu_torch.pipelines.randoms",
    "Salting": "detprocess_tpu_torch.pipelines.salting",
    "Noise": "detprocess_tpu_torch.pipelines.noise",
    "NoiseModel": "detprocess_tpu_torch.pipelines.noisemodel",
    "DIDVAnalysis": "detprocess_tpu_torch.pipelines.didv",
    "IVSweepProcessing": "detprocess_tpu_torch.pipelines.ivsweep",
    "IVSweepAnalysis": "detprocess_tpu_torch.pipelines.ivsweep",
    "Template": "detprocess_tpu_torch.pipelines.template",
    "FilterBuilder": "detprocess_tpu_torch.pipelines.template",
    "FilterDataProcessing": "detprocess_tpu_torch.pipelines.filtergen",
    "FilterData": "detprocess_tpu_torch.io.filterdata",
    "RawData": "detprocess_tpu_torch.io.rawdata",
}


def __getattr__(name):
    """The user-facing classes, imported when first asked for (the JAX
    package's top-level names)."""
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'detprocess_tpu_torch' has no attribute {name!r}")
