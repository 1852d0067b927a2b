"""PyTorch/CUDA port of detprocess_tpu for NVIDIA Hopper GPUs.

The slice ported so far is the of1x1 feature step
(:class:`detprocess_tpu_torch.pipelines.feature_step.FeatureStep`):
optimal-filter no-delay and delay-scan fits plus baseline and integral on
batches of long traces. Its two hand-written CUDA kernels (``csrc/``) are
the batched real FFT (``ops/cuda_fft.py``) and the fused rFFT + no-delay
fit (``ops/cuda_of.py``). Every kernel has a plain PyTorch twin that runs
on CPU tensors; CUDA tensors always go to the kernel.

The package imports torch and numpy only: not JAX, not the JAX package,
not h5py, pandas or yaml.
"""
