"""video_annotator_tpu_torch: the PyTorch + CUDA port of video_annotator_tpu.

Runs the stock ``render --stabilise smooth`` path (rotation family,
two-phase, paired analyse, Savitzky-Golay smoothing, bilinear rectilinear
warp) on one NVIDIA Hopper GPU. Plain tensor code is PyTorch; the three
TPU (Pallas) kernels of that path are CUDA C++ kernels written for
``sm_90a`` in ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``:

- K1 ``csrc/warp.cu``: fused warp map + bilinear remap of a YUV batch;
- K2 ``csrc/lk.cu``: one Lucas-Kanade pyramid level for all frame pairs;
- K3 ``csrc/stage.cu``: rounding/padding of levels into uint8 stacks.

Each kernel wrapper runs its plain PyTorch version on CPU tensors (the
tests hold those against the JAX package) and launches the kernel, or
raises, on CUDA tensors. The package imports neither ``jax`` nor
``video_annotator_tpu``.
"""

__version__ = "0.1.0"
