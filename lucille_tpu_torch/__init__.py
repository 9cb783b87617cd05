"""lucille_tpu_torch — the PyTorch/CUDA port of lucille_tpu.

The port renders the ambient-occlusion frame end to end on one NVIDIA
H100: RIB ingest and the scene description come from lucille_tpu's
jax-free host layers (rib/, ri/, display/, imageio/, base/, native/);
everything that runs per ray is torch, and the hot kernels are CUDA C++
written by hand for sm_90a (csrc/), built at first use by
kernels/build.py and bound with ctypes: on the dense tiles the closest
hit of the eye rays and the fused AO occlusion gather, on the tile BVH
a BVH closest hit and the BVH any-hit that traces the gather rays.

Every kernel wrapper has a plain torch twin with the same contract. A
wrapper handed CPU tensors runs the twin; handed CUDA tensors it
launches its kernel or raises.  The package never imports jax.
"""

__version__ = "0.1.0"
