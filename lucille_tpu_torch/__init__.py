"""lucille_tpu_torch — the PyTorch/CUDA port of lucille_tpu.

The port renders the ambient-occlusion frame, plain or under a Preetham
sun and sky, the Whitted, path-traced and dirt-map frames, environment-map
lights under their five samplers (lights/ibl.py) and the built-in
displacement, atmosphere and imager shaders (shading/pipeline.py), end
to end on one NVIDIA H100, to a file or a socket display.  RIB ingest
and the scene description are the port's own copies of lucille_tpu's
host modules (rib/, ri/, ops/vecmat, lights/, display/, imageio/, base/,
native/);
everything that runs per ray is torch, and the hot kernels are CUDA C++
written by hand for sm_90a (csrc/), built at first use by
kernels/build.py and bound with ctypes: on the dense tiles the closest
hit of the eye rays, the fused AO occlusion gather (with per-stratum
bits for the sky) and the any-hit of the sun's shadow rays; on the tile
BVH a BVH closest hit, the BVH any-hit that traces the gather rays and
the fused BVH gather; on lucille_tpu's uniform grid its DDA walk.
`diff` differentiates a frame with respect to the material and light
parameters on torch autograd; `parallel` shards a frame's tiles over a
mesh of devices, across processes joined by torch.distributed (gloo).

Every kernel wrapper has a plain torch twin with the same contract. A
wrapper handed CPU tensors runs the twin; handed CUDA tensors it
launches its kernel or raises.  The package never imports jax,
nor anything of lucille_tpu.
"""

from lucille_tpu_torch.version import __version__  # noqa: F401
