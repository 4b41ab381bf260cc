"""video_stabilizer_tpu_torch — the PyTorch + CUDA port of
``video_stabilizer_tpu`` for NVIDIA Hopper (H100).

Layer map, mirroring the JAX package:

  config.py          AlignerParams / StabilizerParams (same fields)
  transforms.py      similarity-transform algebra on (..., 4) tensors
  ops/               plain PyTorch ops and the hand-written CUDA kernels:
                     warp_kernel.py (kernel A, output warp, csrc/warp.cu) and
                     gn_solve.py (kernel B, per-level GN loop,
                     csrc/gn_solve.cu), built at first use by cuda_build.py
  models/aligner.py  batched coarse-to-fine inverse-compositional LK aligner
  models/batch.py    clip and multi-stream pipelines
  models/chunked.py  chunked serving with carried StreamState
  utils/io.py        synthetic footage (numpy)

Entry points take ``device=None``, which means the CUDA card, and raise when
there is none; ``device="cpu"`` runs the plain PyTorch versions. The package
imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
