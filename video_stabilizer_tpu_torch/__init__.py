"""video_stabilizer_tpu_torch — the PyTorch + CUDA port of
``video_stabilizer_tpu`` for NVIDIA Hopper (H100).

Layer map, mirroring the JAX package:

  config.py          AlignerParams / StabilizerParams (same fields)
  transforms.py      similarity-transform algebra on (..., 4) tensors
  homography.py      8-DOF homography algebra on (..., 8) tensors
  ops/               plain PyTorch ops (phase correlation included) and the
                     hand-written CUDA kernels: warp_kernel.py (kernel A,
                     output warp, csrc/warp.cu), gn_solve.py (kernel B,
                     per-level 4-DOF GN loop, csrc/gn_solve.cu) and
                     gn8_solve.py (kernel C, per-level 8-DOF GN loop,
                     csrc/gn8_solve.cu), built at first use by cuda_build.py
  models/aligner.py  batched coarse-to-fine inverse-compositional LK aligner
  models/homography_aligner.py  its 8-DOF homography counterpart
  models/batch.py    clip and multi-stream pipelines (model="similarity" or
                     "homography")
  models/chunked.py  chunked serving with carried StreamState
  utils/io.py        synthetic footage (numpy)

Entry points take ``device=None``, which means the CUDA card, and raise when
there is none; ``device="cpu"`` runs the plain PyTorch versions. The package
imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
