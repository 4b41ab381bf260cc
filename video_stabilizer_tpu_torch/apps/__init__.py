"""The apps of the PyTorch port, one module each, run as
``python -m video_stabilizer_tpu_torch.apps.<name>``: the JAX package's
``apps/`` with the same flags and printed lines, plus ``--device`` (the
CUDA card by default; ``--device cpu`` runs the plain PyTorch versions)."""
