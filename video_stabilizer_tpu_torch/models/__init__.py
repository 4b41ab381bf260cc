"""Aligner, smoother and the clip / chunked stabilization pipelines."""
