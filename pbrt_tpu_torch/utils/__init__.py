"""Render statistics and checkpoint/resume (counterpart of
``pbrt_tpu/utils``)."""
