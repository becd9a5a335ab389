"""Differentiable rendering: pixel gradients w.r.t. scene parameters
(counterpart of ``pbrt_tpu/diff``)."""
