"""Direct lighting and Whitted integrators (counterpart of
``pbrt_tpu/integrators/direct.py``; pbrt-v3 §14.3, §1.3.4).

Both are configurations of the path loop:

* ``DirectLightingIntegrator``: at each non-specular vertex of a specular
  chain, the light sample with MIS, and the BSDF sample's continuation
  traced one more segment that only gathers emission (``direct_only``);
  specular chains recurse to ``max_depth``.  No indirect light.
* ``WhittedIntegrator``: light sampling only (weight 1, ``nee_mis``
  off), non-specular continuations stopped (pdf 0), specular recursion
  to ``max_depth``.

Both pick one light uniformly per vertex, as the reference does (pbrt's
Whitted loops over every light).
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.integrators.path import PathIntegrator


class DirectLightingIntegrator(PathIntegrator):
    direct_only = True

    def __init__(self, compiled, max_depth=5, **switches):
        # one more bounce, so that the deepest non-specular vertex still
        # traces its emission-only segment
        super().__init__(compiled, max_depth=max(2, max_depth + 1), rr_threshold=1.0,
                         **switches)


class WhittedIntegrator(PathIntegrator):
    nee_mis = False

    def __init__(self, compiled, max_depth=5, **switches):
        super().__init__(compiled, max_depth=max(2, max_depth), rr_threshold=1.0, **switches)

    def _bsdf_sample(self, params, wo_l, u_lobe, u_b):
        wi, f, pdf, spec = super()._bsdf_sample(params, wo_l, u_lobe, u_b)
        return wi, f, torch.where(spec, pdf, 0.0), spec
