"""Integrators (counterpart of ``pbrt_tpu/integrators/__init__.py``).

``path``, ``volpath``, ``directlighting``, ``whitted``, ``ao``,
``bdpt``, ``mlt`` and ``sppm`` are ported.  As in the reference,
``path`` on a scene with participating media (subsurface interiors
included) renders through the volumetric path integrator, and ``mlt`` on
such a scene targets it instead of BDPT.  An unknown name takes
``path``, with a warning, as in the reference.

``sorted_carry`` and ``shadow_sort`` (``integrators/path.py``) reach the
integrators that run ``PathIntegrator``'s bounce loop: ``path`` (without
media), ``directlighting`` and ``whitted``, as the reference's inherit its
environment switches; the others have loops of their own.
"""

from __future__ import annotations

import logging

log = logging.getLogger("pbrt_tpu_torch")


def make_integrator(compiled, sorted_carry=True, shadow_sort="sorted"):
    """Integrator factory per pbrt-v3 MakeIntegrator names."""
    from pbrt_tpu_torch.integrators.direct import DirectLightingIntegrator, WhittedIntegrator
    from pbrt_tpu_torch.integrators.path import PathIntegrator
    from pbrt_tpu_torch.integrators.volpath import VolPathIntegrator

    name = compiled.integrator_name
    params = compiled.integrator_params
    max_depth = params.find_one_int("maxdepth", 5)
    if name == "path":
        rr_threshold = params.find_one_float("rrthreshold", 1.0)
        if compiled.media:
            return VolPathIntegrator(compiled, max_depth, rr_threshold)
        return PathIntegrator(compiled, max_depth, rr_threshold, sorted_carry=sorted_carry,
                              shadow_sort=shadow_sort)
    if name == "volpath":
        return VolPathIntegrator(compiled, max_depth, params.find_one_float("rrthreshold", 1.0))
    if name == "directlighting":
        return DirectLightingIntegrator(compiled, max_depth, sorted_carry=sorted_carry,
                                        shadow_sort=shadow_sort)
    if name == "whitted":
        return WhittedIntegrator(compiled, max_depth, sorted_carry=sorted_carry,
                                 shadow_sort=shadow_sort)
    if name == "ao":
        from pbrt_tpu_torch.integrators.ao import AOIntegrator

        params.find_one_bool("cossample", True)
        return AOIntegrator(compiled, n_samples=params.find_one_int("nsamples", 1))
    if name == "bdpt":
        from pbrt_tpu_torch.integrators.bdpt import BDPTIntegrator

        return BDPTIntegrator(compiled, max_depth)
    if name == "mlt":
        from pbrt_tpu_torch.integrators.mlt import MLTIntegrator

        # pbrt's "sigma" is read, as the reference reads it, and unused: the
        # mutation's two scales are fixed
        params.find_one_float("sigma", 0.01)
        return MLTIntegrator(
            compiled, max_depth,
            n_bootstrap=params.find_one_int("bootstrapsamples", 4096),
            mutations_per_pixel=params.find_one_int("mutationsperpixel", 32),
            large_step_prob=params.find_one_float("largestepprobability", 0.3),
            # BDPT leaves volumetric transport to volpath: media scenes keep
            # the unidirectional target
            strategy="path" if compiled.media else "bdpt",
        )
    if name == "sppm":
        from pbrt_tpu_torch.integrators.sppm import SPPMIntegrator

        return SPPMIntegrator(
            compiled, max_depth,
            n_iterations=params.find_one_int("numiterations", 16),
            photons_per_iteration=params.find_one_int("photonsperiteration", -1),
            initial_radius=params.find_one_float("radius", -1.0),
        )
    log.warning("Integrator '%s' unknown; using path.", name)
    return PathIntegrator(compiled, max_depth, 1.0, sorted_carry=sorted_carry,
                          shadow_sort=shadow_sort)
