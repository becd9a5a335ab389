"""Integrators (counterpart of ``pbrt_tpu/integrators/__init__.py``).

``path``, ``volpath``, ``directlighting``, ``whitted`` and ``ao`` are
ported.  As in the reference, ``path`` on a scene with participating
media (subsurface interiors included) renders through the volumetric
path integrator.  sppm, bdpt and mlt wait for ROADMAP Queue 1 item 8.
"""

from __future__ import annotations


def make_integrator(compiled):
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
        return PathIntegrator(compiled, max_depth, rr_threshold)
    if name == "volpath":
        return VolPathIntegrator(compiled, max_depth, params.find_one_float("rrthreshold", 1.0))
    if name == "directlighting":
        return DirectLightingIntegrator(compiled, max_depth)
    if name == "whitted":
        return WhittedIntegrator(compiled, max_depth)
    if name == "ao":
        from pbrt_tpu_torch.integrators.ao import AOIntegrator

        params.find_one_bool("cossample", True)
        return AOIntegrator(compiled, n_samples=params.find_one_int("nsamples", 1))
    raise NotImplementedError(
        f"Integrator '{name}' is not ported yet (ROADMAP.md Queue 1 item 8); "
        "'path', 'volpath', 'directlighting', 'whitted' and 'ao' are"
    )
