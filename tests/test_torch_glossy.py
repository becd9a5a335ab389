"""BASELINE config 4's pieces in pbrt_tpu_torch against the JAX reference
on the CPU: the glossy BSDF lobes, Distribution2D and the image-mapped
environment light, the config-4 image and its gradients.

Lobes, Distribution2D and the light take the same seeded numpy inputs in
both packages; the reference runs op by op (no XLA fusion), so values
agree to float32 rounding of the transcendental functions: rtol 1e-4
with an absolute floor of 1e-6 of the largest magnitude (GGX's D
amplifies last-bit differences of wh near its peak), and at least 99.9%
of the sampled directions' discrete choices equal.

The config-4 scene is ``pbrt_tpu_torch.testscenes``' text with the 24x24
torus and small maps (a 64x64 environment: both packages' MIPMap refuses
non-square images, and the light would fall back to a constant one; a
32x32 Kd texture).  Its image is held to ``tests/test_torch_cornell.py``'s
gate.  Its gradients at 8x8, 2 spp, maxdepth 2 are held to
``tests/test_torch_grad.py``'s tolerance, every leaf (texels included)
against ``jax.grad``, except the roughness leaf: ``jax.grad`` of the
reference gives NaN there.  A masked lane's sqrt(max(0, x)) at x <= 0
gets an infinite derivative, and ``jnp.maximum``'s derivative multiplies
the zero cotangent by it (0 x inf); the port's ``torch.clamp`` selects
instead, so its leaf is finite.  The roughness leaf is therefore held
against the reference's forward-mode derivative (``jax.jacfwd``), whose
selects drop the masked lanes' tangents.  Maxdepth 2 keeps the two
reference compiles near a minute; the glass sphere's kt needs a refracted
path of three segments, so its leaf is zero in both here (the image test
renders those paths forward, maxdepth 5).

torch and pbrt_tpu_torch are imported inside the tests: every test
worker imports every test module while collecting.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pbrt_tpu import Options as RefOptions
from pbrt_tpu.core.api import PbrtAPI as RefAPI
from pbrt_tpu.core.sampling import Distribution2D as RefDistribution2D
from pbrt_tpu.core.transform import Transform as RefTransform
from pbrt_tpu.diff.grad import make_loss_fn as ref_make_loss_fn
from pbrt_tpu.lights import InfiniteAreaLight as RefInfiniteAreaLight
from pbrt_tpu.materials import bsdf as RB
from pbrt_tpu.render import Renderer as RefRenderer
from pbrt_tpu.testscenes import _torus_mesh_params as ref_torus_params

RTOL = 1e-4
ATOL_SHARE = 1e-6  # of the largest magnitude of the compared array
N_LANES = 4096


def _close(got, want, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    atol = ATOL_SHARE * max(np.abs(want).max(initial=0.0), 1e-30)
    ok = np.isclose(got, want, rtol=RTOL, atol=atol)
    print(f"{what}: max |port - ref| {np.abs(got - want).max(initial=0.0):.3e} of "
          f"{np.abs(want).max(initial=0.0):.3e}; {ok.mean():.5f} close")
    return ok


def _maps(tmp_path):
    from pbrt_tpu_torch.testscenes import write_env_map, write_texture_map

    env, tex = tmp_path / "env.pfm", tmp_path / "tex.pfm"
    write_env_map(env, 64, 64, seed=0)
    write_texture_map(tex, 32, seed=1)
    return str(env), str(tex)


def _lanes(rng, n):
    """Seeded (wo, wi, u_lobe, u2, params) over every ported lobe type:
    matte (Lambert and Oren-Nayar), mirror, smooth and rough glass,
    plastic, metal, substrate, uber and translucent; wo mostly on the
    shading normal's side, the true side (``outside``) random."""
    types = np.array([RB.MATTE, RB.MIRROR, RB.GLASS, RB.GLASS, RB.PLASTIC, RB.METAL,
                      RB.SUBSTRATE, RB.UBER, RB.TRANSLUCENT], np.int32)
    t = types[np.arange(n) % len(types)]
    rough = rng.uniform(0.02, 0.6, n)
    smooth_glass = (np.arange(n) % len(types)) == 2
    rough[smooth_glass] = 1e-4

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    wo = unit(rng.normal(size=(n, 3)))
    wo[:, 2] = np.where(rng.uniform(size=n) < 0.9, np.abs(wo[:, 2]), wo[:, 2])
    wi = unit(rng.normal(size=(n, 3)))
    params = {
        "type": t,
        "kd": rng.uniform(0.05, 0.95, (n, 3)),
        "ks": rng.uniform(0.05, 0.95, (n, 3)),
        "kr": rng.uniform(0.05, 0.95, (n, 3)),
        "kt": rng.uniform(0.05, 0.95, (n, 3)),
        "roughness": rough,
        "eta": rng.uniform(1.2, 2.0, n),
        "metal_eta": rng.uniform(0.1, 1.5, (n, 3)),
        "metal_k": rng.uniform(1.0, 4.0, (n, 3)),
        "sigma": np.where(rng.uniform(size=n) < 0.5, 0.0, 20.0),
        "outside": rng.uniform(size=n) < 0.5,
    }
    params = {k: v.astype(np.float32) if v.dtype == np.float64 else v
              for k, v in params.items()}
    return (wo.astype(np.float32), wi.astype(np.float32),
            rng.uniform(size=n).astype(np.float32),
            rng.uniform(size=(n, 2)).astype(np.float32), params)


def _both(params, active):
    """(reference params of jnp arrays, port params of CPU tensors)."""
    import torch

    ref = {k: jnp.asarray(v) for k, v in params.items()}
    port = {k: torch.as_tensor(v) for k, v in params.items()}
    ref["_active"] = port["_active"] = frozenset(active)
    return ref, port


def _lobe_checks(ref_params, port_params, wo, wi, u_lobe, u2, label):
    import torch

    from pbrt_tpu_torch.materials import bsdf as PB

    t = lambda a: torch.as_tensor(a)  # noqa: E731
    ok = _close(PB.bsdf_eval(port_params, t(wo), t(wi)).numpy(),
                RB.bsdf_eval(ref_params, jnp.asarray(wo), jnp.asarray(wi)), f"{label} f")
    assert ok.all()
    ok = _close(PB.bsdf_pdf(port_params, t(wo), t(wi)).numpy(),
                RB.bsdf_pdf(ref_params, jnp.asarray(wo), jnp.asarray(wi)), f"{label} pdf")
    assert ok.all()
    got = PB.bsdf_sample(port_params, t(wo), t(u_lobe), t(u2))
    want = RB.bsdf_sample(ref_params, jnp.asarray(wo), jnp.asarray(u_lobe), jnp.asarray(u2))
    spec = got[3].numpy()
    assert (spec == np.asarray(want[3])).all(), f"{label}: specular flags differ"
    same = np.ones(wo.shape[0], bool)
    for name, g, w in zip(("wi", "f", "pdf"), got[:3], want[:3]):
        close = _close(g.numpy(), w, f"{label} sample {name}")
        same &= close.all(axis=-1) if close.ndim > 1 else close
    # a lane may take the other branch where a choice sits on a float32 tie
    assert same.mean() >= 0.999, f"{label}: {(~same).sum()} sampled lanes differ"
    return spec


def test_lobes_match_reference():
    """4096 seeded lanes of every ported lobe through bsdf_eval, bsdf_pdf
    and bsdf_sample; then a mix of glass and matte with ``outside`` true
    and false (the mix hands it to its glass child)."""
    rng = np.random.default_rng(0)
    wo, wi, u_lobe, u2, params = _lanes(rng, N_LANES)
    ref_params, port_params = _both(params, set(params["type"].tolist()))
    spec = _lobe_checks(ref_params, port_params, wo, wi, u_lobe, u2, "all lobes")
    assert spec.any() and not spec.all()

    import torch

    glass = dict(params, type=np.full(N_LANES, RB.GLASS, np.int32))
    matte = dict(params, type=np.full(N_LANES, RB.MATTE, np.int32))
    amt = rng.uniform(0.2, 0.8, (N_LANES, 3)).astype(np.float32)
    pa = np.clip(amt @ np.array([0.212671, 0.715160, 0.072169], np.float32), 1e-3,
                 1 - 1e-3).astype(np.float32)
    for outside in (True, False):
        for first, second, label in ((glass, matte, "glass, matte"),
                                     (matte, glass, "matte, glass")):
            # only the outer set carries ``outside``: the mix hands it down
            ref_a, port_a = _both(dict(first, outside=np.full(N_LANES, outside)),
                                  {int(first["type"][0])})
            ref_b, port_b = _both({k: v for k, v in second.items() if k != "outside"},
                                  {int(second["type"][0])})
            ref_a.update(mix_b=ref_b, mix_amt=jnp.asarray(amt), mix_pa=jnp.asarray(pa))
            port_a.update(mix_b=port_b, mix_amt=torch.as_tensor(amt),
                          mix_pa=torch.as_tensor(pa))
            _lobe_checks(ref_a, port_a, wo, wi, u_lobe, u2, f"mix({label}), outside {outside}")


def test_distribution2d_and_mapped_light_match_reference(tmp_path):
    """Distribution2D on a seeded 64x32 function with two zero rows
    (their uniform fallback); then the mapped infinite light of a seeded
    64x64 map under a rotation: sample_li, pdf_li and le_escaped."""
    import torch

    from pbrt_tpu_torch.core.sampling import Distribution2D
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.lights import InfiniteAreaLight

    rng = np.random.default_rng(5)
    func = rng.uniform(0.0, 1.0, (32, 64)) ** 4
    func[[3, 17]] = 0.0
    ref_d = RefDistribution2D(func)
    port_d = Distribution2D(func, "cpu")
    u = rng.uniform(size=(N_LANES, 2)).astype(np.float32)
    uv_w, pdf_w = ref_d.sample_continuous(jnp.asarray(u))
    uv_g, pdf_g = port_d.sample_continuous(torch.as_tensor(u))
    assert _close(uv_g.numpy(), uv_w, "Distribution2D uv").all()
    assert _close(pdf_g.numpy(), pdf_w, "Distribution2D pdf").all()
    assert _close(port_d.pdf_at(torch.as_tensor(u)).numpy(), ref_d.pdf_at(jnp.asarray(u)),
                  "Distribution2D pdf_at").all()

    env, _ = _maps(tmp_path)
    ref_l = RefInfiniteAreaLight(RefTransform.rotate(25.0, [0.3, 0.2, 0.9]),
                                 np.array([1.0, 0.9, 0.8]), env)
    port_l = InfiniteAreaLight(Transform.rotate(25.0, [0.3, 0.2, 0.9]),
                               np.array([1.0, 0.9, 0.8]), env, device="cpu")
    assert port_l.distribution is not None
    np.testing.assert_allclose(port_l.power(), ref_l.power(), rtol=1e-6)
    p = rng.uniform(-1, 1, (N_LANES, 3)).astype(np.float32)
    got = port_l.sample_li(torch.as_tensor(p), torch.as_tensor(u))
    want = ref_l.sample_li(jnp.asarray(p), jnp.asarray(u))
    for name, g, w in zip(("wi", "li", "pdf", "dist"), got, want):
        assert _close(g.numpy(), w, f"sample_li {name}").all()
    d = rng.normal(size=(N_LANES, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    assert _close(port_l.pdf_li(torch.as_tensor(p), torch.as_tensor(d)).numpy(),
                  ref_l.pdf_li(jnp.asarray(p), jnp.asarray(d)), "pdf_li").all()
    assert _close(port_l.le_escaped(torch.as_tensor(d)).numpy(),
                  ref_l.le_escaped(jnp.asarray(d)), "le_escaped").all()


def _ref_config4(env, tex, res, nu=24, nv=24):
    from pbrt_tpu_torch.testscenes import config4_text

    head, tail = config4_text(env, tex, **res)
    api = RefAPI(RefOptions(ray_batch=1 << 16), render_on_world_end=False)
    api.init()
    api.parse_string(head)
    api.shape("trianglemesh", ref_torus_params(nu, nv)[0])
    api.parse_string(tail)
    api.scene.film_params.add_int("xresolution", [res["xres"]])
    api.scene.film_params.add_int("yresolution", [res["yres"]])
    return RefRenderer(api.scene, api.opt, seed=0)


def test_config4_image_matches_reference(tmp_path):
    """Config 4 at 16x16, 2 spp, maxdepth 5 with the 24x24 torus: glossy
    plastic over an image texture, rough copper, smooth glass, substrate
    and the mapped environment light through the sorted carry."""
    from pbrt_tpu_torch.materials import bsdf as PB
    from pbrt_tpu_torch.testscenes import config4_renderer

    from test_torch_cornell import _check_image

    env, tex = _maps(tmp_path)
    res = dict(xres=16, yres=16, spp=2, maxdepth=5)
    ref = _ref_config4(env, tex, res)
    want = np.asarray(ref.film.to_rgb(ref.render(progress=False)))
    port, _ = config4_renderer(env, tex, **res, nu=24, nv=24, device="cpu")
    assert port.integrator._sc
    assert [e.type_id for e in port.compiled.materials] == [PB.PLASTIC, PB.METAL, PB.GLASS,
                                                            PB.SUBSTRATE]
    assert port.compiled.lights[0].distribution is not None
    _check_image(port.image(port.render()), want, port, 5)


def test_config4_gradients_match_reference(tmp_path):
    """Config 4 at 8x8, 2 spp, maxdepth 2: every leaf (kd, ks, kr, kt,
    roughness, sigma, env_l, area_l and the Kd texels) against the
    reference; roughness against its forward-mode derivative."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.scene.convert import theta_from_numpy
    from pbrt_tpu_torch.testscenes import config4_renderer

    from test_torch_grad import _compare_leaves, _numpy

    env, tex = _maps(tmp_path)
    res = dict(xres=8, yres=8, spp=2, maxdepth=2)
    ref = _ref_config4(env, tex, res)
    port, _ = config4_renderer(env, tex, **res, nu=24, nv=24, device="cpu")
    ref_theta = ref.compiled.initial_theta()
    target = np.full((8, 8, 3), 0.2, np.float32)
    pixels = jnp.asarray(ref.film.cropped_pixel_bounds.offsets().astype(np.int32))
    ref_loss = ref_make_loss_fn(ref, target, spp=2)
    want = _numpy(jax.jit(jax.grad(ref_loss))(ref_theta, pixels))
    want["roughness"] = np.asarray(jax.jit(jax.jacfwd(
        lambda r: ref_loss({**ref_theta, "roughness": r}, pixels)))(ref_theta["roughness"]))
    theta = theta_from_numpy(_numpy(ref_theta), port.compiled, "cpu")
    loss = make_loss_fn(port, target, spp=2)
    _, got = value_and_grad(loss, theta, torch.as_tensor(np.asarray(pixels).astype(np.int64)))
    print("roughness:", got["roughness"].tolist(), "reference:", want["roughness"].tolist())
    assert (got["roughness"][[0, 1, 3]] != 0).all()  # plastic, metal, substrate
    assert (got["ks"][[0, 3]] != 0).all() and (got["kr"][2] != 0).all()
    (texels,) = got["tex_images"].values()
    assert float(texels.abs().sum()) > 0.0
    _compare_leaves(got, want)
