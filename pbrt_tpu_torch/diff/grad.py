"""Reverse-mode pixel gradients w.r.t. material, light and texel
parameters (counterpart of ``pbrt_tpu/diff/grad.py``).

The estimator is detached sampling: every sampling decision (directions,
lobe and light choices, Russian roulette) is fixed by the forward pass's
random numbers, which are pure functions of (pixel, sample, dimension),
so the backward pass replays the same paths while ``torch.autograd``
differentiates the smooth factors (BSDF values, light radiances, MIS
weights).  With ``remat=True`` each bounce of ``path`` and ``volpath``
runs under ``torch.utils.checkpoint``: the backward pass replays the
bounce, walks included, instead of keeping its wavefront state.
``bdpt`` takes ``remat`` and ignores it, as the reference does: its
vertex records feed every (s, t) connection, so the whole estimator
stays alive for the backward and the replay launches no walk; its
radiance is ``li``, the strategies without light tracing.

Gradient targets are the leaves of ``CompiledScene.initial_theta()``:
constant material slots (kd, ks, kr, kt, roughness, sigma), the emission
of infinite and area lights, and the texels of image textures.  Take a
gradient with :func:`value_and_grad` (``torch.autograd.grad`` over
every leaf; a leaf the loss does not reach gets zeros), e.g.::

    theta = renderer.compiled.initial_theta()
    loss = make_loss_fn(renderer, target, spp=4)
    value, g = value_and_grad(loss, theta, pixels)   # g["kd"]: [M, 3]
"""

from __future__ import annotations

import copy

import numpy as np
import torch


def make_radiance_fn(renderer, remat: bool = True):
    """f(theta, pixel_xy [N, 2], sample_index [N]) -> L [N, 3], the
    camera-weighted finite radiance of one sample per lane, on the
    renderer's device (``remat``: the per-bounce checkpoint of path and
    volpath; no effect on bdpt)."""
    sampler = renderer.sampler
    camera = renderer.camera
    integrator = copy.copy(renderer.integrator)
    integrator.remat = remat

    def radiance(theta, pixel_xy, sample_index):
        p_film = pixel_xy.to(renderer.dtype) + sampler.get2(pixel_xy, sample_index, 0)
        u_lens = sampler.get2(pixel_xy, sample_index, 2)
        o, d, w = camera.generate_rays(p_film, u_lens)
        L = integrator.li(sampler, pixel_xy, sample_index, o, d, theta=theta)
        return torch.where(torch.isfinite(L), L, 0.0) * w[..., None]

    return radiance


def make_loss_fn(renderer, target_image, spp: int = 4, remat: bool = True):
    """Mean-squared inverse-rendering loss over a pixel batch.

    target_image: [H, W, 3] in cropped-film coordinates.  Returns
    loss(theta, pixel_xy) averaging ``spp`` samples per pixel, in the
    renderer's float (``Renderer.dtype``: float64 under the double
    policy, theta's leaves then float64 too)."""
    radiance = make_radiance_fn(renderer, remat)
    target = torch.as_tensor(np.asarray(target_image), dtype=renderer.dtype,
                             device=renderer.device)
    bx, by = renderer.film.cropped_pixel_bounds.p_min

    def loss(theta, pixel_xy):
        n = pixel_xy.shape[0]
        acc = torch.zeros((n, 3), dtype=renderer.dtype, device=pixel_xy.device)
        for s in range(spp):
            sidx = torch.full((n,), s, dtype=torch.int64, device=pixel_xy.device)
            acc = acc + radiance(theta, pixel_xy, sidx)
        t = target[pixel_xy[..., 1] - by, pixel_xy[..., 0] - bx]
        return torch.mean((acc / spp - t) ** 2)

    return loss


def render_image_diff(renderer, theta, spp: int = 4, batch: int = 4096):
    """Differentiable full-frame render -> [H, W, 3]: per pixel the mean
    of ``spp`` samples (a box filter of radius <= 0.5)."""
    radiance = make_radiance_fn(renderer)
    b = renderer.film.cropped_pixel_bounds
    pixels = b.offsets().astype(np.int64)
    n_pix = len(pixels)
    h, wdt = b.height, b.width
    dev = renderer.device
    n_chunks = -(-n_pix // batch)
    pad = n_chunks * batch - n_pix
    if pad:
        pixels = np.concatenate([pixels, np.repeat(pixels[-1:], pad, axis=0)])
    pixels = torch.as_tensor(pixels, device=dev)
    img = torch.zeros((h * wdt, 3), dtype=renderer.dtype, device=dev)
    for ci in range(n_chunks):
        chunk = pixels[ci * batch:(ci + 1) * batch]
        acc = torch.zeros((batch, 3), dtype=renderer.dtype, device=dev)
        for s in range(spp):
            acc = acc + radiance(theta, chunk,
                                 torch.full((batch,), s, dtype=torch.int64, device=dev))
        lin = (chunk[..., 1] - b.p_min[1]) * wdt + (chunk[..., 0] - b.p_min[0])
        img = img.index_put((lin,), acc / spp)
    return img.reshape(h, wdt, 3)


def _map(tree, fn):
    """The nested theta dict with ``fn`` applied to every leaf."""
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def value_and_grad(fn, theta, *args):
    """(fn(theta, *args) detached, its gradient w.r.t. every leaf of
    ``theta`` in theta's structure).  The leaves are detached copies
    that require grad; a leaf the value does not reach gets zeros."""
    leaves = []

    def track(v):
        leaves.append(v.detach().clone().requires_grad_(True))
        return leaves[-1]

    tracked = _map(theta, track)
    value = fn(tracked, *args)
    grads = iter(torch.autograd.grad(value, leaves, allow_unused=True, materialize_grads=True))
    return value.detach(), _map(tracked, lambda _: next(grads))
