"""Top-level render orchestration (counterpart of ``pbrt_tpu/render.py``).

``Renderer(desc, options, seed, device, walk, sort, sorted_carry,
shadow_sort, stream_min_tris, key_obits, deadbit)`` builds the scene's
tables on ``device`` (a CUDA card unless the caller asks for the CPU),
with the BVH walk, ``co_sort`` network and sort-key switches named by
``walk``, ``sort``, ``stream_min_tris``, ``key_obits`` and ``deadbit``
(``accel/bvh.py``) and the path integrator's ``sorted_carry`` and
``shadow_sort`` (``integrators/path.py``), and sweeps (pixel, sample) lanes in chunks of
``options.ray_batch``: camera rays -> path integrator -> film.  Two film
paths, chosen as the reference chooses them:

* dense (box filter of radius <= 0.5, no crop margin, no checkpoint):
  chunks aligned to whole pixels, each chunk adding its per-pixel sums to
  a contiguous run of the row-major film (the reference's
  ``_frame_dense``);
* scatter (any other filter radius, a crop window, or a checkpointed
  render): lanes over the sample bounds, each chunk's samples added to
  the film through the filter table (``Film.add_samples``; the
  reference's ``_step_impl``).  With ``options.checkpoint_dir`` the film
  state and the chunk cursor are saved every ``checkpoint_every`` chunks
  and a matching checkpoint is resumed (``utils/checkpoint.py``).

A moving camera (``set_animation``) takes each lane's shutter time from
sampler dimension 4 on both film paths, the dimension the integrators
read for the geometry of an animated scene.

Integrators that splat (``provides_splats``: BDPT's light tracing) are
called through ``li_splat`` and always take the scatter film; each
chunk's splats are added unfiltered to the film's splat channel, masked
to the finite values of live lanes and scaled by 1 / spp.  Integrators
that own their budget (``custom_render``: MLT and SPPM) are
handed the renderer before any chunking; only an explicit ``spp``
overrides their budget (MLT's mutations per pixel, SPPM's iterations).

Under the double policy (``options.double``) the film, the rays and the
radiance are float64 (``Renderer.dtype``, from the scene's tables); the
samples stay float32, as the reference's.

``render_scene`` is the scene file's path from ``WorldEnd``: build,
render, write the image.  With ``options.sampled_spectrum`` it hands over
to ``render_scene_spectral``: ``n_spectral_bins / 3`` passes, each
rebuilding the scene with three wavelength bins promoted into the RGB
channels (``core/spectrum.py``), summed against the CIE fits to XYZ and
converted to RGB.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from pbrt_tpu_torch import Options, float_type, torch_dtype
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.integrators import make_integrator
from pbrt_tpu_torch.scene.builder import build_scene
from pbrt_tpu_torch.utils import stats
from pbrt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

log = logging.getLogger("pbrt_tpu_torch")


class Renderer:
    """Holds the compiled scene; reusable across renders."""

    def __init__(self, desc, options: Options | None = None, seed: int = 0,
                 device="cuda", walk: str = "bvh8", sort: str = "stable",
                 sorted_carry: bool = True, shadow_sort: str = "sorted",
                 stream_min_tris: int = 4096, key_obits: int = 5, deadbit: bool = True):
        self.options = options or Options()
        self.device = torch.device(device)
        self.compiled = build_scene(desc, self.options, seed, device=self.device, walk=walk,
                                    sort=sort, stream_min_tris=stream_min_tris,
                                    key_obits=key_obits, deadbit=deadbit)
        # the policy's float of the film, the rays and the radiance
        self.dtype = torch_dtype(self.compiled.float_t)
        self.integrator = make_integrator(self.compiled, sorted_carry=sorted_carry,
                                          shadow_sort=shadow_sort)
        self.compiled.integrator_params.report_unused()
        self.film = self.compiled.film
        self.sampler = self.compiled.sampler
        self.camera = self.compiled.camera
        # exact work counters (camera samples, intersector queries)
        self.counters = {"camera_samples": 0, "closest_queries": 0,
                         "shadow_queries": 0, "chunks": 0}

    def _radiance(self, pixel_xy, sample_index, spp):
        """Camera rays of the lanes -> (film positions [N, 2], weighted
        finite radiance [N, 3], splats: a list of (raster positions [N, 2],
        radiance [N, 3], mask [N]) from a splatting integrator)."""
        sampler = self.sampler.bounded(spp)
        p_film = pixel_xy.to(self.dtype) + sampler.get2(pixel_xy, sample_index, 0)
        u_lens = sampler.get2(pixel_xy, sample_index, 2)
        # a moving camera reads the lane's shutter time (dimension 4)
        u_time = (sampler.get(pixel_xy, sample_index, 4)
                  if getattr(self.camera, "_anim_c2w", None) is not None else None)
        o, d, wgt = self.camera.generate_rays(p_film, u_lens, u_time)
        if getattr(self.integrator, "provides_splats", False):
            L, splats = self.integrator.li_splat(sampler, pixel_xy, sample_index, o, d)
        else:
            L, splats = self.integrator.li(sampler, pixel_xy, sample_index, o, d), []
        return p_film, torch.where(torch.isfinite(L), L, 0.0) * wgt[..., None], splats

    def _chunk(self, flat, pix_start, n_pix, pix_per_chunk, spp):
        """One dense chunk: lanes pixel-major with ``spp`` consecutive samples."""
        b = self.film.cropped_pixel_bounds
        w = b.width
        x0, y0 = b.p_min
        dev = self.device
        idx = pix_start + torch.arange(pix_per_chunk, device=dev)
        pix_ok = idx < n_pix
        idxc = torch.clamp(idx, max=n_pix - 1)
        pixel_xy = torch.stack([x0 + idxc % w, y0 + idxc // w], dim=-1)
        pixel_xy = pixel_xy.repeat_interleave(spp, dim=0)
        sample_index = torch.arange(spp, device=dev).repeat(pix_per_chunk)
        lane_mask = pix_ok.repeat_interleave(spp)
        _, L, _ = self._radiance(pixel_xy, sample_index, spp)
        L = torch.where(lane_mask[..., None], L, 0.0)
        xyz = L @ self.film.rgb_to_xyz.T
        pix_xyz = xyz.reshape(pix_per_chunk, spp, 3).sum(dim=1)
        pix_w = lane_mask.to(self.dtype).reshape(pix_per_chunk, spp).sum(dim=1)
        flat["fx"][pix_start:pix_start + pix_per_chunk] += pix_xyz
        flat["fw"][pix_start:pix_start + pix_per_chunk] += pix_w

    def render(self, spp: int | None = None, state=None, progress: bool = True):
        """Sweep all (pixel, sample) lanes, ``spp`` samples per pixel (the
        sampler's unless given; a quarter under ``quick_render``), onto
        ``state`` (a fresh film unless given); returns the film state."""
        film = self.film
        if getattr(self.integrator, "custom_render", False):
            with torch.no_grad():
                state = self.integrator.render(self, spp=spp, progress=progress)
            self._count(self.integrator.last_lanes, self.integrator.last_evaluations)
            return state
        sample_bounds = film.get_sample_bounds()
        n_pix = sample_bounds.area()
        spp = spp if spp is not None else self.sampler.samples_per_pixel
        if self.options.quick_render:
            spp = max(1, spp // 4)
        n_lanes = n_pix * spp
        batch = min(self.options.ray_batch, max(1, n_lanes))
        batch = max(spp, (batch // spp) * spp)  # chunks align to whole pixels
        n_chunks = -(-n_lanes // batch)

        ckpt = None
        cursor = 0
        if self.options.checkpoint_dir:
            ckpt = (Path(self.options.checkpoint_dir) / "film.ckpt.npz",
                    {"res": list(film.full_resolution), "spp": int(spp),
                     "n_chunks": int(n_chunks)})
            loaded = load_checkpoint(ckpt[0], self.device)
            if loaded is not None and state is None:
                ck_state, ck_cursor, meta = loaded
                if meta == ckpt[1] and 0 < ck_cursor <= n_chunks:
                    state, cursor = ck_state, ck_cursor
                    log.info("Resuming from %s at chunk %d/%d", ckpt[0], cursor, n_chunks)
                else:
                    log.warning("Checkpoint %s does not match this render (have %s, want "
                                "%s); ignoring", ckpt[0], meta, ckpt[1])
        if state is None:
            state = film.initial_state()
        rx, ry = film.filter.radius
        b = film.cropped_pixel_bounds
        dense = (rx <= 0.5 and ry <= 0.5 and sample_bounds.p_min == b.p_min
                 and sample_bounds.p_max == b.p_max and ckpt is None
                 # splats land on pixels other than the lane's own
                 and not getattr(self.integrator, "provides_splats", False))
        if progress:
            log.info("rendering %d chunk(s) x %d lanes (%s film)", n_chunks, batch,
                     "dense" if dense else "scatter")
        with torch.no_grad():
            if dense:
                state = self._render_dense(state, n_pix, n_chunks, batch // spp, spp)
            else:
                state = self._render_scatter(state, sample_bounds, n_lanes, n_chunks, batch,
                                             spp, cursor, ckpt)
        self._count(n_pix * spp, n_chunks - cursor)
        return state

    def _count(self, lanes, chunks):
        """Add ``lanes`` camera samples, their sweeps (the integrator's
        ``queries_per_sample``) and ``chunks`` to the counters."""
        closest, shadow = self.integrator.queries_per_sample()
        done = {"camera_samples": lanes, "closest_queries": lanes * closest,
                "shadow_queries": lanes * shadow, "chunks": chunks}
        for key, n in done.items():
            self.counters[key] += n
            stats.count(f"render/{key}", n)

    def _render_dense(self, state, n_pix, n_chunks, pix_per_chunk, spp):
        b = self.film.cropped_pixel_bounds
        dev = self.device
        flat = {
            "fx": torch.zeros((n_chunks * pix_per_chunk, 3), dtype=self.dtype, device=dev),
            "fw": torch.zeros((n_chunks * pix_per_chunk,), dtype=self.dtype, device=dev),
        }
        for ci in range(n_chunks):
            self._chunk(flat, ci * pix_per_chunk, n_pix, pix_per_chunk, spp)
        h, w = b.height, b.width
        return {
            "xyz": state["xyz"] + flat["fx"][: h * w].reshape(h, w, 3),
            "weight": state["weight"] + flat["fw"][: h * w].reshape(h, w),
            "splat_xyz": state["splat_xyz"],
        }

    def _render_scatter(self, state, sample_bounds, n_lanes, n_chunks, batch, spp,
                        cursor=0, ckpt=None):
        """Lanes pixel-major over the sample bounds (``spp`` consecutive
        samples per pixel), chunks ``cursor`` onwards; the last chunk's
        padding lanes repeat the last pixel with sample 0 and are masked
        out of the film.  ``ckpt`` = (path, meta) saves the state after
        every ``checkpoint_every`` chunks and after the last."""
        w = sample_bounds.width
        x0, y0 = sample_bounds.p_min
        every = max(1, self.options.checkpoint_every)
        for ci in range(cursor, n_chunks):
            lane = ci * batch + torch.arange(batch, device=self.device)
            lane_mask = lane < n_lanes
            pix = torch.clamp(lane, max=n_lanes - 1) // spp
            pixel_xy = torch.stack([x0 + pix % w, y0 + pix // w], dim=-1)
            sample_index = torch.where(lane_mask, lane % spp, 0)
            p_film, L, splats = self._radiance(pixel_xy, sample_index, spp)
            state = self.film.add_samples(state, p_film, L, mask=lane_mask)
            for ps, Ls, ms in splats:
                Ls = torch.where(torch.isfinite(Ls), Ls, 0.0) * (1.0 / spp)
                state = self.film.add_splats(state, ps, Ls, mask=ms & lane_mask)
            if ckpt is not None and ((ci + 1) % every == 0 or ci == n_chunks - 1):
                save_checkpoint(ckpt[0], state, ci + 1, ckpt[1])
        return state

    def image(self, state) -> np.ndarray:
        """Film state -> [H, W, 3] RGB on the host, in the policy's float (the splat
        channel added as the film holds it)."""
        return self.film.to_rgb(state).cpu().numpy()


def render_scene(desc, options: Options | None = None, seed: int = 0, write: bool = True,
                 device="cuda"):
    """A parsed scene -> its image, written to the film's filename when
    ``write``; returns {image, state, film, renderer, seconds}
    (``render_scene_spectral``'s dict under ``options.sampled_spectrum``)."""
    opt = options or Options()
    if opt.sampled_spectrum and spectrum.get_spectral_bins() is None:
        return render_scene_spectral(desc, opt, seed, write, device)
    r = Renderer(desc, options, seed, device=device)
    t0 = time.time()
    state = r.render()
    img = r.image(state)  # waits for the card
    dt = time.time() - t0
    stats.count("render/rays_traced", r.counters["camera_samples"])
    stats.timed_add("render/wall_seconds", dt)
    log.info("Rendered %dx%d @ %d spp in %.2fs", r.film.full_resolution[0],
             r.film.full_resolution[1], r.sampler.samples_per_pixel, dt)
    if write and r.film.filename:
        r.film.write_image(state)
        log.info("Wrote %s", r.film.filename)
    return {"image": img, "state": state, "film": r.film, "renderer": r, "seconds": dt}


def render_scene_spectral(desc, options: Options | None = None, seed: int = 0,
                          write: bool = True, device="cuda"):
    """Sampled-spectrum transport: ``options.n_spectral_bins`` bins (15 by
    default: 5 passes; 60 is the full grid), three a pass.  Each pass
    binds three bins to the RGB pipeline's channels and renders the scene
    anew (promotion happens at build time); the bins' radiances sum
    against the CIE fits into XYZ, then RGB.  The pass state is cleared
    however a pass ends.  Returns {image, film, seconds, xyz}."""
    opt = options or Options()
    n_bins = int(opt.n_spectral_bins)
    k = spectrum.N_SPECTRAL_SAMPLES
    if n_bins % 3 or k % n_bins:
        raise ValueError(f"n_spectral_bins={n_bins} must be a multiple of 3 dividing {k}")
    stride = k // n_bins
    chosen = np.arange(n_bins) * stride + stride // 2
    t0 = time.time()
    xyz = None
    film = None
    try:
        for p in range(n_bins // 3):
            bins = chosen[3 * p:3 * p + 3]
            spectrum.set_spectral_bins(bins)
            out = render_scene(desc, opt, seed, write=False, device=device)
            film = out["film"]
            img = np.asarray(out["image"], dtype=np.float64)  # three bins' radiances
            cmf = np.stack([spectrum._CIE_X[bins], spectrum._CIE_Y[bins],
                            spectrum._CIE_Z[bins]])  # [3 xyz, 3 bins]
            contrib = np.einsum("hwb,cb->hwc", img, cmf)
            xyz = contrib if xyz is None else xyz + contrib
            log.info("spectral pass %d/%d (bins %s)", p + 1, n_bins // 3, bins)
    finally:
        spectrum.set_spectral_bins(None)
    xyz = xyz * (stride / spectrum._CIE_Y_INTEGRAL)
    float_t = float_type(opt.double)
    img = np.asarray(spectrum.xyz_to_rgb(xyz.astype(float_t), float_t))
    dt = time.time() - t0
    log.info("Spectral render (%d bins, %d passes) in %.2fs", n_bins, n_bins // 3, dt)
    if write and film is not None and film.filename:
        from pbrt_tpu_torch.core.imageio import write_image

        write_image(film.filename, img.astype(float_t), film.cropped_pixel_bounds,
                    film.full_resolution)
        log.info("Wrote %s", film.filename)
    return {"image": img.astype(float_t), "film": film, "seconds": dt, "xyz": xyz}
