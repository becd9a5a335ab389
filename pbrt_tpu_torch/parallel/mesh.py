"""Mesh-parallel rendering and the distributed gradient step
(counterpart of ``pbrt_tpu/parallel/mesh.py``).

One process per mesh device, a ``DeviceMesh`` with axes (dp, sp):

* **dp**: the pixel batch is sharded, each rank traces its contiguous
  slice of every chunk;
* **sp**: samples per pixel are sharded, rank (i, j) traces sample
  indices ``s0 + j`` of pixel slice i;
* film merge: each rank adds its samples to a partial film that starts
  from zero, and the partial films are all-reduced over the whole mesh
  (the reference's psum over both axes), so every rank ends with the
  whole film;
* gradients: :meth:`ShardedRenderer.build_grad_step`.

Geometry is replicated on every rank; ``parallel/geomshard.py`` shards it.
Sample values depend only on (pixel, sample, dimension), never on the
rank, so every mesh shape renders the single renderer's image up to the
order of the film's sums.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from pbrt_tpu_torch.parallel.multihost import all_reduce_mesh, axis, global_mesh
from pbrt_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

log = logging.getLogger("pbrt_tpu_torch")

CHECKPOINT_NAME = "film-mesh.ckpt.npz"


def default_mesh(n_devices=None, sp: int = 1, device_type=None):
    """A (dp, sp) mesh over the world's ``n_devices`` ranks (all of them
    when None; a mesh cannot leave ranks out)."""
    n = n_devices or dist.get_world_size()
    if n != dist.get_world_size() or n % sp:
        raise ValueError(f"a mesh of {n} devices with sp={sp} does not fit a world of "
                         f"{dist.get_world_size()} ranks")
    return global_mesh(dp=n // sp, sp=sp, device_type=device_type)


class ShardedRenderer:
    """Mesh-parallel wrapper around a ``render.Renderer``; every rank
    holds the same renderer and calls the same methods."""

    def __init__(self, renderer, mesh):
        self.r = renderer
        self.mesh = mesh
        self._dp_group, self.dp, self.dp_index = axis(mesh, "dp")
        self._sp_group, self.sp, self.sp_index = axis(mesh, "sp")

    def _sharded_step(self, state, pixel_xy, s0, lane_mask, spp_bound):
        """One chunk: this rank's dp slice of ``pixel_xy`` at sample index
        ``s0 + sp index`` -> partial film from zero -> all-reduced over
        the mesh -> added to ``state``."""
        r = self.r
        per = pixel_xy.shape[0] // self.dp
        sl = slice(self.dp_index * per, (self.dp_index + 1) * per)
        px, mask = pixel_xy[sl], lane_mask[sl]
        sidx = torch.full((per,), s0 + self.sp_index, dtype=torch.int64, device=px.device)
        p_film, L, splats = r._radiance(px, sidx, spp_bound)
        zero = {k: torch.zeros_like(v) for k, v in state.items()}
        partial = r.film.add_samples(zero, p_film, L, mask=mask)
        for ps, Ls, ms in splats:
            Ls = torch.where(torch.isfinite(Ls), Ls, 0.0) * (1.0 / spp_bound)
            partial = r.film.add_splats(partial, ps, Ls, mask=ms & mask)
        summed = all_reduce_mesh(partial, self.mesh)
        return {k: state[k] + v for k, v in summed.items()}

    def render(self, spp=None, state=None):
        """Sweep every (pixel, sample) of the film over the mesh; returns
        the whole film state on every rank.  ``spp`` rounds up to a
        multiple of sp.  With ``options.checkpoint_dir``, rank 0 saves the
        film and the (round, chunk) cursor to ``film-mesh.ckpt.npz`` every
        ``checkpoint_every`` steps, and a render whose resolution, spp,
        step count and mesh match the file resumes from it on every rank."""
        r = self.r
        film = r.film
        dev = r.device
        pixels = film.get_sample_bounds().offsets().astype(np.int64)
        n_pix = len(pixels)
        spp = spp if spp is not None else r.sampler.samples_per_pixel
        rounds = max(1, -(-spp // self.sp))
        batch = min(r.options.ray_batch, max(self.dp, n_pix))
        batch = -(-batch // self.dp) * self.dp  # divisible by dp
        n_chunks = -(-n_pix // batch)
        pad = n_chunks * batch - n_pix
        if pad:
            pixels = np.concatenate([pixels, np.repeat(pixels[-1:], pad, axis=0)])
        chunks = torch.as_tensor(pixels.reshape(n_chunks, batch, 2), device=dev)
        masks = (torch.arange(n_chunks * batch, device=dev) < n_pix).reshape(n_chunks, batch)
        total_steps = rounds * n_chunks
        ckpt_path, resume_at, meta_want = None, 0, None
        if r.options.checkpoint_dir:
            ckpt_path = Path(r.options.checkpoint_dir) / CHECKPOINT_NAME
            meta_want = {"res": list(film.full_resolution), "spp": int(spp),
                         "steps": int(total_steps),
                         "mesh": sorted([n, s] for n, s in zip(self.mesh.mesh_dim_names,
                                                               self.mesh.shape))}
            if state is None:
                state, resume_at = self._resume(ckpt_path, meta_want, total_steps)
        if state is None:
            state = film.initial_state()
        every = max(1, r.options.checkpoint_every)
        step_i = 0
        with torch.no_grad():
            for rd in range(rounds):
                for ci in range(n_chunks):
                    if step_i < resume_at:
                        step_i += 1
                        continue
                    state = self._sharded_step(state, chunks[ci], rd * self.sp, masks[ci],
                                               rounds * self.sp)
                    step_i += 1
                    if ckpt_path is not None and dist.get_rank() == 0 and (
                            step_i % every == 0 or step_i == total_steps):
                        save_checkpoint(ckpt_path, state, step_i, meta_want)
        return state

    def _resume(self, path, meta_want, total_steps):
        """Rank 0 reads the checkpoint and hands (state, cursor) to every
        rank -> (state or None, cursor)."""
        got = [None]
        if dist.get_rank() == 0:
            loaded = load_checkpoint(path, "cpu")
            if loaded is not None:
                ck_state, cursor, meta = loaded
                if meta == meta_want and 0 < cursor <= total_steps:
                    got[0] = ({k: v.numpy() for k, v in ck_state.items()}, cursor)
                    log.info("Resuming from %s at step %d/%d", path, cursor, total_steps)
                else:
                    log.warning("Checkpoint %s does not match this render; ignoring", path)
        dist.broadcast_object_list(got, src=0)
        if got[0] is None:
            return None, 0
        state, cursor = got[0]
        return {k: torch.as_tensor(v, device=self.r.device) for k, v in state.items()}, cursor

    # -- the distributed inverse-rendering step -----------------------------

    def build_grad_step(self, target_image, spp: int = 2, lr: float = 0.5):
        """-> step(theta, pixel_xy) -> (loss, new_theta = theta - lr * grad),
        the gradient of :meth:`build_value_and_grad`."""
        value_and_grad = self.build_value_and_grad(target_image, spp)

        def step(theta, pixel_xy):
            loss, grad = value_and_grad(theta, pixel_xy)
            return loss, _map_pair(theta, grad, lambda p, g: p - lr * g)

        return step

    def build_value_and_grad(self, target_image, spp: int = 2):
        """-> fn(theta, pixel_xy) -> (loss, its gradient in theta's structure).

        Every rank passes the whole pixel batch (divisible by dp) and the
        same theta.  Rank (i, j) renders pixel slice i at sample indices
        ``s * sp + j`` for s < ``spp``; the radiance sums over sp before
        the loss is formed, and the loss is the mean over every pixel of
        the mesh (the reference's).  No gradient flows through a
        collective: the sp sum adds the other ranks' detached shares to
        this rank's own, each rank backpropagates its own lanes' share of
        its dp slice's loss term, and the gradients are all-reduced once
        over the mesh, so no share is counted twice."""
        from pbrt_tpu_torch.diff.grad import _map, make_radiance_fn

        r = self.r
        radiance = make_radiance_fn(r)
        target = torch.as_tensor(np.asarray(target_image), dtype=r.dtype, device=r.device)
        bx, by = r.film.cropped_pixel_bounds.p_min

        def value_and_grad(theta, pixel_xy):
            n_all = pixel_xy.shape[0]
            if n_all % self.dp:
                raise ValueError(f"{n_all} pixels do not split over dp={self.dp}")
            per = n_all // self.dp
            px = pixel_xy[self.dp_index * per:(self.dp_index + 1) * per]
            leaves = []

            def track(v):
                leaves.append(v.detach().clone().requires_grad_(True))
                return leaves[-1]

            tracked = _map(theta, track)
            acc = torch.zeros((per, 3), dtype=r.dtype, device=px.device)
            for s in range(spp):
                sidx = torch.full((per,), s * self.sp + self.sp_index, dtype=torch.int64,
                                  device=px.device)
                acc = acc + radiance(tracked, px, sidx)
            others = acc.detach().clone()
            if self.sp > 1:
                dist.all_reduce(others, group=self._sp_group)
            total = others + (acc - acc.detach())  # the sp sum; grad to own share
            rendered = total / (spp * self.sp)
            t = target[px[..., 1] - by, px[..., 0] - bx]
            part = torch.sum((rendered - t) ** 2) / (3.0 * per * self.dp)
            grads = torch.autograd.grad(part, leaves, allow_unused=True,
                                        materialize_grads=True)
            summed = all_reduce_mesh(dict(enumerate(grads), loss=part.detach()), self.mesh)
            loss = summed.pop("loss") / self.sp  # each dp term was summed sp times
            g_iter = iter(summed.values())
            return loss, _map(tracked, lambda _: next(g_iter))

        return value_and_grad


def _map_pair(a, b, fn):
    """fn over the leaves of two dicts of the same structure."""
    return {k: _map_pair(v, b[k], fn) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}
