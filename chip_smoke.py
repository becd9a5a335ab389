#!/usr/bin/env python3
"""Smoke test of pbrt_tpu_torch on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py            # the whole check
    python3 chip_smoke.py --profile  # plus torch.profiler over one config-3, one
                                     # Cornell, one config-5, one config-4, one
                                     # scene-file, one volume and one bdpt
                                     # frame (launches, device busy share;
                                     # phases 16 and 17 profile their motion
                                     # and fur frames always)
    python3 chip_smoke.py --phase 17 # phases 1-2 and 17 alone (also 12, 14,
                                     # 15, 16, 18 or 19); the last line then
                                     # says "phases": [1, 2, 17]

Phases (any failure raises and the script exits non-zero):

1. the card: requires CUDA, prints ``nvidia-smi`` name and power limit;
2. builds every hand-written kernel source (kernels/csrc/*.cu, one
   ``nvcc`` each, all started together) and prints the build seconds and
   ptxas' register, stack and spill lines;
3. each kernel against its plain PyTorch version (run on the card on the
   same tensors) at the inputs the main path gives it: one frame of
   each of phase 4's renderers is rendered with its walk's (or sort's)
   inputs recorded, and the recorded calls are replayed through the
   kernel and the plain version:
   - K2 ``stream_walk8``: config 3's fourteen 262,144-ray sweeps (camera,
     sorted bounce and shadow rays with their dead lanes);
   - K1 ``wide_walk8``: the small torus's seven 16,384-ray sweeps;
   - K4 ``stream_walk2``, K4b ``stream_walk2_fused``, K6 ``skip_walk``:
     every third of config 3's seven chunk-0 sweeps (0, 3, 6; all seven
     before phase 19) under ``walk="binary"``, ``"binary_fused"`` and
     ``"skip"``;
   - K4 ``ordered_walk2``: the small torus's seven sweeps, ``walk="binary"``;
   - K5 ``bitonic_tile`` + ``bitonic_merge`` + ``gather_rows``: every
     ``co_sort`` of 262,144 lanes in a config-3 frame under
     ``sort="bitonic"`` (12), each in one library call; on the widest,
     every launch of the schedule against its plain step.
   Besides, 262,144 random rays with finite t_max and every 97th lane
   dead on each config-3 walk's tables and on a 3000-triangle soup (the
   whole-tree walks), closest and any hit; 32,768 such rays through K4
   and K4b on one binary cluster of more than 1024 node rows (the soup in
   leaves of at most 3); 262,144 such rays, and the same with only 1000
   of them live (several segments per ray), through K6 and the whole-tree
   K4 on the soup with every triangle twice (exact t ties on every hit);
   and 262,144 random keys with heavy duplicates
   and bit 31 set on half.  Walks: hit masks equal, t
   within rtol 1e-6, slots equal except exact t ties; K6 and the
   whole-tree K4 (closest hit): every output bit-equal, K6's b0/b1 too;
   K5: keys and every payload column bit-equal.  The stack
   walks (K2, K1, K4, K4b) also print, per sweep, the live lanes, the
   plain walk's node steps and triangle tests per live ray and its
   deepest stack beside the kernel's template, and K2, K6 and the
   whole-tree K4 the segments per ray their kernels chose (K6 and K4 also
   the rays per task).  Then each
   kernel's time (CUDA events)
   beside its plain version's on the card (the walks: the check's one run,
   work counters on), its bound (the larger of
   bytes over 3.35 TB/s and float ops over 67 TFLOP/s, counted by the
   plain version on the same inputs) and, where one PyTorch call
   computes the same function, that call's time; for K5 besides, each
   kernel's device time from torch.profiler, the launches and library
   calls per co_sort, and the whole co_sort's time and bound beside
   ``torch.sort`` + gathers; per timed sweep, each walk's time (with S
   for K2 and K6), and K1's and the whole-tree K4's on each of the small
   torus's sweeps (live rays and, K4, S); for K6 and the whole-tree K4
   besides, the device time per sweep (torch.profiler: prepass and walk;
   the event times of small sweeps include the host's launch overhead);
4. the main path through the user entry points (``mesh_scene_renderer``,
   ``Renderer.render``): config 3 at 256x256, 8 spp, maxdepth 4 (50,180
   triangles: streaming walk) and the same scene with a 1152-triangle
   torus (whole-tree walk), under the default walk and sort, then under
   ``walk`` = binary, binary_fused, skip and ``sort="bitonic"`` (config
   3) and ``walk="binary"`` (small torus).  Each render runs with the
   launch counters zeroed before and read after: every kernel of its
   path must have launched, as many times as the path launches it; each
   variant's image must be finite, not black and equal to its default
   image to phase 5's tolerance;
5. image parity: config 3 at 32x32, 2 spp, maxdepth 3 on the card and on
   the CPU (plain versions), to the tolerance of tests/test_torch_slice.py;
6. frame seconds and Mray/s ((closest + shadow queries) / s) of the
   default and of each config-3 variant;
7. the Cornell box (BASELINE scene 2) through ``cornell_renderer`` at
   256x256, 32 spp, maxdepth 5, ``ray_batch = 1 << 18`` (8 chunks): the
   brute-force intersector, spheres and the mirror lobe, which no kernel
   serves (the launch counters, zeroed before the first frame, must read
   0 after it); the image finite and not black, the query counters
   2,097,152 x 5 closest and x 4 shadow; frame seconds (median of three
   after that first frame) and Mray/s beside the card's name and power
   limit;
8. image parity on the card against the CPU, to phase 5's tolerance:
   Cornell at 32x32 (2 spp, maxdepth 5); its variant with a constant
   infinite light, a gaussian pixel filter and a crop window (the
   escaped-ray MIS and the scatter film); and the 24x24 torus with a
   mirror sphere (1,156 triangles and the sphere sweep beside the BVH)
   under every walk, each CUDA render with the counters zeroed before it
   and its walk's kernel (K1, the whole-tree K4, K6) launched;
9. BASELINE config 5 at full width: the 1,000,004-triangle torus scene at
   256x256, 4 spp, maxdepth 4 (one 262,144-lane chunk): scene build
   seconds; a first frame with the counters zeroed before and read after
   (K2 ``stream_walk8`` launched 7 times, nothing else); the image finite
   and not black; the 7 sweeps of a recorded frame through K2 against its
   plain version run on the card, to phase 3's rules, and K2's time per
   sweep beside its bound; frame seconds (median of three) and Mray/s;
   the same scene's image on the card against the CPU's at 16x16, 1 spp,
   maxdepth 3, to phase 5's tolerance;
10. gradients (``diff/grad.py``): (a) one config-5 loss-and-gradient step
   at full width, ``make_loss_fn`` over all 65,536 pixels at 4 spp against
   a target rendered with the floor's kd changed: forward and
   forward+backward seconds (median of three), K2's launches in the
   forward and in the backward (the per-bounce checkpoint's replay, which
   must launch it, at most as often as the forward),
   ``torch.cuda.max_memory_allocated`` with ``remat=True`` and with
   ``remat=False`` (their gradients equal), the floor-kd gradient against
   a central finite difference (eps 1e-2, rtol 0.05, the difference
   non-zero), every leaf finite; (b) every gradient leaf on the card
   against the CPU's (rtol 1e-3, or 1e-6 of the CPU gradient's largest
   magnitude) on config 3 at 16x16 (K2, sorted carry), the 24x24 torus
   (K1), tests/test_grad.py's sphere and nested-mix scenes,
   tests/test_texture_grad.py's image-texture scene (its texture written
   as PFM under ``build/chip_smoke/``) and Cornell at 16x16 (area light,
   the mirror's kr), with Cornell's area-light gradient against finite
   differences on the card; (c) ``sort="bitonic"`` with a theta that
   requires grad raises on the card;
11. BASELINE config 4 at full width (``testscenes.config4_renderer``:
   config 3's camera, floor and 50,176-triangle torus, glossy plastic
   over a 256x256 image texture, rough copper, a glass and a substrate
   sphere, lit only by a 1024x1024 image-mapped environment light; maps
   written under ``build/chip_smoke/``) at 256x256, 8 spp, maxdepth 5:
   scene build seconds; a first frame with the counters zeroed before
   and read after (K2 ``stream_walk8`` launched 2 chunks x (5 + 4) = 18
   times, nothing else); the image finite and not black; the 18 sweeps
   of a recorded frame through K2 against its plain version on the card,
   to phase 3's rules, and K2's time per sweep beside its bound; frame
   seconds (median of three) and Mray/s; the image on the card against
   the CPU's at 32x32, 2 spp, maxdepth 5, to phase 5's tolerance; one
   loss-and-gradient step over all 65,536 pixels at 4 spp against a
   target rendered with the torus's roughness 0.3 (forward and
   forward+backward seconds, K2's launches in the forward and the
   replay, peak memory with and without remat and their gradients
   equal, every leaf finite, the torus's roughness leaf non-zero, its Ks
   against a central finite difference); every leaf on the card against
   the CPU's at 16x16, 2 spp, maxdepth 5, to phase 10 (b)'s tolerance;
12. BASELINE config 1's integrators: a stand-in for
   ``scenes/check-sphere.pbrt`` (``testscenes.CHECK_SPHERE``: one
   checkered matte sphere, a point light, box filter, 64x64, 8 spp)
   under ``directlighting``, ``whitted`` and ``ao``, and
   tests/test_direct.py's box under ``directlighting`` and ``ao``: each
   image on the card against the CPU's, to phase 5's tolerance, the
   query counters exact, no kernel launched (the brute-force sweep);
13. scene files through the front door (written under
   ``build/chip_smoke/``): (a) config 3 as a scene file whose torus is a
   binary little-endian PLY (``testscenes.config3_scenefile``), through
   ``python3 -m pbrt_tpu_torch`` as a subprocess (exit 0, the PFM written,
   the wall seconds with the process start and the build) and through
   ``cli.main`` in-process with the counters zeroed before (K2 x 14,
   nothing else), each PFM equal to phase 4's default image to phase 5's
   tolerance; (b) the scene vocabulary (``testscenes.scenefile_text``:
   the PLY torus as an object placed 4 times, a 256x256-sample
   heightfield, a Loop-subdivided icosahedron at 4 levels, the five
   quadrics with the disk as the area light, a NURBS patch, a point light,
   every procedural texture under every mapping; 354,250 triangles) at
   256x256, ``Sampler "sobol"``, 16 spp, maxdepth 3 (cut from 5 for phase 16), 4
   chunks: scene build seconds and the triangle count, a first frame
   through ``cli.main`` (K2 x 20, nothing else; the image finite and not
   black), then ``k2_frame`` (every 4th of the 20 sweeps against the
   plain walk on the
   card, K2's time per sweep, its mean over the checked sweeps beside
   their bound and the plain walk's time on them, frame seconds, Mray/s)
   and the card's
   image against the CPU's at 32x32, 2 spp, maxdepth 2 (cut from 3 for phase 16) under each of the
   six samplers (one build per device, the samplers swapped in); (c)
   that scene at 64x64 with ``checkpoint_every=1`` in 4 chunks, stopped
   after 2 and resumed in a fresh ``Renderer``, against the uninterrupted
   render (bit-equality reported, phase 5's tolerance required), and a
   checkpoint whose meta differs ignored;
14. participating media (written under ``build/chip_smoke/``): (a) the
   fog-and-smoke scene file (``testscenes.volume_text``: config 3's
   camera, lights and floor in a homogeneous fog, the 50,176-triangle PLY
   torus under ``Material "subsurface"``, a null-material box of
   heterogeneous smoke with a 64^3 inline density grid, a spot light;
   ``Integrator "volpath"``) at 256x256, 4 spp (cut from 8 for phase 16),
   maxdepth 5, one chunk, through ``cli.main``: the file's parse seconds
   alone (262,144 inline density values) and the scene build seconds, a
   first frame (K2 x 31: 5 x 3 march sweeps + 4 x 4 shadow segments,
   nothing else; the image finite and not black), then
   ``k2_frame`` (every 8th of the 31 sweeps against the plain walk on the
   card, K2's time per sweep, its
   mean over the checked sweeps beside their bound and the plain walk's
   time on them, frame seconds,
   Mray/s from volpath's ``queries_per_sample``); ``--profile`` adds a
   profiled frame, whose ~960,000 launches take the profiler minutes to
   sum; (b) the same scene at 32x32, 2 spp, maxdepth
   3, with a 16^3 grid, on the card against the CPU, to phase 5's
   tolerance; (c) delta and ratio tracking through the smoke
   (``testscenes.volume_rays``: 262,144 seeded lanes) on the card against
   the CPU: scattered masks equal on all but 1e-4 of the lanes, distances
   (where both scattered) within rtol 1e-5, transmittance within rtol 1e-5 /
   atol 1e-5;
15. bidirectional and Metropolis transport through the pbrt command, and
   volpath gradients (written under ``build/chip_smoke/``): (a) config 3
   as a scene file under ``Integrator "bdpt" "integer maxdepth" 4`` at
   256x256, 8 spp, 2 chunks, through ``cli.main``: scene build seconds,
   peak memory, a first frame (K2 x 64: 2 chunks x (9 closest + 23
   any-hit sweeps), nothing else; the image finite and not black, the
   splat channel non-zero), ``k2_frame`` (every 4th sweep against the
   plain walk on the card, K2's time per sweep and its bound, frame
   seconds, Mray/s from BDPT's ``queries_per_sample``), and the film and
   the splat channel on the card against the CPU at 32x32, 2 spp,
   maxdepth 2 (cut from 3 for phase 16), each to phase 5's tolerance; (b) the same scene under
   ``Integrator "mlt" "integer mutationsperpixel" 8`` (65,536 chains, 11
   evaluations: K2 x 352, nothing else): seconds, acceptance and b; the
   image finite, not black, its mean within rtol 0.15 of (a)'s and b
   within rtol 0.1 of (a)'s mean luminance; at 32x32, one evaluation of a
   seeded 1,024-lane primary-sample table on the card against the CPU to
   phase 5's tolerance and the bootstrap b within rtol 1e-4; (c) phase
   14's scene (64^3 grid, maxdepth 5) at 1 spp: one ``make_loss_fn`` step over all
   65,536 pixels with ``remat=True`` (its forward's seconds, taken inside
   the step since phase 19, and forward+backward
   seconds, K2's launches in the forward and in the replay, which must
   launch it, peak memory, every leaf finite), the same step without
   remat (gradients equal, its peak; a 4,096-pixel pair of steps before
   phase 19: the step is host-bound, so the pair cost two full steps), and every leaf on the card
   against the CPU's at 16x16 (a 16^3 grid, maxdepth 2), to phase 10 (b)'s tolerance;
16. motion blur, SPPM and the environment and realistic cameras through
   the pbrt command (written under ``build/chip_smoke/``): (a) config 3 as
   a scene file whose PLY torus turns 30 degrees about its axis across
   ``shutteropen 0 shutterclose 1`` (4 keyframes) while the camera moves
   0.25 along x (``testscenes.config3_scenefile`` with ``rotate`` and
   ``shift``), ``path`` at
   256x256, 8 spp, maxdepth 4, 2 chunks, through ``cli.main``: scene
   build seconds, a first frame (K7 ``anim_walk`` x 14: 2 chunks x (4
   closest + 3 any-hit), nothing else; the image finite and not black),
   every 5th (every 4th before phase 19) of a recorded frame's sweeps through K7 against
   ``anim_walk_plain`` run on the card (hit masks equal, t within rtol
   1e-6, prims equal except on exact t ties, b0 and b1 within 2e-5; the
   prepass's live count equal to the live lanes), K7's time per sweep
   with its live rays, rays per task and lanes a ray
   (``anim_walk.task_stats``) beside its bound (rays in and out once, distinct node
   and keyframe rows once, 25 ops a box test and 59 + 27 a blended
   triangle test: the blend reads only the two keys of non-zero weight,
   9 products and 9 fused multiply-adds), frame seconds (median of three after the first), the
   launches and the card's busy share of a profiled frame, and the scene
   at 16x16 (32x32 before phase 19), 2 spp, maxdepth 3 on the card against the CPU to phase 5's
   tolerance; (b) tests/test_motion_integrators.py's moving quad under
   ``volpath``, ``bdpt`` and ``sppm`` and a moving (tessellated) sphere
   under ``path``, 16x16, card against CPU (the quad's two triangles take
   the brute-force sweep, the sphere K7), and the quad under ``mlt`` (4
   mutations per pixel) through the pbrt command on both, held as phase 15 (b)
   holds MLT: one evaluation of a seeded 1,024-lane table (the shutter
   time from its dimension 4) to phase 5's tolerance, b within rtol 1e-4,
   the acceptance within 0.05 and the image's mean within rtol 0.15; (c) config 3 under ``sppm``,
   256x256, maxdepth 4, 16 iterations, photons and radius by default
   (65,536 and 1% of the scene's diagonal): build seconds, the first
   render (K2 x 192: 16 x (4 camera + 4 light-sample + 4 photon sweeps),
   nothing else; the image finite and not black), every 4th recorded
   sweep against the plain walk on the card (the phase rotating by one
   each iteration, so that each of an iteration's 12 sweeps is checked
   every 4th iteration), K2's time per sweep and its
   bound, render seconds (median of two after the first), eager ops an
   iteration outside the walks (a CPU count on a 24x24 torus), peak
   memory, and 32x32 with 2 iterations card against CPU; (d) config 3
   under ``Camera "environment"`` and under ``Camera "realistic" "string
   lensfile" "biconvex-50mm-f8"``: a first frame each (K2 x 14), frame
   seconds, and 32x32 card against CPU;
17. hair, the fourier BSDF, sampled-spectrum rendering and BDPT gradients
   through the pbrt command (written under ``build/chip_smoke/``): (a) a
   fur ball (``testscenes.fur_text``: 4,096 cubic Bezier ``Shape "curve"``
   of ``type "flat"`` rooted on a matte unit sphere, tessellated as tubes
   of 96 triangles, 393,216 curve triangles, one named hair material in
   melanin mode, a floor, a quad area light and a constant infinite
   light) at 256x256, 4 spp (8 before phase 19), ``path`` maxdepth 8, one
   chunk, through ``cli.main``: build seconds and the triangle count, a
   first frame (K2 x 15: 8 closest + 7 shadow, nothing else), ``k2_frame``
   (every 4th sweep against the plain walk on the card, K2's time per
   sweep and its bound, frame seconds), the launches and busy share of a
   profiled frame, and 16x16 (32x32 before phase 19; 1 spp, maxdepth 4)
   card against CPU; (b)
   config 3's torus under ``Material "fourier"`` with a glossy 8-order
   table on 64 knots (``testscenes.glossy_fourier_table``, written by
   ``FourierTable.write``) at 256x256, 8 spp, maxdepth 4: build seconds,
   a first frame (K2 x 14, nothing else), frame seconds (median of three)
   and 16x16 (32x32 before phase 19) card against CPU; (c) config 3 through ``cli.main
   --sampled-spectrum`` (15 bins, 5 passes, each building the
   scene anew): the render seconds, the builds' seconds, K2 x 70, the
   image written, and 16x16 (32x32 before phase 19) card against CPU; (d) BDPT on config 3 at 4
   spp against a target with the floor's kd changed: a 4,096-pixel step
   with and without remat (gradients equal: BDPT has no per-bounce
   checkpoint) sizes the batch, the largest power of two up to 65,536
   pixels whose step stays below 40 GiB; at that batch K2's launches
   (forward only: no replay), peak memory, forward and forward+backward
   seconds (median of three), every leaf finite, the floor's kd against
   a central finite difference; every leaf card against CPU at 16x16, 1
   spp, maxdepth 3, to phase 10 (b)'s tolerance;
18. the sort switches and the sharded paths (``parallel/``), the worlds
   spawned by ``parallel/multihost.run_local_world`` on the one card,
   each with a deadline (a rank that raises or a world that misses it
   fails the phase): (a) config 3 (phase 4's) under ``shadow_sort`` =
   sorted, unsorted and merged, ``sorted_carry=False``, ``deadbit=False``
   and ``key_obits=4``: K2 x 14 each, each image against phase 4's default
   to phase 5's tolerance, frame seconds (median of three, taken in
   turns); under sorted, unsorted and merged, one frame's K2 sweeps and
   ``co_sort`` calls recorded and each timed alone: K2's ms over the
   closest-hit and over the shadow sweeps, the sorts' ms; (b) the 24x24
   torus (1,156 triangles) under ``stream_min_tris=512``: K2 x 7 in place of K1, the image against the
   whole tree's; (c) ``ShardedRenderer`` in a world of 4 gloo ranks (dp=2,
   sp=2) on config 3 at 256x256, 8 spp, maxdepth 4: every rank's film
   equal, against phase 4's default image; K2 x 28 a rank; the render's
   seconds per rank; its ``build_value_and_grad`` step over the film's
   first 4,096 pixels at 2 samples a pixel against a target with the
   floor's kd changed: loss (rtol 1e-4) and every leaf (phase 10 (b)'s
   tolerance) against the single card's ``make_loss_fn``; (d) the same in
   a world of 1 under nccl; (e) config 5's 1,000,004 triangles sharded
   over tp=4 gloo ranks in packed tables (built and saved per shard
   under ``build/chip_smoke/``, each rank loading its own), through
   ``make_sharded_path_fn`` at 256x256, 4 spp, maxdepth 4 (config 5's
   camera, the harness's matte and environment): allreduce and ring, each
   image against the tp=1 render in the nccl world and against each
   other, K2 launches per rank, seconds per rank; rank 0's four shard
   sweeps, recorded in the world and checked once it has exited (no other
   rank on the card), through K2 and its plain version on rank 0's shard
   tables (``check_walk``, phase 3's rules) and K2's time per sweep,
   timed as phase 3's, beside its bound; (f) ``make_sharded_grad_fn``
   on (e)'s shards at 65,536 pixels, tp=4 (remat on and off) against
   tp=1: loss rtol 1e-4, every leaf to phase 10 (b)'s tolerance, K2
   launched in the replay, per-rank peak memory; (g) a world of 2 gloo
   ranks with skip-link shards of config 3's triangles (256x256, 1 spp,
   maxdepth 3): K6 per shard, rank 0's sweeps (checked and timed after
   the world, as (e)'s) bit-equal against its plain version, the image
   against packed shards';
19. the float64 policy (``double=True``, the reference's
   ``PBRT_TPU_DOUBLE=1``): (a) config 3 (phase 4's) in double through
   ``mesh_scene_renderer``, the counters zeroed before its first frame
   and read after (K2 x 14, nothing else), every sweep's rays (cast to
   float32 at the walk) through K2 and its plain version (phase 3's
   rules), the float64 image against the float32 image to phase 5's
   tolerance, frame seconds in double and in float32 (medians of three,
   taken in turns), and under ``sort="bitonic"`` every ``co_sort`` of a
   frame, its float64 payload columns included, through K5 against the
   plain network (bit-equal); (b) phase 16 (a)'s config 3 in motion, in
   double through ``cli.main --double`` (256x256, 8 spp, maxdepth 4, 2
   chunks), the counters zeroed before and read after (K7's double
   instance x 14, nothing else), every 5th recorded sweep through it and
   its plain version (masks equal, t within rtol 1e-12, prims equal but
   on exact ties, b0 and b1 within 1e-9; the lane of the largest |b0|,
   |b1| difference logged with its det and the triangle's keyframe rows),
   every sweep timed with its live rays, rays per task and lanes a ray
   beside its bound (bytes over 3.35 TB/s, FP64 operations over 33.5 TFLOP/s), and
   its time against phase 16 (a)'s float instance's in a whole run; (c) Cornell in double at
   phase 7's size (no kernel; frame seconds, median of three) and at
   32x32, 2 spp, maxdepth 5 on the card against the CPU to phase 5's
   tolerance; (d) ``tests/test_refrender.py``'s GI box at 16x16, 4 spp,
   maxdepth 4 on the card in float32 and in double against
   ``refrender.py`` fed the card's own sample stream, to
   ``tests/test_torch_refrender.py``'s bounds.

The lines before the last are JSON objects: ``{"cornell": ...}``,
``{"config5": ...}``, ``{"gradients": ...}``, ``{"config4": ...}``,
``{"integrators": ...}``, ``{"scenefile": ...}``, ``{"volume": ...}``,
``{"bdpt": ...}``, ``{"motion": ...}``, ``{"features": ...}``,
``{"sharded": ...}``, ``{"double": ...}`` and one with an entry per kernel (K2's holds phase 13's sweeps and launches
under ``"scenefile"``, phase 14's under ``"volume"`` with phase 15 (c)'s
gradient launches, phase 15's under ``"bdpt"`` and ``"mlt"``, phase 16
(c)'s under ``"sppm"``, phase 17 (a)'s under ``"fur"`` and phase 18 (e)-(f)'s
per-shard sweeps and launches per rank under ``"sharded"``, as K6's
phase 18 (g)'s; K7's launches
are phase 16 (a)'s frame's, K7<double>'s phase 19 (b)'s); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

PIXELS = 256 * 256
SWEEP = 262144  # rays per timed sweep (one config-3 chunk)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
F64_OPS_PER_S = 33.5e12  # H100 SXM, float64 outside the tensor cores
# float operations per box (slab) test and per Moller-Trumbore triangle
# test, counted from the kernels' code: 6 sub, 6 mul, 10 min/max and 3
# compares; 15 sub, 27 mul, 9 add, 1 div, 1 abs and 6 compares
SLAB_OPS = 25
TRI_OPS = 59
DEVICE = "cuda"
SCENES = {"config3": dict(xres=256, yres=256, spp=8, maxdepth=4, ray_batch=1 << 18),
          "small": dict(xres=64, yres=64, spp=4, maxdepth=4, ray_batch=1 << 18,
                        nu=24, nv=24)}
CSRC = "pbrt_tpu_torch/kernels/csrc/"
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "stream_walk8": ("bvh8_walk.cu", "pbrt_tpu/ops/stream_bvh.py:471"),
    "wide_walk8": ("bvh8_walk.cu", "pbrt_tpu/ops/bvh8.py:346"),
    "stream_walk2": ("bvh2_walk.cu", "pbrt_tpu/ops/stream_bvh.py:200"),
    "stream_walk2_fused": ("bvh2_walk.cu", "pbrt_tpu/ops/stream_bvh.py:338"),
    "ordered_walk2": ("bvh2_walk.cu", "pbrt_tpu/ops/pallas_bvh.py:242"),
    "skip_walk": ("bvh2_walk.cu", "pbrt_tpu/ops/pallas_bvh.py:56"),
    "bitonic_tile": ("bitonic.cu", "pbrt_tpu/ops/sortnet.py:94"),
    "bitonic_merge": ("bitonic.cu", "pbrt_tpu/ops/sortnet.py:151"),
    # the payload columns the reference moves through every stage of K5
    "gather_rows": ("bitonic.cu", "pbrt_tpu/ops/sortnet.py:94"),
    # motion blur's walk, which the reference runs as XLA code
    "anim_walk": ("anim_walk.cu", "pbrt_tpu/ops/animated_intersect.py:176 _bvh_walk "
                  "(jax.lax.while_loop; no Pallas kernel)"),
    # its double instance, under the double policy (the reference's
    # float64 blend, :57-58, and walk)
    "anim_walk_f64": ("anim_walk.cu", "pbrt_tpu/ops/animated_intersect.py:176 _bvh_walk "
                      "under PBRT_TPU_DOUBLE=1 (jax.lax.while_loop; no Pallas kernel)"),
}
# the walks that cut a ray's walk into segments on sparse sweeps (K2 aside)
SPLIT_WALKS = ("ordered_walk2", "skip_walk")
PHASE3_STRIDE = 3  # phase 3 checks every third chunk-0 sweep of K4, K4b and K6
# the renderers of phase 4: config 3 (or the small torus) under a walk and sort
VARIANTS = {
    "default": ("config3", "bvh8", "stable"),
    "small": ("small", "bvh8", "stable"),
    "binary": ("config3", "binary", "stable"),
    "binary_fused": ("config3", "binary_fused", "stable"),
    "skip": ("config3", "skip", "stable"),
    "small_binary": ("small", "binary", "stable"),
    "bitonic": ("config3", "bvh8", "bitonic"),
}
# which variant's frame drives each kernel
PATH_OF = {"stream_walk8": "default", "wide_walk8": "small", "stream_walk2": "binary",
           "stream_walk2_fused": "binary_fused", "skip_walk": "skip",
           "ordered_walk2": "small_binary", "bitonic_tile": "bitonic",
           "bitonic_merge": "bitonic", "gather_rows": "bitonic"}


T0 = time.time()


def log(*a):
    """Print a line; a phase's header (``== ...``) with the seconds since
    the script started."""
    if a and str(a[0]).startswith("=="):
        a = (f"{a[0]} [{time.time() - T0:.1f} s]",) + a[1:]
    print(*a, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=True):
    """Mean milliseconds of fn() over reps runs, CUDA events, after a warm-up."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    """(ms, "bytes" or "operations"): the least time for this work (its
    operations at ``ops_per_s``: float32's rate unless given)."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def renderers():
    """Phase 4's renderers on the card, one per variant."""
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    return {name: mesh_scene_renderer(**SCENES[scene], walk=walk, sort=sort,
                                      device=DEVICE)[0]
            for name, (scene, walk, sort) in VARIANTS.items()}


def chunk_lanes(renderer):
    """Lanes per wavefront chunk of ``renderer`` (as ``Renderer.render``)."""
    spp = renderer.sampler.samples_per_pixel
    lanes = renderer.film.get_sample_bounds().area() * spp
    return max(spp, min(renderer.options.ray_batch, lanes) // spp * spp)


def frame_chunks(renderer):
    """Wavefront chunks per frame of ``renderer``."""
    spp = renderer.sampler.samples_per_pixel
    return -(-renderer.film.get_sample_bounds().area() * spp // chunk_lanes(renderer))


def per_sort(kname, n):
    """Launches of a K5 kernel per co_sort of n lanes: the network's
    schedule (a first tile launch, then per merge size above a tile its
    merge launches and a tile tail) and one gather."""
    from pbrt_tpu_torch.kernels import bitonic

    if kname == "gather_rows":
        return 1
    kind = kname.removeprefix("bitonic_")
    return sum(s[0] == kind for s in bitonic.schedule(bitonic.padded_size(n)))


def reset_counts():
    from pbrt_tpu_torch.kernels import anim_walk, bitonic, bvh2_walk, bvh8_walk

    for mod in (bvh8_walk, bvh2_walk, bitonic, anim_walk):
        mod.reset_launch_counts()


def read_counts():
    from pbrt_tpu_torch.kernels import anim_walk, bitonic, bvh2_walk, bvh8_walk

    return {**bvh8_walk.LAUNCHES, **bvh2_walk.LAUNCHES, **bitonic.LAUNCHES,
            **anim_walk.LAUNCHES}


def record_walks(renderer):
    """Render one frame, keeping what the intersector hands its walk on
    every sweep: ([N, 3] o, [N, 3] d, [N] t_max, any_hit)."""
    import torch

    walk = renderer.compiled.intersector.walk
    calls = []

    def recorder(fn, any_hit):
        def wrapped(o, d, t_max):
            cols = lambda v: (torch.stack(v, 1) if isinstance(v, (tuple, list))  # noqa: E731
                              else v).clone()
            calls.append((cols(o), cols(d), t_max.contiguous().clone(), any_hit))
            return fn(o, d, t_max)
        return wrapped

    walk.traverse = recorder(walk.traverse, False)
    walk.occluded_slots = recorder(walk.occluded_slots, True)
    try:
        renderer.render()
        torch.cuda.synchronize()
    finally:
        del walk.traverse, walk.occluded_slots
    return calls


def record_sorts(renderer):
    """Render one frame, keeping the operands of every ``co_sort`` call
    that takes the bitonic network (N >= 32768)."""
    import torch

    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.ops import sortnet

    calls = []
    orig = sortnet.co_sort

    def wrapped(operands, network="stable"):
        if network == "bitonic" and operands[0].shape[0] >= sortnet.MIN_N:
            calls.append(tuple(x.clone() for x in operands))
        return orig(operands, network)

    sortnet.co_sort = path.co_sort = wrapped
    try:
        renderer.render()
        torch.cuda.synchronize()
    finally:
        sortnet.co_sort = path.co_sort = orig
    return calls


def random_rays(n, seed, lo, hi, live=None):
    """n random rays on the card: t_max uniform in [0.05, 4), every 97th
    lane dead (t_max = 0); ``live``: only that many lanes, scattered, keep
    their t_max."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = rng.uniform(0.05, 4.0, n).astype(np.float32)
    t_max[::97] = 0.0
    if live is not None:
        keep = np.zeros(n, bool)
        keep[rng.choice(n, live, replace=False)] = True
        t_max[~keep] = 0.0
    return tuple(torch.as_tensor(a, device=DEVICE) for a in (o, d, t_max))


def walk_call(name, walk, o, d, t_max):
    """(kernel fn, plain fn, args on the card, keyword args, tris table,
    bytes per table row (node, leaf), bytes out per ray, rays, blocks)
    for the walk ``name`` over ``walk``'s tables on these rays."""
    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk
    from pbrt_tpu_torch.ops.stream_bvh import _stream_candidates, split_pad_rays

    comps = split_pad_rays(o, d, t_max, o.shape[0])
    kw = {}
    if name.startswith("stream_"):
        clist, cnt = _stream_candidates(walk.cl_min, walk.cl_max, comps)
        args = (walk.nodes, walk.tris, walk.roots, clist, cnt, comps)
        blocks = cnt.shape[0]
    elif name == "skip_walk":
        args = (walk.nodes_f, walk.nodes_i, walk.tris, comps)
        blocks = None
    else:
        args = (walk.nodes, walk.tris, walk.root, comps)
        blocks = None
    fns = {"stream_walk8": (bvh8_walk.stream_walk8, bvh8_walk.stream_walk8_plain),
           "wide_walk8": (bvh8_walk.wide_walk8, bvh8_walk.wide_walk8_plain),
           "stream_walk2": (bvh2_walk.stream_walk2, bvh2_walk.stream_walk2_plain),
           "stream_walk2_fused": (bvh2_walk.stream_walk2, bvh2_walk.stream_walk2_plain),
           "ordered_walk2": (bvh2_walk.ordered_walk2, bvh2_walk.ordered_walk2_plain),
           "skip_walk": (bvh2_walk.skip_walk, bvh2_walk.skip_walk_plain)}
    if name.startswith("stream_walk2"):
        kw["fused"] = name.endswith("fused")
    if name.startswith("stream_walk") or name in ("wide_walk8", "ordered_walk2"):
        kw["depth"] = walk.depth
    node_bytes = {"stream_walk8": 256, "wide_walk8": 256, "skip_walk": 48}.get(name, 64)
    leaf_bytes = 64 if name == "skip_walk" else 512
    out_bytes = 16 if name == "skip_walk" else 8
    return fns[name] + (args, kw, walk.tris, (node_bytes, leaf_bytes), out_bytes,
                        comps[0].shape[0], blocks)


def kernel_call(name, walk, o, d, t_max, any_hit):
    """(kernel fn, args, keyword args) of the walk ``name`` on these rays,
    as ``check_walk`` returns it, unchecked."""
    kern_fn, _, args, kw = walk_call(name, walk, o, d, t_max)[:4]
    return kern_fn, args, dict(kw, any_hit=any_hit)


def check_walk(name, label, walk, o, d, t_max, any_hit):
    """The kernel ``name`` against its plain version (run on the card) on
    the inputs its intersector builds for these rays, to the contract of
    ``bvh8_walk.walk_disagreement``; the whole-tree K4 and K6, closest
    hit: every output bit-equal (K6: t, triangle, b0 and b1).  Returns
    (max |dt| (or |db|) over hit lanes, the kernel's call, (bytes, ops) of
    the work, (live lanes, node steps and triangle tests per live lane of
    the plain walk, the segments per ray that K2, K6 or the whole-tree K4
    chose), the plain walk's ms: this one run, with its work counters on,
    by CUDA events)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.kernels import bvh2_walk, bvh8_walk
    from pbrt_tpu_torch.kernels.bvh8_walk import counted, walk_disagreement

    kern_fn, plain_fn, args, kw, tris, row_bytes, out_bytes, n_pad, blocks = walk_call(
        name, walk, o, d, t_max)
    kern = kern_fn(*args, any_hit=any_hit, **kw)
    torch.cuda.synchronize()
    split = (bvh8_walk.segment_stats() if name == "stream_walk8" else
             bvh2_walk.segment_stats() if name in SPLIT_WALKS else {})
    segments, rays = split.get("segments"), split.get("rays_per_task")
    counters, out = {}, []
    plain_ms = cuda_ms(lambda: out.append(plain_fn(*args, any_hit=any_hit, counters=counters,
                                                   **kw)), 1, warmup=False)
    plain = out[0]
    n = o.shape[0]
    o, d, t_max = (x.cpu().numpy() for x in (o, d, t_max))
    t_k, s_k = (x.cpu().numpy()[:n] for x in kern[:2])
    t_p, s_p = (x.cpu().numpy()[:n] for x in plain[:2])
    tris = tris.cpu().numpy()
    problem = walk_disagreement(t_p, s_p, t_k, s_k, any_hit, tris, o, d)
    hit = s_p >= 0
    err = 0.0 if any_hit or not hit.any() else float(np.abs(t_k[hit] - t_p[hit]).max())
    if problem is None and name in SPLIT_WALKS and not any_hit:
        for i, (k, p) in enumerate(zip(kern, plain)):
            if not np.array_equal(k.cpu().numpy()[:n], p.cpu().numpy()[:n]):
                problem = f"output {i} (t, slot, b0, b1) not bit-equal"
    if problem is not None:
        raise AssertionError(f"{name} {label} (any_hit={any_hit}): {problem}")
    live = t_max > 1e-4
    finite = live & (t_max < 1e7)
    shape = (f"{n} rays{'' if blocks is None else f' ({blocks} blocks)'}, "
             f"{n - live.sum()} dead, {finite.sum()} with finite t_max")
    if any_hit:
        log(f"  {name} {label} any-hit, {shape}: {hit.sum()} occluded, masks equal")
    else:
        log(f"  {name} {label} closest, {shape}: {hit.sum()} hit, "
            f"{(hit & (s_k != s_p)).sum()} tie slots, max |dt| {err:.3e}")
    c = counted(counters)
    n_live = int(live.sum())
    boxes_per_step = {"stream_walk8": 8, "wide_walk8": 8, "skip_walk": 1}.get(name, 2)
    stats = (n_live, c["slab_tests"] / boxes_per_step / max(n_live, 1),
             c["tri_tests"] / max(n_live, 1), segments, rays)
    if "depth" in kw:
        cap = (bvh8_walk if name.endswith("walk8") else bvh2_walk).stack_capacity(kw["depth"])
        log(f"    {n_live} live lanes: {stats[1]:.2f} node steps and {stats[2]:.2f} triangle "
            f"tests per live lane, deepest stack {counters['stack_max']} (tree depth "
            f"{kw['depth']}, {cap}-entry stack)"
            + ("" if segments is None else f", {segments} segments per ray"))
    n_bytes = (n_pad * (28 + out_bytes) + c["node_rows"] * row_bytes[0]
               + c["leaf_rows"] * row_bytes[1]
               + sum(a.numel() * 4 for a in args[3:5] if name.startswith("stream_")))
    n_ops = c["slab_tests"] * SLAB_OPS + c["tri_tests"] * TRI_OPS
    return err, (kern_fn, args, dict(kw, any_hit=any_hit)), (n_bytes, n_ops), stats, plain_ms


def check_sort(label, operands):
    """``co_sort(network="bitonic")`` on the card against the plain
    network run on the card: keys and every payload column bit-equal."""
    import torch

    from pbrt_tpu_torch.kernels.bitonic import bitonic_co_sort_plain
    from pbrt_tpu_torch.ops.sortnet import co_sort

    got = co_sort(operands, "bitonic")
    torch.cuda.synchronize()
    keys_s, _, cols = bitonic_co_sort_plain(operands[0].contiguous(), operands[1:])
    for i, (g, w) in enumerate(zip(got, (keys_s,) + tuple(cols))):
        if not torch.equal(g, w):
            raise AssertionError(f"bitonic co_sort {label}: operand {i} differs")
    cols = sum(x[0].numel() for x in operands)
    log(f"  bitonic co_sort {label}: {operands[0].shape[0]} lanes, {cols} columns, "
        f"keys and payload bit-equal")


def soup_tables(leaf, twin=False):
    """A 3000-triangle soup's build (host arrays, leaf size ``leaf``);
    ``twin``: every triangle twice, so every hit is an exact t tie."""
    import numpy as np

    from pbrt_tpu_torch.accel.bvh import build_bvh

    rng = np.random.default_rng(0)
    c = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    soup = (c, c + rng.uniform(-0.08, 0.08, (3000, 3)).astype(np.float32),
            c + rng.uniform(-0.08, 0.08, (3000, 3)).astype(np.float32))
    if twin:
        soup = tuple(np.concatenate([p, p]) for p in soup)
    m, x, s, f, cc, perm = build_bvh(*soup, leaf_size=leaf)
    return (m, x, s, f, cc) + tuple(p[perm] for p in soup)


def time_walks(name, calls, stats, plain_ms):
    """Kernel ms per sweep over ``calls`` (mean of 20 launches after one)
    beside ``plain_ms`` (the plain versions' times from their checks), and
    for the split walks the kernels' device ms per sweep, with a line per
    sweep."""
    import numpy as np

    ms = [cuda_ms(lambda: fn(*args, **kw), 20) for fn, args, kw in calls]
    dev = walk_device_ms(name, calls)
    log(f"  {name}: kernel {[round(t, 4) for t in ms]} ms, plain "
        f"{[round(t, 1) for t in plain_ms]} ms")
    sweep_lines(name, ms, stats, dev)
    return ms, float(np.mean(plain_ms)), dev


def walk_device_ms(name, calls):
    """Device ms per call (torch.profiler: the prepass and the walk) of
    each of ``calls`` for the split walks, else None.  On the small
    sweeps, event times include the host's launch overhead."""
    if name not in SPLIT_WALKS:
        return None
    names = ("whole_prep_kernel", f"{name}_kernel")
    out = []
    for fn, args, kw in calls:
        got = [v[0] for v in profiled_ms(lambda: fn(*args, **kw), 10, names).values()
               if v[0] is not None]
        out.append(sum(got) if got else None)  # None: the trace held neither kernel
    return out


def sweep_lines(name, ms, stats, dev=None):
    """One line per timed sweep of a walk: its live lanes, the plain walk's
    work per live lane, the kernel's ms (and device ms) and (K2, K6,
    whole-tree K4) segments per ray; a sweep without stats (not checked)
    gets its ms alone."""
    for i, (t, st) in enumerate(zip(ms, stats)):
        if st is None:
            log(f"    sweep {i}: {t:.4f} ms (not checked)")
            continue
        n_live, steps, tris, segments, rays = st
        log(f"    sweep {i}: {n_live} live lanes, {steps:.2f} node steps and {tris:.2f} "
            f"triangle tests per live lane, {t:.4f} ms = "
            f"{t * 1e6 / max(steps, 1e-9):.1f} ns per node step of the mean lane"
            + ("" if dev is None else ", device not measured" if dev[i] is None
               else f", device {dev[i]:.4f} ms")
            + ("" if segments is None else f", S = {segments}")
            + ("" if rays is None else f", {rays} rays per task"))


def profiled_ms(fn, reps, names):
    """torch.profiler over ``reps`` runs of fn (after one): per kernel
    whose name contains one of ``names``, (device ms per run, launches per
    run); (None, 0) where the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0.0) if t is None else t
        for nm in names:
            if nm in e.key and t > 0:
                us[nm] += t
                count[nm] += e.count
    return {nm: (us[nm] / 1e3 / reps if count[nm] else None, count[nm] / reps)
            for nm in names}


def phase_sort(ops):
    """K5 on one recorded co_sort: every launch of the network's schedule
    and the gather against their plain steps (run on the card); the launches
    and library calls of one co_sort; each kernel's time by CUDA events
    and by the profiler's device time beside its plain version's, its
    bound and a PyTorch call; the whole co_sort beside ``torch.sort`` +
    one gather per operand."""
    import math

    import torch

    from pbrt_tpu_torch.kernels import bitonic
    from pbrt_tpu_torch.ops.sortnet import co_sort

    keys, payload = ops[0], list(ops[1:])
    n = keys.shape[0]
    n_pad = bitonic.padded_size(n)
    steps = bitonic.schedule(n_pad)
    packed = torch.empty(n_pad, dtype=torch.int64, device=DEVICE)
    packed_p = torch.empty_like(packed)
    out = tuple(torch.empty(n, dtype=torch.int64, device=DEVICE) for _ in range(2))
    out_p = tuple(torch.empty_like(x) for x in out)
    for i, (kind, *a) in enumerate(steps):
        last = i == len(steps) - 1
        if kind == "merge":
            bitonic.bitonic_merge(packed, *a)
            bitonic.bitonic_merge_plain(packed_p, *a)
        else:
            bitonic.bitonic_tile(packed, *a, keys=keys if i == 0 else None,
                                 out=out if last else None)
            bitonic.bitonic_tile_plain(packed_p, *a, keys=keys if i == 0 else None,
                                       out=out_p if last else None)
        torch.cuda.synchronize()
        got, want = (torch.stack(out), torch.stack(out_p)) if last else (packed, packed_p)
        if not torch.equal(got, want):
            raise AssertionError(f"K5 launch {i} ({kind} {a}) differs from its plain step")
    perm = out[1]
    dsts = [torch.empty_like(x) for x in payload]
    bitonic.gather_rows(perm, payload, dsts)
    want = [torch.empty_like(x) for x in payload]
    bitonic.gather_rows_plain(perm, payload, want)
    if not all(torch.equal(g, w) for g, w in zip(dsts, want)):
        raise AssertionError("K5 gather_rows differs from its plain version")
    log(f"  K5 on {n} lanes ({n_pad} padded): the {len(steps)} network launches "
        f"{[s[0] for s in steps]} and the gather each bit-equal to their plain steps")

    reset_counts()
    co_sort(ops, "bitonic")
    torch.cuda.synchronize()
    launches, calls = dict(bitonic.LAUNCHES), dict(bitonic.HOST_CALLS)
    log(f"  one co_sort: launches {launches}, library calls {calls}")
    network = launches["bitonic_tile"] + launches["bitonic_merge"]
    if sum(calls.values()) != 1 or network != len(steps) or launches["gather_rows"] != 1:
        raise AssertionError("a bitonic co_sort must make one library call, the "
                             "schedule's launches and one gather")

    row_bytes = sum(x.element_size() * math.prod(x.shape[1:]) for x in payload)
    k_log2 = n_pad.bit_length() - 1
    tile_stages = bitonic.TILE_LOG2 * (bitonic.TILE_LOG2 + 1) // 2  # k = 2 .. 8192
    tail = steps[-1]
    top = next(s for s in steps if s[0] == "merge" and s[1] == n_pad)
    kernels = {  # name -> (kernel, plain on the card, PyTorch call, bytes, compares)
        "bitonic_tile": (
            lambda: bitonic.bitonic_tile(packed, 2, bitonic.TILE, keys=keys),
            lambda: bitonic.bitonic_tile_plain(packed, 2, bitonic.TILE, keys=keys),
            lambda: torch.sort(keys[: n // bitonic.TILE * bitonic.TILE].view(-1, bitonic.TILE),
                               dim=1),
            8 * n + 8 * n_pad, n_pad // 2 * tile_stages),
        "bitonic_merge": (lambda: bitonic.bitonic_merge(packed, *top[1:]),
                          lambda: bitonic.bitonic_merge_plain(packed, *top[1:]), None,
                          16 * n_pad, n_pad // 2 * top[3]),
        "gather_rows": (lambda: bitonic.gather_rows(perm, payload, dsts),
                        lambda: bitonic.gather_rows_plain(perm, payload, dsts), None,
                        n * (8 + 2 * row_bytes), 0),
    }
    device = profiled_ms(lambda: [k[0]() for k in kernels.values()], 20,
                         ("bitonic_tile_kernel", "bitonic_merge_kernel", "gather_rows_kernel"))
    res = {}
    for (kname, (kern, plain, lib, n_bytes, n_ops)), (dev_ms, _) in zip(kernels.items(),
                                                                       device.values()):
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 1, warmup=False)
        lib_ms = cuda_ms(lib, 20) if lib else None
        b_ms, b_by = bound(n_bytes, n_ops)
        res[kname] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms)
        log(f"  {kname} ({n} lanes): kernel {ms:.4f} ms by events, {dev_ms} ms device "
            f"time (profiler), plain {plain_ms:.2f} ms, bound {b_ms:.5f} ms ({b_by}), "
            f"PyTorch {lib_ms} ms")
    tail_ms = cuda_ms(lambda: bitonic.bitonic_tile(packed, *tail[1:]), 20)
    log(f"  bitonic_tile tail (k = {tail[1]}, j < {bitonic.TILE}): {tail_ms:.4f} ms")

    cols = sum(math.prod(o.shape[1:]) for o in ops)
    sort_ms = cuda_ms(lambda: co_sort(ops, "bitonic"), 20)
    torch_ms = cuda_ms(lambda: co_sort(ops, "stable"), 20)
    per_sort = profiled_ms(lambda: co_sort(ops, "bitonic"), 5,
                           ("bitonic_tile_kernel", "bitonic_merge_kernel", "gather_rows_kernel"))
    dev = [v[0] for v in per_sort.values()]
    sort_dev = sum(dev) if all(d is not None for d in dev) else None
    # keys read and written, the permutation written, each payload row read
    # and written once; one compare per pair per stage of the network
    sort_bound, sort_by = bound(24 * n + 2 * n * row_bytes,
                                n_pad // 2 * k_log2 * (k_log2 + 1) // 2)
    log(f"  co_sort of {n} lanes x {cols} columns: bitonic network + gather "
        f"{sort_ms:.4f} ms by events, device time {sort_dev} ms per sort "
        f"({ {k: v for k, v in per_sort.items()} }), bound {sort_bound:.5f} ms ({sort_by}); "
        f"torch.sort(stable=True) + one gather per operand {torch_ms:.4f} ms")
    res["bitonic_tile"].update(co_sort_ms=sort_ms, co_sort_device_ms=sort_dev,
                               co_sort_bound_ms=sort_bound, torch_sort_ms=torch_ms,
                               tail_ms=tail_ms, launches_per_sort=launches,
                               library_calls_per_sort=sum(calls.values()))
    return res


def phase_kernels(rs):
    """Each kernel against its plain version at the main path's own
    inputs, recorded from one frame of each of phase 4's renderers, and on
    random inputs; then each kernel's time beside its plain version's, its
    bound and the PyTorch call that computes the same function."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.bvh8 import WideBVH8
    from pbrt_tpu_torch.ops.pallas_bvh import OrderedBVH2, SkipLinkBVH
    from pbrt_tpu_torch.ops.stream_bvh import StreamBVH

    log("== phase 3: kernels against their plain versions")
    r3 = rs["default"]
    closest, shadow = r3.integrator.queries_per_sample()
    per_chunk = closest + shadow
    for name, r in rs.items():
        w = r.compiled.intersector.walk
        shapes = {k: tuple(getattr(w, k).shape) for k in ("nodes", "nodes_f", "tris")
                  if hasattr(w, k)}
        log(f"  {name}: {r.compiled.tri_data.count} triangles, {type(w).__name__} {shapes}")
    out = {}  # name -> [max_err, timed calls, their (bytes, ops), their stats]
    torus = {}  # the whole-tree walks' small-torus sweeps, timed for their own lines

    def run(name, label, walk, rays, any_hit, timed):
        err, call, work, stats, plain_ms = check_walk(name, label, walk, *rays, any_hit)
        entry = out.setdefault(name, [0.0, [], [], [], []])
        entry[0] = max(entry[0], err)
        if timed:
            entry[1].append(call)
            entry[2].append(work)
            entry[3].append(stats)
            entry[4].append(plain_ms)
        return call, stats

    # the config-3 walks: every sweep of K2's frame, chunk 0 of the others
    for name, variant in (("stream_walk8", "default"), ("stream_walk2", "binary"),
                          ("stream_walk2_fused", "binary_fused"), ("skip_walk", "skip")):
        walk = rs[variant].compiled.intersector.walk
        calls = record_walks(rs[variant])
        if len(calls) != per_chunk * frame_chunks(rs[variant]):
            raise AssertionError(f"{variant}: recorded {len(calls)} sweeps")
        # K2: every sweep of its frame; the others, whose plain runs take
        # 1-2.5 s a sweep: every third sweep of chunk 0
        keep = (list(enumerate(calls)) if name == "stream_walk8"
                else list(enumerate(calls[:per_chunk]))[::PHASE3_STRIDE])
        for i, (o, d, t_max, any_hit) in keep:
            run(name, f"config-3 sweep {i}", walk, (o, d, t_max), any_hit, i < per_chunk)
        rays = random_rays(SWEEP, 7, -2.0, 2.0)
        for any_hit in (False, True):
            run(name, "random", walk, rays, any_hit, False)

    # the binary streaming walks on one cluster of more than 1024 node rows
    big = StreamBVH(*soup_tables(3), target_tris=4096, leaf_slots=8, wide=False,
                    device=DEVICE)
    rows = big.nodes.shape[1]
    if big.nodes.shape[0] != 1 or rows <= 1024:
        raise AssertionError(f"expected one binary cluster of over 1024 rows, got "
                             f"{tuple(big.nodes.shape)}")
    rays = random_rays(32768, 5, -2.0, 2.0)
    for name in ("stream_walk2", "stream_walk2_fused"):
        for any_hit in (False, True):
            run(name, f"one {rows}-row binary cluster", big, rays, any_hit, False)

    # the whole-tree walks: every sweep of the small torus, and a soup
    soups = {"wide_walk8": WideBVH8(*soup_tables(16), leaf_slots=16, device=DEVICE),
             "ordered_walk2": OrderedBVH2(*soup_tables(8), device=DEVICE)}
    for name, variant in (("wide_walk8", "small"), ("ordered_walk2", "small_binary")):
        calls = record_walks(rs[variant])
        if len(calls) != per_chunk * frame_chunks(rs[variant]):
            raise AssertionError(f"{variant}: recorded {len(calls)} sweeps")
        torus[name] = [run(name, f"small-torus sweep {i}", rs[variant].compiled.intersector.walk,
                           (o, d, t_max), any_hit, False)
                       for i, (o, d, t_max, any_hit) in enumerate(calls)]
        rays = random_rays(SWEEP, 3, -2.0, 2.0)
        for any_hit in (False, True):
            run(name, "3000-triangle soup", soups[name], rays, any_hit, not any_hit)

    # the split walks on a soup of twin triangles: every hit an exact t tie,
    # which the merge key must resolve as the sequential walk does
    twins = {"ordered_walk2": OrderedBVH2(*soup_tables(8, twin=True), device=DEVICE),
             "skip_walk": SkipLinkBVH(*soup_tables(4, twin=True), device=DEVICE)}
    for name, walk in twins.items():
        for live in (None, 1000):  # one segment, several
            rays = random_rays(SWEEP, 9, -2.0, 2.0, live)
            for any_hit in (False, True):
                run(name, f"6000-triangle twin soup, {live or 'all'} live", walk, rays,
                    any_hit, False)

    # the bitonic network: every qualifying co_sort of a frame, random keys
    sorts = record_sorts(rs["bitonic"])
    # per chunk: a shadow and a carry sort per bounce but the last
    if len(sorts) != 2 * (closest - 1) * frame_chunks(rs["bitonic"]):
        raise AssertionError(f"recorded {len(sorts)} bitonic co_sorts")
    for i, ops in enumerate(sorts):
        check_sort(f"config-3 call {i}", ops)
    rng = np.random.default_rng(11)
    keys = (rng.integers(0, 64, SWEEP).astype(np.int64) * 977) | (
        rng.integers(0, 2, SWEEP).astype(np.int64) << 31)
    check_sort("random keys", (torch.as_tensor(keys, device=DEVICE),
                               torch.randn(SWEEP, 3, device=DEVICE),
                               torch.arange(SWEEP, device=DEVICE)))

    log(f"  timing per {SWEEP}-ray sweep (config-3 walks: the 7 chunk-0 sweeps; "
        "whole-tree walks: the soup's closest-hit rays; kernel: mean of 20 "
        "launches after one; plain: the PyTorch version on the card, its check's "
        "one run with the work counters on)")
    res = {}
    for name, (err, calls, works, stats, plain) in out.items():
        ms, plain_ms, dev = time_walks(name, calls, stats, plain)
        b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]))
        res[name] = dict(max_abs_err=err, ms=float(np.mean(ms)), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None, sweep_ms=ms,
                         sweep_live=[st[0] for st in stats])
        if dev is not None:
            res[name]["sweep_device_ms"] = dev
    for name in ("stream_walk8",) + SPLIT_WALKS:
        res[name]["sweep_segments"] = [st[3] for st in out[name][3]]
        if name in SPLIT_WALKS:
            res[name]["sweep_rays_per_task"] = [st[4] for st in out[name][3]]
    for name, calls in torus.items():
        torus_ms = [cuda_ms(lambda: fn(*args, **kw), 20) for (fn, args, kw), _ in calls]
        dev = walk_device_ms(name, [call for call, _ in calls])
        log(f"  {name} on the small torus's {len(calls)} sweeps: kernel "
            f"{[round(t, 4) for t in torus_ms]} ms")
        sweep_lines(name, torus_ms, [st for _, st in calls], dev)
        res[name]["torus_sweep_ms"] = torus_ms
        res[name]["torus_sweep_live"] = [st[0] for _, st in calls]
        if name in SPLIT_WALKS:
            res[name]["torus_sweep_segments"] = [st[3] for _, st in calls]
            res[name]["torus_sweep_rays_per_task"] = [st[4] for _, st in calls]
            res[name]["torus_sweep_device_ms"] = dev

    # K5: the widest recorded sort (the sorted carry)
    res.update(phase_sort(max(sorts, key=lambda x: sum(o[0].numel() for o in x))))
    for name, r in res.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.2%} of it")
    return res


def phase_main_path(rs):
    """Each variant's frame with the counters zeroed before and read after."""
    import numpy as np
    import torch

    log("== phase 4: the main path (config 3, 256x256, 8 spp, maxdepth 4) "
        "under each walk and sort")
    closest, shadow = rs["default"].integrator.queries_per_sample()
    launches, images, first_s, chunks = {}, {}, {}, {}
    for name, r in rs.items():
        torch.cuda.synchronize()
        before = r.counters["chunks"]
        reset_counts()
        t0 = time.time()
        state = r.render()
        torch.cuda.synchronize()
        first_s[name] = time.time() - t0
        chunks[name] = r.counters["chunks"] - before
        launches[name] = {k: v for k, v in read_counts().items() if v}
        images[name] = r.image(state)
        log(f"  {name}: launches {launches[name]}; frame {first_s[name]:.3f} s; "
            f"image mean {images[name].mean():.6f} max {images[name].max():.4f}")
    for kname, variant in PATH_OF.items():
        # per chunk: closest + shadow sweeps; a shadow and a carry sort per
        # bounce but the last
        want = chunks[variant] * (
            per_sort(kname, chunk_lanes(rs[variant])) * 2 * (closest - 1)
            if variant == "bitonic" else closest + shadow)
        if launches[variant].get(kname, 0) != want or want == 0:
            raise AssertionError(f"{kname} launched {launches[variant].get(kname, 0)} "
                                 f"times in the {variant} frame, want {want}")
    if launches["default"].get("stream_walk8") != 14:
        raise AssertionError("stream_walk8 must launch 14 times per config-3 frame")
    for name, r in rs.items():
        img = images[name]
        if not (np.isfinite(img).all() and img.max() > 0):
            raise AssertionError(f"{name}: image not finite or all black")
        base = images["small" if VARIANTS[name][0] == "small" else "default"]
        rel_mean = abs(img.mean() - base.mean()) / base.mean()
        close = np.isclose(img, base, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
        log(f"  {name} vs its default image: mean rel diff {rel_mean:.3e}, "
            f"{close:.4f} of pixels close")
        if not (rel_mean <= 1e-3 and close >= 0.99):
            raise AssertionError(f"{name}: image differs from the default path's")
    log(f"  triangles: config 3 {rs['default'].compiled.tri_data.count} (streaming), "
        f"small {rs['small'].compiled.tri_data.count} (whole tree)")
    return ({k: launches[v].get(k, 0) for k, v in PATH_OF.items()}, first_s,
            images["default"])


def phase_frames(rs):
    """Median of three frame seconds per config-3 variant, taken in turns."""
    import torch

    names = [n for n, v in VARIANTS.items() if v[0] == "config3"]
    times = {n: [] for n in names}
    for _ in range(3):
        for n in names:
            torch.cuda.synchronize()
            t0 = time.time()
            st = rs[n].render()
            torch.cuda.synchronize()
            times[n].append(time.time() - t0)
            rs[n].image(st)
    return {n: (sorted(t)[1], t) for n, t in times.items()}


def phase_parity():
    import numpy as np

    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    log("== phase 5: image parity, config 3 at 32x32, 2 spp, maxdepth 3")
    imgs = {}
    for dev in ("cuda", "cpu"):
        r, _ = mesh_scene_renderer(xres=32, yres=32, spp=2, maxdepth=3, device=dev)
        imgs[dev] = r.image(r.render())
    got, want = imgs["cuda"], imgs["cpu"]
    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    err = np.abs(got - want).max(axis=-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    log(f"  mean rel diff {rel_mean:.3e}; {close:.4f} of pixels close; worst pixel "
        f"{tuple(int(i) for i in worst)}: cpu {want[worst]} cuda {got[worst]}")
    if not (np.isfinite(got).all() and rel_mean <= 1e-3 and close >= 0.99):
        raise AssertionError("cuda and cpu images disagree")


def phase_profile(label, r, frame_s=None):
    """torch.profiler over one frame of ``r``: the busiest kernels, the
    kernels' launches and summed device time, and that time's share of
    the profiled frame's wall time and of ``frame_s`` (an unprofiled
    frame's; the profiler slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log(f"== profile: one {label} frame")
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render()
        torch.cuda.synchronize()
    wall = time.time() - t0
    events = prof.key_averages()
    log(events.table(sort_by="self_cuda_time_total", row_limit=15))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_s = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e6
    busy = "" if frame_s is None else f", {device_s / frame_s:.1%} of a {frame_s:.4f} s frame"
    log(f"  {label}: {len(kernels)} kernel launches, {device_s * 1e3:.2f} ms of kernel time: "
        f"{device_s / wall:.1%} of the {wall:.4f} s profiled frame{busy}")
    return dict(launches=len(kernels), device_s=device_s, profiled_frame_s=wall)


CORNELL = dict(xres=256, yres=256, spp=32, maxdepth=5, ray_batch=1 << 18)
PARITY_WALKS = {"bvh8": "wide_walk8", "binary": "ordered_walk2",
                "binary_fused": "ordered_walk2", "skip": "skip_walk"}


def phase_cornell(card):
    """BASELINE scene 2 at full width: a first frame with the launch
    counters zeroed before and read after (no kernel serves this path),
    then frame seconds, median of three."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.ops.intersect_soa import SoABruteForceIntersector
    from pbrt_tpu_torch.testscenes import cornell_renderer

    log(f"== phase 7: the Cornell box at {CORNELL['xres']}x{CORNELL['yres']}, "
        f"{CORNELL['spp']} spp, maxdepth {CORNELL['maxdepth']}, ray_batch {CORNELL['ray_batch']}")
    r = cornell_renderer(**CORNELL, device=DEVICE)
    if not isinstance(r.compiled.intersector, SoABruteForceIntersector):
        raise AssertionError("Cornell must take the brute-force intersector")
    closest, shadow = r.integrator.queries_per_sample()
    samples = CORNELL["xres"] * CORNELL["yres"] * CORNELL["spp"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    state = r.render()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    img = r.image(state)
    log(f"  first frame {first_s:.3f} s, {r.counters['chunks']} chunks, launches {launches}; "
        f"image mean {img.mean():.6f} max {img.max():.4f}")
    if launches:
        raise AssertionError(f"the Cornell frame launched kernels: {launches}")
    if r.counters["chunks"] != 8:
        raise AssertionError(f"Cornell took {r.counters['chunks']} chunks, want 8")
    if (r.counters["closest_queries"], r.counters["shadow_queries"]) != (
            samples * 5, samples * 4) or (closest, shadow) != (5, 4):
        raise AssertionError(f"Cornell query counters {r.counters}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("Cornell image not finite or all black")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        state = r.render()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    r.image(state)
    median = sorted(times)[1]
    queries = samples * (closest + shadow)
    log(f"  Cornell frame {median:.4f} s ({[round(x, 4) for x in times]}), "
        f"{queries} closest+shadow queries/frame, {queries / median / 1e6:.3f} Mray/s "
        f"on {card}")
    return r, dict(frame_s=median, frames_s=times, first_frame_s=first_s,
                   mray_s=queries / median / 1e6, queries=queries, card=card)


def compare_images(label, got, want, sides=("cpu", "cuda")):
    """Phase 5's tolerance; raises where the images disagree.  ``sides``
    names ``want`` and ``got`` in the log."""
    import numpy as np

    rel_mean = abs(got.mean() - want.mean()) / want.mean()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(axis=-1).mean()
    err = np.abs(got - want).max(axis=-1)
    worst = np.unravel_index(np.argmax(err), err.shape)
    log(f"  {label}: mean rel diff {rel_mean:.3e}; {close:.4f} of pixels close; worst "
        f"pixel {tuple(int(i) for i in worst)}: {sides[0]} {want[worst]} {sides[1]} "
        f"{got[worst]}")
    if not (np.isfinite(got).all() and got.max() > 0 and rel_mean <= 1e-3 and close >= 0.99):
        raise AssertionError(f"{label}: {sides[1]} and {sides[0]} images disagree")
    return dict(mean_rel_diff=float(rel_mean), close=float(close))


def phase_cornell_parity():
    """The slice's pieces on the card against the CPU: Cornell, its
    environment/filter/crop variant, and the torus with a mirror sphere
    under every walk (each walk's kernel must launch)."""
    import torch

    from pbrt_tpu_torch.testscenes import cornell_renderer, mesh_scene_renderer

    log("== phase 8: image parity on the card against the CPU")
    res = {}
    for label, env in (("cornell", False), ("cornell_environment", True)):
        imgs = {}
        for dev in (DEVICE, "cpu"):
            r = cornell_renderer(xres=32, yres=32, spp=2, maxdepth=5, device=dev,
                                 environment=env)
            imgs[dev] = r.image(r.render())
        res[label] = compare_images(f"{label} 32x32, 2 spp, maxdepth 5", imgs[DEVICE],
                                    imgs["cpu"])
    scene = dict(xres=32, yres=32, spp=2, maxdepth=3, nu=24, nv=24, sphere=True)
    for walk, kname in PARITY_WALKS.items():
        r, _ = mesh_scene_renderer(**scene, device=DEVICE, walk=walk)
        torch.cuda.synchronize()
        reset_counts()
        got = r.image(r.render())
        launched = {k: v for k, v in read_counts().items() if v}
        if not launched.get(kname):
            raise AssertionError(f"torus+sphere under walk={walk}: {kname} never "
                                 f"launched ({launched})")
        r, _ = mesh_scene_renderer(**scene, device="cpu", walk=walk)
        res[f"torus_sphere_{walk}"] = compare_images(
            f"torus+sphere 32x32, walk={walk} (launches {launched})", got,
            r.image(r.render()))
    return res


CONFIG5 = dict(xres=256, yres=256, spp=4, maxdepth=4, ray_batch=1 << 18, nu=1000, nv=500)
FLOOR = 2  # the floor's material row in the mesh scene (light quad, torus, floor)
FD_EPS = 1e-2
FD_RTOL = 0.05  # the reference tests' tolerance of AD against finite differences
GRAD_RTOL = 1e-3  # card against CPU, every element of every leaf ...
GRAD_ATOL_SHARE = 1e-6  # ... or within this share of the CPU gradient's largest magnitude


def timed(fn, reps=3):
    """(median seconds, all seconds) of ``reps`` runs of fn, host clock
    around work that ends in a synchronise."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return sorted(times)[len(times) // 2], times


def k2_frame(label, r, sweeps, card, first=None, plain_stride=1):
    """A streaming-walk scene's frame on the card: one frame with the
    launch counters zeroed before and read after (K2 ``stream_walk8``
    launched ``sweeps`` times, nothing else; ``first`` = (seconds,
    launches, image) of such a frame the caller has just rendered takes its
    place); the image finite and not black; every ``plain_stride``-th
    sweep of a recorded frame through K2 against its plain version on the
    card (phase 3's rules); K2's time on every sweep, its mean over the
    checked sweeps beside their bound and the plain version's time on
    them (each check's run); frame seconds (median of three) and Mray/s.
    Returns (the frame's numbers, K2's)."""
    import numpy as np
    import torch

    walk = r.compiled.intersector.walk
    closest, shadow = r.integrator.queries_per_sample()
    chunks = frame_chunks(r)
    if first is None:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.time()
        state = r.render()
        torch.cuda.synchronize()
        first_s = time.time() - t0
        launches = {k: v for k, v in read_counts().items() if v}
        img = r.image(state)
    else:
        first_s, launches, img = first
    log(f"  first frame {first_s:.3f} s, {chunks} chunk(s), launches {launches}; image "
        f"mean {img.mean():.6f} max {img.max():.4f}")
    if launches != {"stream_walk8": (closest + shadow) * chunks} or (
            closest + shadow) * chunks != sweeps:
        raise AssertionError(f"{label} frame launches {launches}, want stream_walk8 x {sweeps}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError(f"{label} image not finite or all black")

    calls = record_walks(r)
    if len(calls) != sweeps:
        raise AssertionError(f"{label}: recorded {len(calls)} sweeps")
    timed_calls, works, stats, plain, err = [], [], [], [], 0.0
    for i, (o, d, t_max, any_hit) in enumerate(calls):
        if i % plain_stride:
            timed_calls.append(kernel_call("stream_walk8", walk, o, d, t_max, any_hit))
            stats.append(None)
            continue
        e, call, work, st, p_ms = check_walk("stream_walk8", f"{label} sweep {i}", walk, o, d,
                                             t_max, any_hit)
        err = max(err, e)
        timed_calls.append(call)
        works.append(work)
        stats.append(st)
        plain.append(p_ms)
    del calls
    ms, plain_ms, _ = time_walks("stream_walk8", timed_calls, stats, plain)
    del timed_calls
    sweep_bounds = [bound(*w) for w in works]
    b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]))
    # the kernel's mean over the checked sweeps, whose work the plain walk
    # counted and timed: the like-for-like ratios
    ms_strided = float(np.mean(ms[::plain_stride]))
    log(f"  stream_walk8 on {label}'s sweeps: mean {np.mean(ms):.4f} ms"
        + (f" ({ms_strided:.4f} over every {plain_stride}th sweep, the checked ones)"
           if plain_stride > 1 else "")
        + f", bound {b_ms:.5f} ms ({b_by}), {b_ms / ms_strided:.2%} of it; per checked "
        f"sweep bound {[round(x[0], 5) for x in sweep_bounds]} ms")

    median, times = timed(lambda: r.image(r.render()))
    queries = r.film.get_sample_bounds().area() * r.sampler.samples_per_pixel * (
        closest + shadow)
    log(f"  {label} frame {median:.4f} s ({[round(x, 4) for x in times]}), {queries} "
        f"closest+shadow queries/frame, {queries / median / 1e6:.3f} Mray/s on {card}")
    checked = [st for st in stats if st is not None]
    k2 = dict(max_abs_err=err, ms=float(np.mean(ms)), plain_ms=plain_ms, bound_ms=b_ms,
              bound_by=b_by, sweep_ms=ms, sweep_bound_ms=[x[0] for x in sweep_bounds],
              sweep_live=[st[0] for st in checked], sweep_segments=[st[3] for st in checked],
              launches_per_frame=launches["stream_walk8"], plain_stride=plain_stride,
              ms_at_plain_sweeps=ms_strided)
    return dict(first_frame_s=first_s, frame_s=median, frames_s=times,
                mray_s=queries / median / 1e6, queries=queries, card=card), k2


def phase_config5(card):
    """BASELINE config 5 at full width (``bench.py:118-133``, nothing cut):
    scene build seconds; one frame with the launch counters zeroed before
    and read after (K2 ``stream_walk8``: 7 launches, one 262,144-lane
    chunk); the image finite and not black; every sweep of a recorded
    frame through K2 against its plain version on the card; K2's time per
    sweep beside its bound; frame seconds (median of three) and Mray/s;
    then the 1M-triangle scene's image on the card against the CPU's at
    16x16, 1 spp, maxdepth 3."""
    import torch

    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    log(f"== phase 9: config 5 ({CONFIG5['nu']}x{CONFIG5['nv']} torus) at "
        f"{CONFIG5['xres']}x{CONFIG5['yres']}, {CONFIG5['spp']} spp, maxdepth "
        f"{CONFIG5['maxdepth']}, ray_batch {CONFIG5['ray_batch']}")
    t0 = time.time()
    r, _ = mesh_scene_renderer(**CONFIG5, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    walk = r.compiled.intersector.walk
    n_tri = r.compiled.tri_data.count
    log(f"  scene build {build_s:.2f} s: {n_tri} triangles, {type(walk).__name__} nodes "
        f"{tuple(walk.nodes.shape)}, tris {tuple(walk.tris.shape)}, depth {walk.depth}")
    if n_tri != 2 * CONFIG5["nu"] * CONFIG5["nv"] + 4:
        raise AssertionError(f"config 5 has {n_tri} triangles")
    frame, k2 = k2_frame("config 5", r, 7, card)

    imgs = {}
    small = dict(CONFIG5, xres=16, yres=16, spp=1, maxdepth=3)
    for dev in (DEVICE, "cpu"):
        rr, _ = mesh_scene_renderer(**small, device=dev)
        imgs[dev] = rr.image(rr.render())
        del rr
    parity = compare_images("config 5 at 16x16, 1 spp, maxdepth 3", imgs[DEVICE], imgs["cpu"])
    return r, dict(build_s=build_s, triangles=n_tri, parity=parity, **frame), k2


def compare_grads(label, got, want, texel_outliers=0.0):
    """Every leaf of a card gradient against the CPU's: within GRAD_RTOL,
    or GRAD_ATOL_SHARE of the CPU gradient's largest magnitude; returns the
    largest |card - cpu| over that magnitude.  ``texel_outliers``: the
    share of a texture leaf's non-zero texels that may lie outside that
    tolerance, provided the leaf's sum over its texels agrees to
    GRAD_RTOL (a texel's gradient is a bilinear weight's, whose derivative
    in uv is the texture's width: last-bit differences between the
    devices' arithmetic move one lookup's split among its four texels)."""
    import numpy as np

    def flat(tree, pre=""):
        for k, v in tree.items():
            if k == "tex_images":  # ids count textures per process: match by order
                v = {i: v[key] for i, key in enumerate(sorted(v))}
            if isinstance(v, dict):
                yield from flat(v, f"{pre}{k}.")
            else:
                yield f"{pre}{k}", v.detach().cpu().numpy()

    g, w = dict(flat(got)), dict(flat(want))
    if g.keys() != w.keys():
        raise AssertionError(f"{label}: gradient leaves {sorted(g)} against {sorted(w)}")
    scale = max(float(np.abs(v).max(initial=0.0)) for v in w.values())
    worst = 0.0
    for k in w:
        if not np.isfinite(g[k]).all():
            raise AssertionError(f"{label}: gradient {k} not finite")
        close = np.isclose(g[k], w[k], rtol=GRAD_RTOL, atol=GRAD_ATOL_SHARE * scale)
        rows_of = tuple(range(1, close.ndim))
        bad = ~close.all(axis=rows_of)
        if bad.any():
            texels = k.startswith("tex_images")
            nonzero = int((np.abs(w[k]).max(axis=rows_of, initial=0.0) > 0).sum())
            sums_equal = np.allclose(g[k].sum(axis=0), w[k].sum(axis=0), rtol=GRAD_RTOL)
            rows = np.flatnonzero(bad)[:8]
            log(f"  {label}: {k}: {int(bad.sum())} of {nonzero} non-zero rows outside the "
                f"tolerance, e.g. rows {rows.tolist()}: card {g[k][rows].tolist()} cpu "
                f"{w[k][rows].tolist()}; leaf sums equal {sums_equal}")
            if not (texels and bad.sum() <= texel_outliers * nonzero and sums_equal):
                raise AssertionError(f"{label}: gradient {k} on the card differs from the "
                                     "CPU's")
        worst = max(worst, float(np.abs(g[k] - w[k])[close].max(initial=0.0)) / max(scale, 1e-30))
    return worst


def fd_check(label, loss, theta, key, index, ad, args):
    """Central finite difference (eps FD_EPS) of loss at theta[key][index]
    against the autograd value ``ad``, to FD_RTOL, the difference non-zero."""
    import torch

    def at(delta):
        t2 = dict(theta)
        t2[key] = theta[key].clone()
        t2[key][index] += delta
        with torch.no_grad():
            return float(loss(t2, *args))

    fd = (at(FD_EPS) - at(-FD_EPS)) / (2 * FD_EPS)
    rel = abs(ad - fd) / max(abs(fd), 1e-30)
    log(f"  {label}: d loss / d {key}{list(index)}: autograd {ad:.6e}, central difference "
        f"{fd:.6e}, rel diff {rel:.3e}")
    if fd == 0.0 or rel > FD_RTOL:
        raise AssertionError(f"{label}: autograd {ad} against finite difference {fd}")
    return dict(autograd=ad, fd=fd, rel_diff=rel)


def grad_leaves(tree, pre=""):
    """(path, tensor) of every leaf of a nested gradient dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from grad_leaves(v, f"{pre}{k}.")
        else:
            yield f"{pre}{k}", v


def grad_step(label, r, target, spp, card):
    """One loss-and-gradient step over every pixel of ``r`` at ``spp``
    against ``target``: K2's launches in the forward and in the replay
    (at least one, at most the forward's; the forward's one per sweep),
    every leaf finite, forward and forward+backward seconds (median of
    three), peak memory with and without remat and their gradients equal.
    Returns (loss, theta, pixels, the remat gradient's leaves by path,
    the numbers)."""
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad

    theta = r.compiled.initial_theta()
    px = torch.as_tensor(r.film.cropped_pixel_bounds.offsets(), device=DEVICE)
    loss = make_loss_fn(r, target, spp=spp)
    fwd, bwd = {}, {}

    def counted(t, pixels):
        reset_counts()
        value = loss(t, pixels)
        torch.cuda.synchronize()
        fwd.update(read_counts())
        reset_counts()
        return value

    value, grads = value_and_grad(counted, theta, px)
    torch.cuda.synchronize()
    bwd.update(read_counts())
    closest, shadow = r.integrator.queries_per_sample()
    k2_fwd, k2_bwd = fwd["stream_walk8"], bwd["stream_walk8"]
    log(f"  loss {float(value):.6e}; stream_walk8 launches: forward {k2_fwd}, backward "
        f"(the replay) {k2_bwd}; other launches forward "
        f"{ {k: v for k, v in fwd.items() if v and k != 'stream_walk8'} }, backward "
        f"{ {k: v for k, v in bwd.items() if v and k != 'stream_walk8'} }")
    if not 0 < k2_bwd <= k2_fwd or k2_fwd != (closest + shadow) * spp:
        raise AssertionError(f"stream_walk8 launched {k2_fwd} times forward, {k2_bwd} in "
                             "the replay")
    for k, v in grad_leaves(grads):
        if not torch.isfinite(v).all():
            raise AssertionError(f"{label} gradient {k} not finite")

    with torch.no_grad():
        fwd_s, fwd_all = timed(lambda: loss(theta, px))
    step_s, step_all = timed(lambda: value_and_grad(loss, theta, px))
    log(f"  forward {fwd_s:.4f} s ({[round(x, 4) for x in fwd_all]}), forward+backward "
        f"{step_s:.4f} s ({[round(x, 4) for x in step_all]}), median of three, on {card}")

    memory = {}
    for remat in (True, False):
        del grads
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, grads = value_and_grad(make_loss_fn(r, target, spp, remat=remat), theta, px)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        memory[f"remat_{str(remat).lower()}"] = dict(peak_bytes=peak, above_base_bytes=peak - base)
        log(f"  remat={remat}: torch.cuda.max_memory_allocated {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before)")
        if remat:
            kept = dict(grad_leaves(grads))
    worst = max(float((v - kept[k]).abs().max()) if v.numel() else 0.0
                for k, v in grad_leaves(grads))
    log(f"  remat=False against remat=True: max |diff| {worst:.3e}")
    if worst > 1e-6 * max(float(v.abs().max()) for v in kept.values() if v.numel()):
        raise AssertionError("remat=False and remat=True gradients differ")
    return loss, theta, px, kept, dict(
        loss=float(value), forward_s=fwd_s, forward_all_s=fwd_all, forward_backward_s=step_s,
        forward_backward_all_s=step_all, memory=memory, k2_launches_forward=k2_fwd,
        k2_launches_backward=k2_bwd, card=card)


def phase_grad_step(r, card):
    """Phase 10 (a): one config-5 loss-and-gradient step at full width,
    ``make_loss_fn`` over all 65,536 pixels at 4 spp against a target
    rendered with the floor's kd changed."""
    import torch

    from pbrt_tpu_torch.diff.grad import render_image_diff

    log("== phase 10 (a): a config-5 gradient step: make_loss_fn over all "
        f"{PIXELS} pixels, {CONFIG5['spp']} spp, floor kd changed in the target")
    theta = r.compiled.initial_theta()
    if theta["kd"][FLOOR].tolist() != [0.4000000059604645, 0.4000000059604645,
                                       0.41999998688697815]:
        raise AssertionError(f"material row {FLOOR} is not the floor")
    t_theta = dict(theta, kd=theta["kd"].clone())
    t_theta["kd"][FLOOR] += torch.tensor([0.1, -0.08, 0.05], device=DEVICE)
    with torch.no_grad():
        target = render_image_diff(r, t_theta, spp=CONFIG5["spp"], batch=PIXELS).cpu().numpy()
    loss, theta, px, kept, res = grad_step("config-5", r, target, CONFIG5["spp"], card)
    log(f"  floor kd gradient {kept['kd'][FLOOR].tolist()}; area light "
        f"{kept['area_l'].tolist()}")
    fd = fd_check("config 5", loss, theta, "kd", (FLOOR, 0), float(kept["kd"][FLOOR, 0]),
                  (px,))
    return dict(res, floor_kd_grad=kept["kd"][FLOOR].tolist(), fd=fd)


def grad_scenes(tex_path):
    """Phase 10 (b)'s renderer makers, (device) -> (Renderer, the kernel
    its path launches or None)."""
    from pbrt_tpu_torch.testscenes import (GRAD_MATTE, GRAD_NESTED_MIX, GRAD_SPHERE,
                                           GRAD_TEXTURE, cornell_renderer,
                                           mesh_scene_renderer, text_renderer)

    return {
        "config3_16x16": (lambda dev: mesh_scene_renderer(
            xres=16, yres=16, spp=2, maxdepth=3, device=dev)[0], "stream_walk8"),
        "torus_24x24": (lambda dev: mesh_scene_renderer(
            xres=12, yres=12, spp=2, maxdepth=3, nu=24, nv=24, device=dev)[0], "wide_walk8"),
        "sphere": (lambda dev: text_renderer(GRAD_SPHERE.format(material=GRAD_MATTE), 64,
                                             device=dev), None),
        "nested_mix": (lambda dev: text_renderer(
            GRAD_SPHERE.format(material=GRAD_NESTED_MIX), 64, device=dev), None),
        "texture": (lambda dev: text_renderer(GRAD_TEXTURE.format(path=tex_path), 576,
                                              device=dev), None),
        "cornell_16x16": (lambda dev: cornell_renderer(xres=16, yres=16, spp=2, maxdepth=5,
                                                       device=dev), None),
    }


def phase_grad_parity():
    """Phase 10 (b): every leaf of each small scene's gradient on the card
    against the CPU's (a zero target, 2 spp); the walk kernel of each BVH
    scene launched; Cornell's area-light gradient against finite
    differences on the card.  (c): a bitonic sort refuses a theta that
    requires grad on the card."""
    import os

    import numpy as np
    import torch

    from pbrt_tpu_torch.core.geometry import Bounds2i
    from pbrt_tpu_torch.core.imageio import write_image
    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    log("== phase 10 (b): gradients on the card against the CPU, every leaf")
    os.makedirs("build/chip_smoke", exist_ok=True)
    tex_path = os.path.abspath("build/chip_smoke/tex.pfm")
    write_image(tex_path, np.random.default_rng(3).uniform(0.1, 0.9, (8, 8, 3)),
                Bounds2i((0, 0), (8, 8)))
    res = {}
    for label, (make, kname) in grad_scenes(tex_path).items():
        grads = {}
        for dev in (DEVICE, "cpu"):
            r = make(dev)
            b = r.film.cropped_pixel_bounds
            px = torch.as_tensor(b.offsets(), device=dev)
            loss = make_loss_fn(r, np.zeros((b.height, b.width, 3), np.float32), spp=2)
            theta = r.compiled.initial_theta()
            if dev == DEVICE:
                torch.cuda.synchronize()
                reset_counts()
            _, grads[dev] = value_and_grad(loss, theta, px)
            if dev == DEVICE:
                torch.cuda.synchronize()
                launched = {k: v for k, v in read_counts().items() if v}
                if (kname is None) != (not launched) or (kname and not launched.get(kname)):
                    raise AssertionError(f"{label}: launches {launched}, want {kname}")
                card_loss, card_theta, card_px = loss, theta, px
        worst = compare_grads(label, grads[DEVICE], grads["cpu"])
        res[label] = dict(max_rel_to_scale=worst, launches=launched)
        log(f"  {label}: every leaf equal, max |card - cpu| {worst:.3e} of the largest "
            f"magnitude; launches {launched}")
        if label == "cornell_16x16":
            from pbrt_tpu_torch.materials.bsdf import MIRROR

            (mirror,) = [i for i, e in enumerate(r.compiled.materials) if e.type_id == MIRROR]
            kr = grads[DEVICE]["kr"][mirror]
            log(f"  Cornell area_l {grads[DEVICE]['area_l'].tolist()}, mirror kr {kr.tolist()}")
            if not bool((kr != 0).any()):
                raise AssertionError("Cornell: the mirror's kr gets no gradient")
            res[label]["fd"] = fd_check("Cornell on the card", card_loss, card_theta,
                                        "area_l", (0, 0),
                                        float(grads[DEVICE]["area_l"][0, 0]), (card_px,))

    log("== phase 10 (c): sort='bitonic' under gradients on the card")
    r, _ = mesh_scene_renderer(xres=256, yres=128, spp=1, maxdepth=2, nu=24, nv=24,
                               device=DEVICE, sort="bitonic")
    px = torch.as_tensor(r.film.cropped_pixel_bounds.offsets(), device=DEVICE)
    loss = make_loss_fn(r, np.zeros((128, 256, 3), np.float32), spp=1)
    try:
        value_and_grad(loss, r.compiled.initial_theta(), px)
    except RuntimeError as e:
        if "not differentiable" not in str(e):
            raise
        log(f"  {px.shape[0]} lanes: refused ({e})")
    else:
        raise AssertionError("the bitonic co_sort took gradients on the card")
    res["bitonic_refused"] = True
    return res


CONFIG4 = dict(xres=256, yres=256, spp=8, maxdepth=5, ray_batch=1 << 18)
CONFIG4_GRAD_SPP = 4
ENV_SIZE = 1024  # square: MIPMap (both packages) refuses other shapes
# config 4's texel gradients on the card may differ from the CPU's on this
# share of the non-zero texels (``compare_grads``)
TEXEL_OUTLIERS = 0.01
TEX_SIZE = 256


def config4_maps():
    """The config-4 maps under build/chip_smoke/, written at first use ->
    (env path, texture path)."""
    import os

    from pbrt_tpu_torch.testscenes import write_env_map, write_texture_map

    os.makedirs("build/chip_smoke", exist_ok=True)
    env = os.path.abspath(f"build/chip_smoke/env{ENV_SIZE}.pfm")
    tex = os.path.abspath(f"build/chip_smoke/albedo{TEX_SIZE}.pfm")
    if not os.path.exists(env):
        write_env_map(env, ENV_SIZE, ENV_SIZE, seed=0)
    if not os.path.exists(tex):
        write_texture_map(tex, TEX_SIZE, seed=1)
    return env, tex


def phase_config4(card):
    """BASELINE config 4 at full width: scene build seconds; one frame
    with the launch counters zeroed before and read after (K2
    ``stream_walk8``, 2 chunks x 9 sweeps); the image finite and not
    black; every sweep of a recorded frame through K2 against its plain
    version on the card; K2's time per sweep beside its bound; frame
    seconds (median of three) and Mray/s; the image on the card against
    the CPU's at 32x32, 2 spp, maxdepth 5."""
    import torch

    from pbrt_tpu_torch.lights import InfiniteAreaLight
    from pbrt_tpu_torch.testscenes import config4_renderer

    log(f"== phase 11: config 4 at {CONFIG4['xres']}x{CONFIG4['yres']}, {CONFIG4['spp']} spp, "
        f"maxdepth {CONFIG4['maxdepth']}, ray_batch {CONFIG4['ray_batch']}; "
        f"{ENV_SIZE}x{ENV_SIZE} environment map, {TEX_SIZE}x{TEX_SIZE} Kd texture")
    env, tex = config4_maps()
    t0 = time.time()
    r, _ = config4_renderer(env, tex, **CONFIG4, device=DEVICE)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    walk = r.compiled.intersector.walk
    (light,) = r.compiled.lights
    if not (isinstance(light, InfiniteAreaLight) and light.distribution is not None):
        raise AssertionError("config 4 must be lit by an image-mapped infinite light")
    n_tri = r.compiled.tri_data.count
    log(f"  scene build {build_s:.2f} s: {n_tri} triangles and "
        f"{r.compiled.sph_data.count} spheres, {type(walk).__name__} nodes "
        f"{tuple(walk.nodes.shape)}, materials "
        f"{[e.type_id for e in r.compiled.materials]}")
    frame, k2 = k2_frame("config 4", r, 18, card)

    imgs = {}
    small = dict(CONFIG4, xres=32, yres=32, spp=2)
    for dev in (DEVICE, "cpu"):
        rr, _ = config4_renderer(env, tex, **small, device=dev)
        imgs[dev] = rr.image(rr.render())
        del rr
    parity = compare_images("config 4 at 32x32, 2 spp, maxdepth 5", imgs[DEVICE], imgs["cpu"])
    return r, dict(build_s=build_s, triangles=n_tri, parity=parity, **frame), k2


def phase_config4_grad(r, card):
    """Phase 11's gradient step: ``make_loss_fn`` over all 65,536 pixels
    at 4 spp against a target rendered with the torus's roughness 0.3;
    the torus's roughness leaf non-zero and its Ks against a central
    finite difference; then every leaf on the card against the CPU's at
    16x16."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, render_image_diff, value_and_grad
    from pbrt_tpu_torch.materials.bsdf import PLASTIC
    from pbrt_tpu_torch.testscenes import config4_renderer

    spp = CONFIG4_GRAD_SPP
    log(f"== phase 11 (gradients): a config-4 step: make_loss_fn over all {PIXELS} pixels, "
        f"{spp} spp, the torus's roughness 0.3 in the target")
    (torus,) = [i for i, e in enumerate(r.compiled.materials) if e.type_id == PLASTIC]
    theta = r.compiled.initial_theta()
    if abs(float(theta["roughness"][torus]) - 0.2) > 1e-6:
        raise AssertionError(f"material row {torus} is not the torus")
    t_theta = dict(theta, roughness=theta["roughness"].clone())
    t_theta["roughness"][torus] = 0.3
    with torch.no_grad():
        target = render_image_diff(r, t_theta, spp=spp, batch=PIXELS).cpu().numpy()
    loss, theta, px, kept, res = grad_step("config-4", r, target, spp, card)
    rough = kept["roughness"][torus]
    log(f"  torus roughness gradient {float(rough):.6e}; roughness {kept['roughness'].tolist()}; "
        f"ks {kept['ks'].tolist()}; kr {kept['kr'].tolist()}; kt {kept['kt'].tolist()}; "
        f"texels |g| sum "
        f"{sum(float(v.abs().sum()) for k, v in kept.items() if k.startswith('tex_')):.6e}")
    if float(rough) == 0.0:
        raise AssertionError("the torus's roughness gets no gradient")
    fd = fd_check("config 4, the torus's Ks", loss, theta, "ks", (torus, 1),
                  float(kept["ks"][torus, 1]), (px,))

    log("  config 4 at 16x16, 2 spp, maxdepth 5: every gradient leaf on the card against "
        "the CPU's")
    env, tex = config4_maps()
    card_cpu = {}
    for dev in (DEVICE, "cpu"):
        rr, _ = config4_renderer(env, tex, xres=16, yres=16, spp=2, maxdepth=5, device=dev)
        b = rr.film.cropped_pixel_bounds
        loss16 = make_loss_fn(rr, np.full((b.height, b.width, 3), 0.2, np.float32), spp=2)
        _, card_cpu[dev] = value_and_grad(loss16, rr.compiled.initial_theta(),
                                          torch.as_tensor(b.offsets(), device=dev))
        del rr
    parity = compare_grads("config 4 at 16x16", card_cpu[DEVICE], card_cpu["cpu"],
                           texel_outliers=TEXEL_OUTLIERS)
    log(f"  every leaf equal, max |card - cpu| {parity:.3e} of the largest magnitude")
    return dict(res, torus_roughness_grad=float(rough), fd=fd, parity_max_rel_to_scale=parity)


INTEGRATOR_RUNS = {  # label -> (scene, integrator line, resolution, spp, (closest, shadow))
    "check_sphere_directlighting": ("CHECK_SPHERE", '"directlighting" "integer maxdepth" 5',
                                    64, 8, (6, 5)),
    "check_sphere_whitted": ("CHECK_SPHERE", '"whitted" "integer maxdepth" 5', 64, 8, (5, 4)),
    "check_sphere_ao": ("CHECK_SPHERE", '"ao" "integer nsamples" 2', 64, 8, (1, 2)),
    "box_directlighting": ("DIRECT_BOX", '"directlighting" "integer maxdepth" 5', 20, 16,
                           (6, 5)),
    "box_ao": ("DIRECT_BOX", '"ao"', 20, 16, (1, 1)),
}


def phase_integrators():
    """Phase 12: config 1's integrators on the card against the CPU."""
    import torch

    from pbrt_tpu_torch import testscenes

    log("== phase 12: directlighting, whitted and ao on the card against the CPU")
    res = {}
    for label, (scene, integ, size, spp, queries) in INTEGRATOR_RUNS.items():
        text = getattr(testscenes, scene).format(integrator=integ, xres=size, yres=size, spp=spp)
        imgs = {}
        for dev in (DEVICE, "cpu"):
            r = testscenes.text_renderer(text, size * size * spp, device=dev)
            if dev == DEVICE:
                torch.cuda.synchronize()
                reset_counts()
            imgs[dev] = r.image(r.render())
            lanes = size * size * spp
            counted = (r.counters["closest_queries"], r.counters["shadow_queries"])
            if r.integrator.queries_per_sample() != queries or counted != (
                    lanes * queries[0], lanes * queries[1]):
                raise AssertionError(f"{label}: query counters {r.counters}, want {queries} "
                                     "per sample")
            if dev == DEVICE:
                launched = {k: v for k, v in read_counts().items() if v}
                if launched:
                    raise AssertionError(f"{label}: kernels launched {launched}")
        res[label] = compare_images(f"{label} {size}x{size}, {spp} spp", imgs[DEVICE],
                                    imgs["cpu"])
        res[label].update(mean=float(imgs[DEVICE].mean()), queries_per_sample=queries)
    return res


CONFIG3_FILE = dict(xres=256, yres=256, spp=8, maxdepth=4)  # phase 4's config 3
# maxdepth 3, cut from 5 to make room for phase 16
SCENEFILE = dict(xres=256, yres=256, spp=16, maxdepth=3, ray_batch=1 << 18)
SCENEFILE_SWEEPS = 4 * (3 + 2)  # 4 chunks x (3 closest + 2 shadow)
SCENEFILE_DIR = "build/chip_smoke"
SAMPLERS = ("random", "stratified", "halton", "sobol", "02sequence", "maxmindist")
# maxdepth 2, cut from 3 to make room for phase 16
SAMPLER_PARITY = dict(xres=32, yres=32, spp=2, maxdepth=2)
CHECKPOINT = dict(xres=64, yres=64, ray_batch=1 << 14)  # 4 chunks of (b)'s 16 spp


def cli_render(argv, device=None, renders=1):
    """``cli.main(argv)`` on ``device`` (``DEVICE`` unless given) with the
    launch counters zeroed before; returns (what the outermost
    ``render_scene`` returned, the scene builds' summed seconds, the
    launches).  ``renders``: the ``render_scene`` calls expected (a
    sampled-spectrum render makes one per pass besides the outermost)."""
    import torch

    from pbrt_tpu_torch import cli, render

    device = device or DEVICE

    kept, build_s = [], []
    render_scene, build_scene = render.render_scene, render.build_scene

    def keep(*a, **kw):
        kept.append(render_scene(*a, **kw))
        return kept[-1]

    def timed_build(*a, **kw):
        t0 = time.time()
        out = build_scene(*a, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        build_s.append(time.time() - t0)
        return out

    render.render_scene, render.build_scene = keep, timed_build
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        reset_counts()
        rc = cli.main(argv, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if v}
    finally:
        render.render_scene, render.build_scene = render_scene, build_scene
    if rc != 0 or len(kept) != renders:
        raise AssertionError(f"cli.main({argv}) returned {rc} after {len(kept)} render(s)")
    return kept[-1], sum(build_s), launches


def phase_scenefile(card, config3_image, profile=False):
    """Phase 13: scene files through the front door.  (a) config 3 as a
    scene file with a binary PLY torus, through ``python3 -m
    pbrt_tpu_torch`` (a subprocess) and through ``cli.main``, against
    phase 4's image; (b) the scene vocabulary at full width (K2's sweeps
    against its plain walk, frame seconds, card against CPU under all six
    samplers); (c) checkpoint and resume on the card."""
    import os

    import numpy as np

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.core.imageio import read_image
    from pbrt_tpu_torch.core.paramset import ParamSet
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.samplers import make_sampler
    from pbrt_tpu_torch.testscenes import config3_scenefile, scenefile_text, write_torus_ply

    res = {}
    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    ply = f"{d}/torus.ply"
    n_torus = write_torus_ply(ply)
    batch = str(SCENEFILE["ray_batch"])

    log("== phase 13 (a): config 3 as a scene file (a binary PLY torus) through the "
        f"front door, {CONFIG3_FILE}")
    config3_scenefile(f"{d}/config3.pbrt", ply, **CONFIG3_FILE)
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "pbrt_tpu_torch", f"{d}/config3.pbrt",
                          "--ray-batch", batch, "-o", f"{d}/config3.pfm", "-q"],
                         capture_output=True, text=True, timeout=900)
    sub_s = time.time() - t0
    if out.returncode != 0 or not os.path.exists(f"{d}/config3.pfm"):
        raise AssertionError(f"python3 -m pbrt_tpu_torch exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    log(f"  python3 -m pbrt_tpu_torch config3.pbrt: exit 0 in {sub_s:.2f} s (process start, "
        f"import, build and render)")
    res["config3"] = dict(subprocess_s=sub_s, parity_subprocess=compare_images(
        "subprocess PFM against phase 4's config-3 image", read_image(f"{d}/config3.pfm")[0],
        config3_image, ("phase 4", "scene file")))
    got, build_s, launches = cli_render([f"{d}/config3.pbrt", "--ray-batch", batch, "-o",
                                         f"{d}/config3_main.pfm", "-q"])
    log(f"  cli.main: build {build_s:.2f} s, {got['renderer'].compiled.tri_data.count} "
        f"triangles ({n_torus} in the PLY), launches {launches}")
    if launches != {"stream_walk8": 14}:
        raise AssertionError(f"config 3 through cli.main launched {launches}, want "
                             "stream_walk8 x 14")
    res["config3"].update(build_s=build_s, launches=launches, parity_main=compare_images(
        "cli.main PFM against phase 4's config-3 image", read_image(f"{d}/config3_main.pfm")[0],
        config3_image, ("phase 4", "scene file")))
    del got

    full = dict(SCENEFILE)
    full.pop("ray_batch")
    log(f"== phase 13 (b): the scene vocabulary at {full['xres']}x{full['yres']}, "
        f"{full['spp']} spp, maxdepth {full['maxdepth']}, Sampler \"sobol\", ray_batch {batch}")
    with open(f"{d}/scenefile.pbrt", "w") as f:
        f.write(scenefile_text(ply, **full, filename=f"{d}/scenefile.pfm"))
    t0 = time.time()
    got, build_s, launches = cli_render([f"{d}/scenefile.pbrt", "--ray-batch", batch, "-q"])
    first_s = time.time() - t0
    r = got["renderer"]
    walk = r.compiled.intersector.walk
    n_tri = r.compiled.tri_data.count
    img = read_image(f"{d}/scenefile.pfm")[0]
    log(f"  cli.main: {first_s:.2f} s, scene build {build_s:.2f} s: {n_tri} triangles, "
        f"{type(walk).__name__} nodes {tuple(walk.nodes.shape)}, tris "
        f"{tuple(walk.tris.shape)}, depth {walk.depth}; launches {launches}; image mean "
        f"{img.mean():.6f} max {img.max():.4f}")
    if launches != {"stream_walk8": SCENEFILE_SWEEPS}:
        raise AssertionError(f"the scene file launched {launches}, want stream_walk8 x "
                             f"{SCENEFILE_SWEEPS}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the scene file's image is not finite or all black")
    # every 4th sweep checked against the plain walk and timed with it
    frame, k2 = k2_frame("the scene file", r, SCENEFILE_SWEEPS, card, plain_stride=4)
    if profile:
        frame["profile"] = phase_profile("scene-file", r, frame["frame_s"])
    del got, r, walk
    # one build per device; each sampler takes the renderer's place in turn
    with open(f"{d}/parity.pbrt", "w") as f:
        f.write(scenefile_text(ply, **SAMPLER_PARITY))
    rs = {}
    for dev in (DEVICE, "cpu"):
        api = PbrtAPI(Options(ray_batch=SCENEFILE["ray_batch"]), render_on_world_end=False,
                      device=dev)
        api.init()
        api.parse_file(f"{d}/parity.pbrt")
        rs[dev] = Renderer(api.scene, api.opt, device=dev)
    pixelsamples = ParamSet()
    pixelsamples.add_int("pixelsamples", [2])
    parity = {}
    for name in SAMPLERS:
        imgs = {}
        for dev, rr in rs.items():
            rr.sampler = make_sampler(name, pixelsamples)
            imgs[dev] = rr.image(rr.render(progress=False))
        parity[name] = compare_images(f"{name} at {SAMPLER_PARITY}", imgs[DEVICE],
                                      imgs["cpu"])
    del rs
    res["scenefile"] = dict(triangles=n_tri, build_s=build_s, cli_first_frame_s=first_s,
                            launches=launches, parity=parity, **frame)

    log(f"== phase 13 (c): checkpoint and resume on the card: the scene file at "
        f"{CHECKPOINT['xres']}x{CHECKPOINT['yres']}, ray_batch {CHECKPOINT['ray_batch']}, "
        "checkpoint_every=1, stopped after 2 chunks")
    with open(f"{d}/ckpt.pbrt", "w") as f:
        f.write(scenefile_text(ply, **dict(full, xres=CHECKPOINT["xres"],
                                           yres=CHECKPOINT["yres"])))

    def renderer(ckpt_dir):
        api = PbrtAPI(Options(ray_batch=CHECKPOINT["ray_batch"], checkpoint_dir=ckpt_dir,
                              checkpoint_every=1), render_on_world_end=False, device=DEVICE)
        api.init()
        api.parse_file(f"{d}/ckpt.pbrt")
        return Renderer(api.scene, api.opt, device=DEVICE)

    import shutil

    for sub in ("ckpt_ref", "ckpt_ref2", "ckpt_kill"):
        shutil.rmtree(f"{d}/{sub}", ignore_errors=True)
    r_ref = renderer(f"{d}/ckpt_ref")
    want = r_ref.image(r_ref.render(progress=False))
    r_ref2 = renderer(f"{d}/ckpt_ref2")
    again = r_ref2.image(r_ref2.render(progress=False))
    r1 = renderer(f"{d}/ckpt_kill")
    calls = {"n": 0}
    radiance = r1._radiance

    def dying(*a, **kw):
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated preemption")
        calls["n"] += 1
        return radiance(*a, **kw)

    r1._radiance = dying
    try:
        r1.render(progress=False)
        raise AssertionError("the interrupted render did not stop")
    except KeyboardInterrupt:
        pass
    r2 = renderer(f"{d}/ckpt_kill")
    got = r2.image(r2.render(progress=False))
    chunks = r_ref.counters["chunks"]
    if chunks != 4 or r2.counters["chunks"] != chunks - 2:
        raise AssertionError(f"chunks: uninterrupted {chunks}, resumed {r2.counters['chunks']}")
    bit_equal = bool(np.array_equal(got, want))
    repeat_equal = bool(np.array_equal(again, want))
    log(f"  resumed after 2 of {chunks} chunks: bit-equal to the uninterrupted render: "
        f"{bit_equal}; two uninterrupted renders bit-equal: {repeat_equal}")
    ckpt = dict(chunks=chunks, resumed_chunks=r2.counters["chunks"], bit_equal=bit_equal,
                repeat_bit_equal=repeat_equal,
                parity=compare_images("resumed against uninterrupted", got, want,
                                      ("uninterrupted", "resumed")))
    r3 = renderer(f"{d}/ckpt_kill")
    r3.render(spp=8, progress=False)  # another spp: the meta differs
    if r3.counters["chunks"] != 2:
        raise AssertionError(f"a mismatched checkpoint was resumed ({r3.counters})")
    log("  a checkpoint whose meta differs (8 spp against 16) was ignored: 2 of 2 chunks "
        "rendered")
    res["checkpoint"] = ckpt
    return res, k2


# 4 spp, cut from 8 (2 chunks) to make room for phase 16; maxdepth 5 keeps
# volpath's Russian roulette (bounces past 3) on the card
VOLUME = dict(xres=256, yres=256, spp=4, maxdepth=5, grid=64, ray_batch=1 << 18)
VOLUME_SWEEPS = 5 * 3 + 4 * 4  # one chunk: 5 x 3 march + 4 x 4 shadow-segment sweeps
VOLUME_PARITY = dict(xres=32, yres=32, spp=2, maxdepth=3, grid=16)
TRACK_LANES = 262144
TRACK_MASK_SHARE = 1e-4  # scattered masks may differ on this share of lanes
TRACK_RTOL = 1e-5


def compare_tracking(label, medium, n, seed=0):
    """Delta (``sample``) and ratio (``tr``) tracking of ``medium`` (a
    GridDensityMedium on the card) on n seeded lanes through the smoke box,
    against its twin built on the CPU: the share of lanes whose scattered
    masks differ (at most TRACK_MASK_SHARE), distances where both scattered
    within TRACK_RTOL, transmittance within TRACK_RTOL / TRACK_RTOL."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.media import GridDensityMedium, make_track_rng
    from pbrt_tpu_torch.testscenes import volume_rays

    host = volume_rays(n, seed)
    cpu_twin = GridDensityMedium(medium.sigma_a, medium.sigma_s, medium.g,
                                 medium.density.cpu().numpy(), medium.w2m.cpu().numpy(),
                                 device="cpu")
    out = {}
    for dev, m in ((DEVICE, medium), ("cpu", cpu_twin)):
        o, d, t_max, pix, si = (torch.as_tensor(x, device=dev) for x in host)
        u = make_track_rng(pix, si, 5)(0)
        t, scat, _ = m.sample(o, d, u, t_max, make_track_rng(pix, si, 2048))
        tr = m.tr(o, d, t_max, make_track_rng(pix, si, 1024))
        out[dev] = [x.cpu().numpy() for x in (t, scat, tr)]
    (t_g, s_g, tr_g), (t_w, s_w, tr_w) = out[DEVICE], out["cpu"]
    differ = float(np.mean(s_g != s_w))
    both = s_g & s_w
    t_err = float(np.max(np.abs(t_g[both] - t_w[both]) / np.abs(t_w[both]))) if both.any() else 0.0
    tr_err = float(np.max(np.abs(tr_g - tr_w)))
    log(f"  {label}: {n} lanes, {s_w.mean():.4f} scattered; masks differ on {differ:.2e} of "
        f"them; distance max rel diff {t_err:.3e}; transmittance mean {tr_w.mean():.4f}, max "
        f"abs diff {tr_err:.3e}")
    if differ > TRACK_MASK_SHARE or t_err > TRACK_RTOL or not np.allclose(
            tr_g, tr_w, rtol=TRACK_RTOL, atol=TRACK_RTOL):
        raise AssertionError(f"{label}: the card's tracking disagrees with the CPU's")
    return dict(lanes=n, scattered=float(s_w.mean()), masks_differ=differ,
                t_max_rel_diff=t_err, tr_max_abs_diff=tr_err)


def phase_volume(card, profile=False):
    """Phase 14: participating media.  (a) the fog-and-smoke scene file at
    full width through ``cli.main`` (K2's 31 sweeps against its plain walk,
    frame seconds); (b) at 32x32 on the card against the CPU; (c) the
    smoke's delta and ratio tracking on 262,144 lanes, card against CPU."""
    import os

    import numpy as np

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.core.imageio import read_image
    from pbrt_tpu_torch.media import GridDensityMedium
    from pbrt_tpu_torch.testscenes import write_volume_scene

    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    full = dict(VOLUME)
    batch = str(full.pop("ray_batch"))
    log(f"== phase 14 (a): the fog-and-smoke scene file at {full['xres']}x{full['yres']}, "
        f"{full['spp']} spp, maxdepth {full['maxdepth']}, a {full['grid']}^3 smoke grid, "
        f"ray_batch {batch}")
    n_torus = write_volume_scene(f"{d}/volume.pbrt", f"{d}/volume_torus.ply", **full,
                                 filename=f"{d}/volume.pfm")
    t0 = time.time()
    api = PbrtAPI(Options(), render_on_world_end=False, device=DEVICE)
    api.init()
    api.parse_file(f"{d}/volume.pbrt")
    parse_s = time.time() - t0
    del api
    t0 = time.time()
    got, build_s, launches = cli_render([f"{d}/volume.pbrt", "--ray-batch", batch, "-q"])
    first_s = time.time() - t0
    r = got["renderer"]
    c = r.compiled
    img = read_image(f"{d}/volume.pfm")[0]
    closest, shadow = r.integrator.queries_per_sample()
    n_tri = c.tri_data.count
    log(f"  parsing the file alone: {parse_s:.2f} s (the {full['grid']}^3 density values "
        f"included); cli.main: {first_s:.2f} s, scene build {build_s:.2f} s: {n_tri} "
        f"triangles ({n_torus} in the PLY), media {[type(m).__name__ for m in c.media]}, "
        f"camera medium {c.camera_medium}; {type(r.integrator).__name__} "
        f"({closest}, {shadow}) sweeps per lane; launches {launches}; image mean "
        f"{img.mean():.6f} max {img.max():.4f}")
    sweeps = frame_chunks(r) * (closest + shadow)
    if (closest, shadow) != (15, 16) or sweeps != VOLUME_SWEEPS or launches != {
            "stream_walk8": VOLUME_SWEEPS}:
        raise AssertionError(f"the volume scene launched {launches}, want stream_walk8 x "
                             f"{VOLUME_SWEEPS}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the volume scene's image is not finite or all black")
    # cli.main's frame counted the launches; every 8th sweep is checked
    # against the plain walk and timed with it
    frame, k2 = k2_frame("the volume scene", r, VOLUME_SWEEPS, card,
                         first=(got["seconds"], launches, img), plain_stride=8)
    if profile:
        frame["profile"] = phase_profile("volume", r, frame["frame_s"])
    smoke = c.media[c.media_names["smoke"]]
    if not isinstance(smoke, GridDensityMedium):
        raise AssertionError("the smoke must be a grid medium")
    del got, r, c

    small = dict(VOLUME_PARITY)
    log(f"== phase 14 (b): the volume scene at {small['xres']}x{small['yres']}, "
        f"{small['spp']} spp, maxdepth {small['maxdepth']}, a {small['grid']}^3 grid, "
        "card against CPU")
    write_volume_scene(f"{d}/volume_small.pbrt", f"{d}/volume_torus.ply", **small,
                       filename=f"{d}/volume_small.pfm")
    imgs = {}
    for dev in (DEVICE, "cpu"):
        rendered, _, _ = cli_render([f"{d}/volume_small.pbrt", "--ray-batch", batch, "-q"],
                                    device=dev)
        imgs[dev] = rendered["image"]
    parity = compare_images("the volume scene at 32x32", imgs[DEVICE], imgs["cpu"])

    log(f"== phase 14 (c): delta and ratio tracking through the {VOLUME['grid']}^3 smoke, "
        "card against CPU")
    tracking = compare_tracking("the smoke", smoke, TRACK_LANES)
    return dict(triangles=n_tri, parse_s=parse_s, build_s=build_s,
                cli_first_frame_s=first_s, launches=launches, parity=parity,
                tracking=tracking, **frame), k2


BDPT = dict(xres=256, yres=256, spp=8, maxdepth=4)  # phase 4's config 3
BDPT_BATCH = 1 << 18  # 2 chunks
BDPT_STRIDE = 4  # every 4th sweep checked against the plain walk
BDPT_SWEEPS = 2 * (9 + 23)  # 2 chunks x (9 closest + 23 any-hit) at maxdepth 4
BDPT_PARITY = dict(xres=32, yres=32, spp=2, maxdepth=2)  # cut from 3 for phase 16
MLT_MUTATIONS = 8  # the scene's mutationsperpixel (tests/test_mlt.py pins it)
MLT_EVALUATIONS = 11  # 65,536 chains: 2 bootstrap rounds, the seeding, 8 iterations
MLT_TABLE = 1024  # lanes of the seeded primary-sample table, card against CPU
VOLGRAD = dict(xres=256, yres=256, spp=1, maxdepth=5, grid=64)  # phase 14's scene
VOLGRAD_PARITY = dict(xres=16, yres=16, spp=2, maxdepth=2, grid=16)  # depth 3 before phase 16


def phase_bdpt(card, profile=False):
    """Phase 15: bidirectional and Metropolis light transport through the
    pbrt command on config 3, and a volpath gradient step.  (a) BDPT at
    full width through ``cli.main`` (K2 x 64 and nothing else, every 4th
    sweep against the plain walk, frame seconds, peak memory, card against
    CPU at 32x32 for the film and the splat channel); (b) MLT at full
    width (K2 x 11 evaluations x 32, acceptance, b against the BDPT image;
    one table's evaluation and b, card against CPU); (c) a volpath
    gradient step on phase 14's scene (remat's replay, peak memory, card
    against CPU at 16x16)."""
    import os

    import numpy as np
    import torch

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.integrators.mlt import MAX_CHAINS
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import config3_scenefile, write_torus_ply

    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    ply = f"{d}/torus.ply"
    write_torus_ply(ply)
    batch = str(BDPT_BATCH)
    res = {}

    log(f"== phase 15 (a): config 3 under bdpt through cli.main, {BDPT}, ray_batch {batch}")
    config3_scenefile(f"{d}/bdpt.pbrt", ply, **BDPT, integrator="bdpt")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got, build_s, launches = cli_render([f"{d}/bdpt.pbrt", "--ray-batch", batch, "-o",
                                         f"{d}/bdpt.pfm", "-q"])
    peak = torch.cuda.max_memory_allocated()
    r = got["renderer"]
    bd = r.integrator
    qps = bd.queries_per_sample()
    splat = got["state"]["splat_xyz"]
    img = got["image"]
    log(f"  cli.main: build {build_s:.2f} s, frame {got['seconds']:.3f} s, "
        f"{type(bd).__name__} (t_max {bd.t_max}, s_max {bd.s_max}, light tracing "
        f"{bd.enable_t0}) {qps} sweeps per lane, launches {launches}; peak memory "
        f"{peak / 2**30:.3f} GiB; image mean {img.mean():.6f}; splat channel max "
        f"{float(splat.max()):.5f}")
    if qps != (9, 23) or frame_chunks(r) * sum(qps) != BDPT_SWEEPS:
        raise AssertionError(f"bdpt issues {qps} sweeps a lane in {frame_chunks(r)} chunks")
    if not float(splat.max()) > 0 or not torch.isfinite(splat).all():
        raise AssertionError("the bdpt frame's splat channel is zero or not finite")
    frame, k2 = k2_frame("the bdpt frame", r, BDPT_SWEEPS, card,
                         first=(got["seconds"], launches, img), plain_stride=BDPT_STRIDE)
    if profile:
        frame["profile"] = phase_profile("bdpt", r, frame["frame_s"])
    bdpt_img = img
    del got, r, bd, splat
    parity = {}
    imgs = {}
    config3_scenefile(f"{d}/bdpt_small.pbrt", ply, **BDPT_PARITY, integrator="bdpt")
    for dev in (DEVICE, "cpu"):
        rendered, _, _ = cli_render([f"{d}/bdpt_small.pbrt", "--ray-batch", batch, "-o",
                                     f"{d}/bdpt_small_{dev}.pfm", "-q"], device=dev)
        st = rendered["state"]
        imgs[dev] = (rendered["film"].to_rgb(st, splat_scale=0.0).cpu().numpy(),
                     st["splat_xyz"].cpu().numpy())
    parity["film"] = compare_images("bdpt film at 32x32", imgs[DEVICE][0], imgs["cpu"][0])
    parity["splats"] = compare_images("bdpt splat channel at 32x32", imgs[DEVICE][1],
                                      imgs["cpu"][1])
    res["bdpt"] = dict(build_s=build_s, launches=launches, queries_per_sample=list(qps),
                       peak_bytes=peak, parity=parity, **frame)

    log(f"== phase 15 (b): config 3 under mlt through cli.main, {MLT_MUTATIONS} mutations "
        "per pixel")
    config3_scenefile(f"{d}/mlt.pbrt", ply, **BDPT, integrator="mlt",
                      extra=f'"integer mutationsperpixel" {MLT_MUTATIONS}')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got, build_s, launches = cli_render([f"{d}/mlt.pbrt", "--ray-batch", batch, "-o",
                                         f"{d}/mlt.pfm", "-q"])
    peak = torch.cuda.max_memory_allocated()
    mlt = got["renderer"].integrator
    img = got["image"]
    lum = 0.212671 * bdpt_img[..., 0] + 0.715160 * bdpt_img[..., 1] + 0.072169 * bdpt_img[..., 2]
    lanes = mlt.last_lanes // mlt.last_evaluations
    log(f"  cli.main: build {build_s:.2f} s, render {got['seconds']:.3f} s: "
        f"{mlt.last_evaluations} evaluations of {lanes} chains, launches {launches}, "
        f"acceptance {mlt.last_acceptance:.4f}, b {mlt.last_b:.6f} (the bdpt image's mean "
        f"luminance {lum.mean():.6f}); image mean {img.mean():.6f} (bdpt {bdpt_img.mean():.6f}); "
        f"peak memory {peak / 2**30:.3f} GiB")
    if (mlt.last_evaluations, lanes) != (MLT_EVALUATIONS, PIXELS) or launches != {
            "stream_walk8": mlt.last_evaluations * sum(mlt.queries_per_sample())}:
        raise AssertionError(f"mlt: {mlt.last_evaluations} evaluations, launches {launches}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the mlt image is not finite or all black")
    if abs(img.mean() - bdpt_img.mean()) > 0.15 * bdpt_img.mean():
        raise AssertionError("the mlt image's mean is not within rtol 0.15 of bdpt's")
    if abs(mlt.last_b - lum.mean()) > 0.1 * lum.mean():
        raise AssertionError("mlt's b is not within rtol 0.1 of the bdpt image's luminance")
    mlt_res = dict(build_s=build_s, seconds=got["seconds"], launches=launches,
                   evaluations=mlt.last_evaluations, chains=lanes,
                   acceptance=mlt.last_acceptance, b=mlt.last_b, image_mean=float(img.mean()),
                   bdpt_image_mean=float(bdpt_img.mean()), peak_bytes=peak, card=card)
    del got, mlt
    config3_scenefile(f"{d}/mlt_small.pbrt", ply, **BDPT_PARITY, integrator="mlt",
                      extra=f'"integer mutationsperpixel" {MLT_MUTATIONS}')
    evals, bs = {}, {}
    for dev in (DEVICE, "cpu"):
        api = PbrtAPI(Options(ray_batch=BDPT_BATCH), render_on_world_end=False, device=dev)
        api.init()
        api.parse_file(f"{d}/mlt_small.pbrt")
        rr = Renderer(api.scene, api.opt, device=dev)
        m = rr.integrator
        u = np.random.default_rng(7).uniform(size=(MLT_TABLE, m.n_dims)).astype(np.float32)
        with torch.no_grad():
            ev = m._evaluate(torch.as_tensor(u, device=dev), rr.film)
            evals[dev] = [x.cpu().numpy() for x in ev[:3]]
            # b: the mean of f over the bootstrap tables, as render takes it
            n_pix = rr.film.cropped_pixel_bounds.area()
            n_chains = min(MAX_CHAINS, max(1024, n_pix))
            boot = [m._evaluate(m._uniform(n_chains, m.n_dims, 1000 + k, dev), rr.film)[2]
                    for k in range(max(2, m.n_bootstrap // n_chains))]
            bs[dev] = float(torch.cat(boot).mean())
        del rr, m
    # p_film [N, 2], L [N, 3], f [N] as [N, 1]: phase 5's tolerance per lane
    mlt_parity = {name: compare_images(f"mlt evaluation of {MLT_TABLE} lanes at 32x32: {name}",
                                       g.reshape(MLT_TABLE, -1), w.reshape(MLT_TABLE, -1))
                  for name, g, w in zip(("p_film", "L", "f"), evals[DEVICE], evals["cpu"])}
    log(f"  bootstrap b at 32x32: card {bs[DEVICE]:.7f} cpu {bs['cpu']:.7f}")
    if abs(bs[DEVICE] - bs["cpu"]) > 1e-4 * abs(bs["cpu"]):
        raise AssertionError("mlt's bootstrap b on the card differs from the CPU's")
    mlt_res.update(parity=mlt_parity, b_card=bs[DEVICE], b_cpu=bs["cpu"])
    res["mlt"] = mlt_res
    k2_mlt = dict(launches=launches["stream_walk8"], evaluations=mlt_res["evaluations"],
                  sweeps_per_evaluation=BDPT_SWEEPS // 2)

    res["volpath_gradients"], k2_grad = phase_volpath_grad(card, d)
    return res, k2, k2_mlt, k2_grad


def file_renderer(path, dev):
    """A ``Renderer`` of the scene file ``path`` on ``dev``, default options."""
    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.render import Renderer

    api = PbrtAPI(Options(), render_on_world_end=False, device=dev)
    api.init()
    api.parse_file(path)
    return Renderer(api.scene, api.opt, device=dev)


def phase_volpath_grad(card, d):
    """Phase 15 (c): one volpath loss-and-gradient step on phase 14's scene
    over all 65,536 pixels at 1 spp with ``remat=True`` (its forward's and
    its forward+backward seconds, K2's launches in the forward and the replay,
    peak memory, every leaf finite); the same step without remat (the
    gradients equal, its peak); every leaf on the card against the CPU's at
    16x16."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, value_and_grad
    from pbrt_tpu_torch.testscenes import write_volume_scene

    log(f"== phase 15 (c): a volpath gradient step on the fog-and-smoke scene, {VOLGRAD}, "
        "remat=True, a zero target")

    write_volume_scene(f"{d}/volgrad.pbrt", f"{d}/volume_torus.ply", **VOLGRAD)
    r = file_renderer(f"{d}/volgrad.pbrt", DEVICE)
    b = r.film.cropped_pixel_bounds
    target = np.zeros((b.height, b.width, 3), np.float32)
    theta = r.compiled.initial_theta()
    px = torch.as_tensor(b.offsets(), device=DEVICE)
    loss = make_loss_fn(r, target, spp=VOLGRAD["spp"], remat=True)
    closest, shadow = r.integrator.queries_per_sample()
    fwd, bwd = {}, {}

    def counted(t, pixels):
        # the forward's seconds are taken here, inside the step (with
        # autograd's tape); a separate no_grad forward before phase 19
        reset_counts()
        t0 = time.time()
        value = loss(t, pixels)
        torch.cuda.synchronize()
        fwd["seconds"] = time.time() - t0
        fwd.update(read_counts())
        reset_counts()
        return value

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    value, grads = value_and_grad(counted, theta, px)
    torch.cuda.synchronize()
    step_s = time.time() - t0
    fwd_s = fwd["seconds"]
    peak = torch.cuda.max_memory_allocated()
    bwd.update(read_counts())
    k2_fwd, k2_bwd = fwd["stream_walk8"], bwd["stream_walk8"]
    log(f"  {px.shape[0]} pixels: loss {float(value):.6e}; forward {fwd_s:.3f} s, "
        f"forward+backward {step_s:.3f} s on {card}; stream_walk8 launches forward {k2_fwd}, "
        f"backward (the replay) {k2_bwd}; peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} "
        f"above the {base / 2**30:.3f} GiB held before)")
    if k2_fwd != (closest + shadow) * VOLGRAD["spp"] or not 0 < k2_bwd <= k2_fwd:
        raise AssertionError(f"stream_walk8 launched {k2_fwd} times forward, {k2_bwd} in the "
                             "replay")
    for k, v in grad_leaves(grads):
        if not torch.isfinite(v).all():
            raise AssertionError(f"volpath gradient {k} not finite")
    leaves = {k: float(v.abs().max()) for k, v in grad_leaves(grads) if v.numel()}
    log(f"  largest |gradient| per leaf: {leaves}")
    out = dict(pixels=int(px.shape[0]), loss=float(value), forward_s=fwd_s,
               forward_backward_s=step_s, peak_bytes=peak, above_base_bytes=peak - base,
               k2_launches_forward=k2_fwd, k2_launches_backward=k2_bwd, card=card)

    # the same step without remat: the host-bound step costs as much at
    # 4,096 pixels as at 65,536, so it runs at full width
    kept = dict(grad_leaves(grads))
    del grads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    _, g = value_and_grad(make_loss_fn(r, target, VOLGRAD["spp"], remat=False), theta, px)
    torch.cuda.synchronize()
    plain_step_s = time.time() - t0
    memory = {"remat_true": peak, "remat_false": torch.cuda.max_memory_allocated()}
    worst = max(float((v - kept[k]).abs().max()) if v.numel() else 0.0
                for k, v in grad_leaves(g))
    scale = max(float(v.abs().max()) for v in kept.values() if v.numel())
    log(f"  without remat: forward+backward {plain_step_s:.3f} s, peak "
        f"{memory['remat_false'] / 2**30:.3f} GiB (with remat {peak / 2**30:.3f}); max |diff| "
        f"{worst:.3e} of {scale:.3e}")
    if worst > 1e-6 * scale:
        raise AssertionError("volpath gradients with and without remat differ")
    out.update(remat_pixels=int(px.shape[0]), remat_peak_bytes=memory, remat_max_diff=worst,
               no_remat_step_s=plain_step_s)
    del r, kept, g

    write_volume_scene(f"{d}/volgrad_small.pbrt", f"{d}/volume_torus.ply", **VOLGRAD_PARITY)
    grads = {}
    for dev in (DEVICE, "cpu"):
        rr = file_renderer(f"{d}/volgrad_small.pbrt", dev)
        bb = rr.film.cropped_pixel_bounds
        lf = make_loss_fn(rr, np.zeros((bb.height, bb.width, 3), np.float32),
                          spp=VOLGRAD_PARITY["spp"])
        _, grads[dev] = value_and_grad(lf, rr.compiled.initial_theta(),
                                       torch.as_tensor(bb.offsets(), device=dev))
    out["parity_max_rel_to_scale"] = compare_grads("volpath at 16x16", grads[DEVICE],
                                                   grads["cpu"])
    log(f"  16x16: every leaf equal, max |card - cpu| {out['parity_max_rel_to_scale']:.3e} "
        "of the largest magnitude")
    return out, dict(grad_launches_forward=k2_fwd, grad_launches_backward=k2_bwd)


MOTION = dict(xres=256, yres=256, spp=8, maxdepth=4)  # phase 4's config 3, moving
MOTION_BATCH = 1 << 18  # 2 chunks
MOTION_ROTATE, MOTION_SHIFT = 30.0, 0.25  # the torus's turn (degrees), the camera's move
MOTION_KEYS = 4  # the torus's 30-degree turn: 4 keyframes (core/animated.n_keys)
MOTION_SWEEPS = 2 * (4 + 3)  # K7: 2 chunks x (4 closest + 3 any-hit) at maxdepth 4
MOTION_STRIDE = 5  # every 5th sweep checked against the plain walk (every 4th before phase 19)
MOTION_PARITY = dict(xres=16, yres=16, spp=2, maxdepth=3)  # 32x32 before phase 19


def blend_ops(n_keys):
    """Float ops of one triangle's blend in K7: at most two hat weights
    are non-zero, and only those keys' rows are read: 9 products, then 9
    fused multiply-adds (2 ops each) when a second key counts: 27 ops, 9
    at K = 1."""
    return 9 * (2 * min(n_keys, 2) - 1)


SPPM_FULL = dict(xres=256, yres=256, spp=1, maxdepth=4)
SPPM_ITERATIONS = 16
SPPM_SWEEPS = SPPM_ITERATIONS * (4 + 4 + 4)  # camera closest + light samples + photons
SPPM_STRIDE = 4
SPPM_PARITY = dict(xres=32, yres=32, spp=1, maxdepth=4)
SPPM_PARITY_ITERATIONS = 2
CAMERA_LINES = {
    "environment": 'Camera "environment"',
    "realistic": 'Camera "realistic" "string lensfile" "biconvex-50mm-f8"',
}


def record_anim_walks(renderer):
    """Render one frame, keeping what the keyframed intersector hands K7 on
    every sweep: (nodes_f, nodes_i, keys, packed keys, 7 ray columns, time,
    any_hit)."""
    import torch

    from pbrt_tpu_torch.ops import animated_intersect

    calls = []
    orig = animated_intersect.anim_walk

    def wrapped(nodes_f, nodes_i, keys, packed, comps, time_, any_hit=False):
        calls.append((nodes_f, nodes_i, keys, packed, tuple(c.clone() for c in comps),
                      time_.clone(), any_hit))
        return orig(nodes_f, nodes_i, keys, packed, comps, time_, any_hit)

    animated_intersect.anim_walk = wrapped
    try:
        renderer.render()
        torch.cuda.synchronize()
    finally:
        animated_intersect.anim_walk = orig
    return calls


def check_anim(label, call, rtol=1e-6):
    """K7 against its plain version run on the card on one recorded sweep,
    by phase 3's rules (``anim_walk.anim_disagreement``; t within
    ``rtol``, b0 and b1 within ``anim_walk.B_ATOL`` of t's float).
    Returns (max |dt| over hit lanes, (bytes, ops) of the work
    counted by the plain version: rays and times in and out once,
    distinct node rows (48 bytes) and triangles' keyframe rows (K x 9
    values) once, 25 ops a box test and 59 + ``blend_ops(K)`` a blended
    triangle test; the plain version's ms: this one run, with its work
    counters on, by CUDA events; max |db| where both hit the same prim,
    and :func:`worst_b_lane` of the lane where it is largest)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.kernels import anim_walk
    from pbrt_tpu_torch.kernels.bvh8_walk import counted

    nodes_f, nodes_i, keys, packed, comps, tm, any_hit = call
    kern = anim_walk.anim_walk(nodes_f, nodes_i, keys, packed, comps, tm, any_hit)
    torch.cuda.synchronize()
    stats = anim_walk.task_stats()
    counters, out = {}, []
    plain_ms = cuda_ms(lambda: out.append(anim_walk.anim_walk_plain(
        nodes_f, nodes_i, keys, comps, tm, any_hit, counters)), 1, warmup=False)
    host = lambda v: [x.cpu().numpy() for x in v]  # noqa: E731
    o = np.stack(host(comps[0:3]), 1)
    d = np.stack(host(comps[3:6]), 1)
    t_max = comps[6].cpu().numpy()
    got, want = host(kern), host(out[0])
    problem = anim_walk.anim_disagreement(got, want, keys.cpu().numpy(), o, d,
                                          tm.cpu().numpy(), any_hit, rtol)
    if problem is not None:
        raise AssertionError(f"anim_walk {label} (any_hit={any_hit}): {problem}")
    hit = want[1] >= 0
    err = 0.0 if any_hit or not hit.any() else float(np.abs(got[0][hit] - want[0][hit]).max())
    db = 0.0 if any_hit else anim_walk.max_b_diff(got, want)
    live = int((t_max > 1e-4).sum())
    if stats["live_rays"] != live:
        raise AssertionError(f"anim_walk {label}: the prepass listed {stats['live_rays']} of "
                             f"{live} live lanes")
    log(f"  anim_walk {label} {'any-hit' if any_hit else 'closest'}: {len(t_max)} rays, "
        f"{live} live, R {stats['rays_per_task']} rays a task, {stats['lanes_per_ray']} lanes "
        f"a ray on {stats['resident_warps']} resident warps, {int(hit.sum())} hit, max |dt| "
        f"{err:.3e}, max |db| {db:.3e}, plain {plain_ms:.1f} ms")
    worst = None if any_hit or db == 0.0 else worst_b_lane(call, got, want)
    c = counted(counters)
    k, size = keys.shape[1], keys.element_size()
    # 7 ray columns and the time in; t, b0, b1 and the int32 prim out
    n_bytes = (len(t_max) * (11 * size + 4) + c["node_rows"] * 48
               + c["leaf_rows"] * k * 9 * size)
    n_ops = c["slab_tests"] * SLAB_OPS + c["tri_tests"] * (TRI_OPS + blend_ops(k))
    return err, (n_bytes, n_ops), plain_ms, db, worst


def worst_b_lane(call, got, want):
    """Of two K7 results on a recorded sweep, the lane where b0 or b1
    differ the most among lanes that hit the same prim: its |db|, the
    lane's time and hat weights, the triangle's K keyframe rows, and the
    Moller-Trumbore terms of the plain version's blend there (det, the
    numerators of b0 and b1, |e1| |d x e2|, the scale that det cancels
    from)."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.kernels.anim_walk import blend, time_weights

    nodes_f, nodes_i, keys, packed, comps, tm, any_hit = call
    same = (want[1] >= 0) & (got[1] == want[1])
    diff = np.where(same, np.maximum(np.abs(got[2] - want[2]), np.abs(got[3] - want[3])), -1.0)
    lane = int(np.argmax(diff))
    prim = int(want[1][lane])
    o = torch.stack([c[lane] for c in comps[0:3]]).cpu()
    d = torch.stack([c[lane] for c in comps[3:6]]).cpu()
    k = keys[prim].cpu()
    w = time_weights(tm[lane:lane + 1].cpu(), k.shape[0])
    v = blend(k[None], w)[0]
    e1, e2 = v[3:6] - v[0:3], v[6:9] - v[0:3]
    pv = torch.linalg.cross(d, e2)
    det = float(torch.dot(e1, pv))
    tv = o - v[0:3]
    qv = torch.linalg.cross(tv, e1)
    return {"lane": lane, "prim": prim, "db": float(diff[lane]), "time": float(tm[lane]),
            "weights": w[0].tolist(), "keys": k.tolist(), "det": det,
            "b0_num": float(torch.dot(tv, pv)), "b1_num": float(torch.dot(d, qv)),
            "scale": float(torch.linalg.norm(e1) * torch.linalg.norm(pv)),
            "b": [float(got[2][lane]), float(got[3][lane]), float(want[2][lane]),
                  float(want[3][lane])]}


def time_anim_sweeps(calls):
    """K7 on each recorded sweep: (ms by CUDA events, mean of 20 after a
    warm-up; the launch's task_stats) per sweep."""
    from pbrt_tpu_torch.kernels import anim_walk

    out = []
    for c in calls:
        ms = cuda_ms(lambda: anim_walk.anim_walk(*c[:6], any_hit=c[6]), 20)
        out.append((ms, anim_walk.task_stats()))
    return out


def sweep_stats_line(timed_sweeps):
    """live rays, R and lanes a ray per sweep, and the sweeps with fewer
    live rays than resident warps."""
    stats = [st for _, st in timed_sweeps]
    few = [i for i, st in enumerate(stats) if st["live_rays"] < st["resident_warps"]]
    per = [(st["live_rays"], st["rays_per_task"], st["lanes_per_ray"]) for st in stats]
    return (f"live rays / R / lanes a ray per sweep {per} on {stats[0]['resident_warps']} "
            f"resident warps; sweeps with fewer live rays than resident warps: {few or 'none'}")


def eager_ops(r):
    """Eager PyTorch ops of one ``r.render()`` outside the intersector's
    calls (a dispatch counter; the walks' plain versions excluded)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    itx = r.compiled.intersector
    on = [True]

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += on[0]
            return func(*args, **(kwargs or {}))

    def quiet(f):
        def g(*a, **k):
            on[0] = False
            try:
                return f(*a, **k)
            finally:
                on[0] = True
        return g

    itx.intersect, itx.occluded = quiet(itx.intersect), quiet(itx.occluded)
    try:
        with Count():
            r.render(progress=False)
    finally:
        del itx.intersect, itx.occluded
    return Count.n


def phase_motion(card):
    """Phase 16: motion blur, SPPM and the environment and realistic
    cameras through the pbrt command.  (a) config 3 with a turning torus
    and a moving camera at full width (K7 x 14, every 5th sweep against
    its plain version on the card, frame seconds, busy share; 16x16 card
    against CPU); (b) the moving quad under volpath, bdpt, sppm and mlt
    and a moving sphere, card against CPU; (c) config 3 under sppm at full width
    (K2 x 192, every 4th sweep against the plain walk, render seconds,
    eager ops per iteration, peak memory; 32x32 card against CPU); (d)
    config 3 under the environment and realistic cameras (a frame each,
    K2 x 14, and 16x16 card against CPU)."""
    import os

    import numpy as np
    import torch

    from pbrt_tpu_torch.testscenes import (
        MOVING_SPHERE,
        config3_scenefile,
        mesh_scene_renderer,
        motion_quad_text,
        write_torus_ply,
    )

    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    ply = f"{d}/torus.ply"
    write_torus_ply(ply)
    batch = str(MOTION_BATCH)
    res = {}

    log(f"== phase 16 (a): config 3 in motion through cli.main (the torus turns 30 degrees, "
        f"the camera moves 0.25 along x), {MOTION}, ray_batch {batch}")
    config3_scenefile(f"{d}/motion.pbrt", ply, **MOTION, rotate=MOTION_ROTATE,
                      shift=MOTION_SHIFT)
    got, build_s, launches = cli_render([f"{d}/motion.pbrt", "--ray-batch", batch, "-o",
                                         f"{d}/motion.pfm", "-q"])
    r = got["renderer"]
    img = got["image"]
    n_keys = r.compiled.tables["_flags"]["animated_keys"]
    qps = r.integrator.queries_per_sample()
    log(f"  cli.main: build {build_s:.2f} s, first frame {got['seconds']:.3f} s, "
        f"{r.compiled.tri_data.count} triangles in {n_keys} keyframes, camera keyframes "
        f"{tuple(r.camera._anim_c2w.shape)}, {qps} sweeps per lane, launches {launches}; "
        f"image mean {img.mean():.6f} max {img.max():.4f}")
    if n_keys != MOTION_KEYS or launches != {"anim_walk": MOTION_SWEEPS}:
        raise AssertionError(f"the motion frame: {n_keys} keys, launches {launches}, want "
                             f"{MOTION_KEYS} keys and anim_walk x {MOTION_SWEEPS}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the motion frame's image is not finite or all black")
    calls = record_anim_walks(r)
    if len(calls) != MOTION_SWEEPS:
        raise AssertionError(f"the motion frame: recorded {len(calls)} K7 sweeps")
    works, plain, err = [], [], 0.0
    for i, call in enumerate(calls[::MOTION_STRIDE]):
        e, work, p_ms, _, _ = check_anim(f"motion sweep {i * MOTION_STRIDE}", call)
        err = max(err, e)
        works.append(work)
        plain.append(p_ms)
    swept = time_anim_sweeps(calls)
    ms = [t for t, _ in swept]
    log("  " + sweep_stats_line(swept))
    del calls
    b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]))
    ms_checked = float(np.mean(ms[::MOTION_STRIDE]))
    log(f"  anim_walk per sweep {[round(t, 4) for t in ms]} ms: mean {np.mean(ms):.4f} ms "
        f"({ms_checked:.4f} over the checked sweeps, bound {b_ms:.5f} ms ({b_by}), "
        f"{b_ms / ms_checked:.2%} of it); plain on the card {[round(t, 1) for t in plain]} ms")
    median, times = timed(lambda: r.image(r.render()))
    queries = PIXELS * MOTION["spp"] * sum(qps)
    prof = phase_profile("motion", r, median)
    log(f"  motion frame {median:.4f} s ({[round(x, 4) for x in times]}), "
        f"{queries / median / 1e6:.3f} Mray/s, {prof['launches']} launches, card busy "
        f"{prof['device_s'] / median:.1%}, on {card}")
    res["motion"] = dict(build_s=build_s, keys=n_keys, launches=launches, frame_s=median,
                         frames_s=times, mray_s=queries / median / 1e6,
                         kernel_launches=prof["launches"], device_s=prof["device_s"],
                         busy_share=prof["device_s"] / median, card=card)
    k7_res = dict(max_abs_err=err, ms=float(np.mean(ms)), plain_ms=float(np.mean(plain)),
                  bound_ms=b_ms, bound_by=b_by, library_ms=None, sweep_ms=ms,
                  sweep_stats=[st for _, st in swept],
                  ms_at_plain_sweeps=ms_checked, plain_stride=MOTION_STRIDE,
                  launches_per_frame=launches["anim_walk"])
    del got, r
    config3_scenefile(f"{d}/motion_small.pbrt", ply, **MOTION_PARITY, rotate=MOTION_ROTATE,
                      shift=MOTION_SHIFT)
    imgs = {dev: cli_render([f"{d}/motion_small.pbrt", "--ray-batch", batch, "-o",
                             f"{d}/motion_small_{dev}.pfm", "-q"], device=dev)[0]["image"]
            for dev in (DEVICE, "cpu")}
    res["motion"]["parity"] = compare_images(f"the motion scene, {MOTION_PARITY}", imgs[DEVICE],
                                             imgs["cpu"])

    log("== phase 16 (b): the moving quad under volpath, bdpt, sppm and mlt, and a moving "
        "sphere under path, 16x16, card against CPU")
    quad = {"volpath": motion_quad_text("volpath"), "bdpt": motion_quad_text("bdpt"),
            "sppm": motion_quad_text("sppm", extra='"integer numiterations" 4 '
                                     '"integer photonsperiteration" 4096'),
            "moving sphere": motion_quad_text("path", sphere=MOVING_SPHERE)}
    res["motion_integrators"] = {}
    for label, text in quad.items():
        with open(f"{d}/quad.pbrt", "w") as f:
            f.write(text)
        imgs, quad_launches = {}, None
        for dev in (DEVICE, "cpu"):
            rendered, _, lc = cli_render([f"{d}/quad.pbrt", "-o", f"{d}/quad_{dev}.pfm", "-q"],
                                         device=dev)
            imgs[dev] = rendered["image"]
            quad_launches = lc if dev == DEVICE else quad_launches
        log(f"  {label}: launches {quad_launches}")
        if label == "moving sphere" and not quad_launches.get("anim_walk"):
            raise AssertionError("the moving sphere's frame did not launch anim_walk")
        res["motion_integrators"][label] = dict(
            launches=quad_launches, parity=compare_images(f"{label} at 16x16", imgs[DEVICE],
                                                          imgs["cpu"]))
    # mlt accepts or rejects on ratios of its target, so it is held as
    # phase 15 (b) holds it: one evaluation of a seeded table (its time
    # from the table's dimension 4) and b, card against CPU
    with open(f"{d}/quad.pbrt", "w") as f:
        f.write(motion_quad_text("mlt", spp=1, extra='"integer mutationsperpixel" 4'))
    mlt = {}
    for dev in (DEVICE, "cpu"):
        rendered, _, lc = cli_render([f"{d}/quad.pbrt", "-o", f"{d}/quad_mlt_{dev}.pfm", "-q"],
                                     device=dev)
        rr, img = rendered["renderer"], rendered["image"]
        m = rr.integrator
        u = np.random.default_rng(7).uniform(size=(MLT_TABLE, m.n_dims)).astype(np.float32)
        with torch.no_grad():
            ev = m._evaluate(torch.as_tensor(u, device=dev), rr.film)
        mlt[dev] = dict(ev=[x.cpu().numpy() for x in ev[:3]], img=img, b=m.last_b,
                        acceptance=m.last_acceptance, launches=lc)
        del rendered, rr, m
    got, want = mlt[DEVICE], mlt["cpu"]
    log(f"  mlt: launches {got['launches']}; b card {got['b']:.7f} cpu {want['b']:.7f}, "
        f"acceptance card {got['acceptance']:.4f} cpu {want['acceptance']:.4f}, image mean "
        f"card {got['img'].mean():.6f} cpu {want['img'].mean():.6f}")
    parity = {name: compare_images(f"mlt evaluation of {MLT_TABLE} lanes at 16x16: {name}",
                                   g.reshape(MLT_TABLE, -1), w.reshape(MLT_TABLE, -1))
              for name, g, w in zip(("p_film", "L", "f"), got["ev"], want["ev"])}
    if not (np.isfinite(got["img"]).all() and got["img"].max() > 0):
        raise AssertionError("mlt over the moving quad: the card's image is not finite or black")
    if (abs(got["b"] - want["b"]) > 1e-4 * abs(want["b"])
            or abs(got["acceptance"] - want["acceptance"]) > 0.05
            or abs(got["img"].mean() - want["img"].mean()) > 0.15 * want["img"].mean()):
        raise AssertionError("mlt over the moving quad: b, acceptance or image mean differ "
                             "between the card and the CPU")
    res["motion_integrators"]["mlt"] = dict(
        launches=got["launches"], parity=parity, b_card=got["b"], b_cpu=want["b"],
        acceptance_card=got["acceptance"], acceptance_cpu=want["acceptance"],
        image_mean_card=float(got["img"].mean()), image_mean_cpu=float(want["img"].mean()))

    log(f"== phase 16 (c): config 3 under sppm through cli.main, {SPPM_FULL}, "
        f"{SPPM_ITERATIONS} iterations, default photons and radius")
    sppm = f'"integer numiterations" {SPPM_ITERATIONS}'
    config3_scenefile(f"{d}/sppm.pbrt", ply, **SPPM_FULL, integrator="sppm", extra=sppm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got, build_s, launches = cli_render([f"{d}/sppm.pbrt", "--ray-batch", batch, "-o",
                                         f"{d}/sppm.pfm", "-q"])
    peak = torch.cuda.max_memory_allocated()
    r = got["renderer"]
    sp = r.integrator
    img = got["image"]
    first_s = got["seconds"]
    log(f"  cli.main: build {build_s:.2f} s, first render {got['seconds']:.3f} s, "
        f"{sp.last_evaluations} iterations of {sp.last_lanes // sp.last_evaluations} camera "
        f"lanes and {sp.last_photon_sweeps // sp.last_evaluations // sp.max_depth} photons, "
        f"launches {launches}, peak memory {peak / 2**30:.3f} GiB; image mean "
        f"{img.mean():.6f} max {img.max():.4f}")
    if launches != {"stream_walk8": SPPM_SWEEPS}:
        raise AssertionError(f"sppm launched {launches}, want stream_walk8 x {SPPM_SWEEPS}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the sppm image is not finite or all black")
    walk = r.compiled.intersector.walk
    calls = record_walks(r)
    if len(calls) != SPPM_SWEEPS:
        raise AssertionError(f"sppm: recorded {len(calls)} sweeps")
    # every 4th sweep, the phase rotating by one each iteration, so that
    # each of an iteration's 12 sweeps (4 camera, 4 light-sample, 4 photon)
    # is checked in every 4th iteration
    per_iteration = SPPM_SWEEPS // SPPM_ITERATIONS
    checked = [i for i in range(SPPM_SWEEPS) if (i + i // per_iteration) % SPPM_STRIDE == 0]
    timed_calls, works, stats, plain, err = [], [], [], [], 0.0
    for i, (o, dd, t_max, any_hit) in enumerate(calls):
        if i not in checked:
            timed_calls.append(kernel_call("stream_walk8", walk, o, dd, t_max, any_hit))
            stats.append(None)
            continue
        e, call, work, st, p_ms = check_walk("stream_walk8", f"sppm sweep {i}", walk, o, dd,
                                             t_max, any_hit)
        err = max(err, e)
        timed_calls.append(call)
        works.append(work)
        stats.append(st)
        plain.append(p_ms)
    del calls
    ms = [cuda_ms(lambda: fn(*args, **kw), 5) for fn, args, kw in timed_calls]
    del timed_calls
    b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]))
    ms_checked = float(np.mean([ms[i] for i in checked]))
    log(f"  stream_walk8 on the sppm sweeps: mean {np.mean(ms):.4f} ms ({ms_checked:.4f} "
        f"over the {len(checked)} checked sweeps, bound {b_ms:.5f} ms ({b_by}), "
        f"{b_ms / ms_checked:.2%} of it); the first iteration's "
        f"{[round(t, 4) for t in ms[:per_iteration]]} ms; plain on the card "
        f"{np.mean(plain):.1f} ms a checked sweep")
    median, times = timed(lambda: r.image(r.render()), reps=2)
    del r, got
    small = mesh_scene_renderer(xres=16, yres=16, spp=1, maxdepth=SPPM_FULL["maxdepth"],
                                nu=24, nv=24, device="cpu", integrator="sppm",
                                extra='"integer numiterations" 1')[0]
    ops = eager_ops(small)
    log(f"  sppm render {median:.3f} s ({[round(x, 3) for x in times]}) for "
        f"{SPPM_ITERATIONS} iterations on {card}; {ops} eager ops an iteration outside the "
        "walks (a CPU count)")
    res["sppm"] = dict(build_s=build_s, first_s=first_s, launches=launches,
                       render_s=median, renders_s=times, eager_ops_per_iteration=ops,
                       peak_bytes=peak, iterations=SPPM_ITERATIONS, card=card)
    k2_sppm = dict(launches=launches["stream_walk8"], ms=float(np.mean(ms)),
                   ms_at_plain_sweeps=ms_checked, bound_ms=b_ms, bound_by=b_by,
                   plain_ms=float(np.mean(plain)), max_abs_err=err, plain_stride=SPPM_STRIDE,
                   sweep_ms=ms)
    config3_scenefile(f"{d}/sppm_small.pbrt", ply, **SPPM_PARITY, integrator="sppm",
                      extra=f'"integer numiterations" {SPPM_PARITY_ITERATIONS}')
    imgs = {dev: cli_render([f"{d}/sppm_small.pbrt", "--ray-batch", batch, "-o",
                             f"{d}/sppm_small_{dev}.pfm", "-q"], device=dev)[0]["image"]
            for dev in (DEVICE, "cpu")}
    res["sppm"]["parity"] = compare_images("sppm at 32x32", imgs[DEVICE], imgs["cpu"])

    res["cameras"] = {}
    for name, line in CAMERA_LINES.items():
        log(f"== phase 16 (d): config 3 under {line}, {MOTION}")
        config3_scenefile(f"{d}/{name}.pbrt", ply, **MOTION, camera=line)
        got, build_s, launches = cli_render([f"{d}/{name}.pbrt", "--ray-batch", batch, "-o",
                                             f"{d}/{name}.pfm", "-q"])
        r = got["renderer"]
        img = got["image"]
        if launches != {"stream_walk8": 14} or type(r.camera).__name__ == "PerspectiveCamera":
            raise AssertionError(f"{name}: camera {type(r.camera).__name__}, launches "
                                 f"{launches}, want stream_walk8 x 14")
        if not (np.isfinite(img).all() and img.max() > 0):
            raise AssertionError(f"{name}: image not finite or all black")
        median, times = timed(lambda: r.image(r.render()))
        log(f"  {name}: build {build_s:.2f} s, first frame {got['seconds']:.3f} s, launches "
            f"{launches}, frame {median:.4f} s ({[round(x, 4) for x in times]}) on {card}; "
            f"image mean {img.mean():.6f}, {(img.max(axis=-1) > 0).mean():.3f} of pixels lit")
        del got, r
        config3_scenefile(f"{d}/{name}_small.pbrt", ply, **MOTION_PARITY, camera=line)
        imgs = {dev: cli_render([f"{d}/{name}_small.pbrt", "--ray-batch", batch, "-o",
                                 f"{d}/{name}_small_{dev}.pfm", "-q"], device=dev)[0]["image"]
                for dev in (DEVICE, "cpu")}
        res["cameras"][name] = dict(
            build_s=build_s, launches=launches, frame_s=median, frames_s=times, card=card,
            parity=compare_images(f"{name} camera, {MOTION_PARITY}", imgs[DEVICE],
                                  imgs["cpu"]))
    return res, k7_res, k2_sppm


FUR_CURVES = 4096  # x 96 triangles at tessellation 8 x 6: 393,216 curve triangles
FUR = dict(xres=256, yres=256, spp=4, maxdepth=8)  # 8 spp before phase 19
FUR_BATCH = 1 << 18  # one chunk
FUR_SWEEPS = 8 + 7  # one chunk: 8 closest + 7 shadow at maxdepth 8
FUR_STRIDE = 4  # every 4th sweep checked against the plain walk
FUR_PARITY = dict(xres=16, yres=16, spp=1, maxdepth=4)  # 32x32 before phase 19
FEATURE_BATCH = 1 << 18  # (b) and (c): 2 chunks of config 3
FEATURE_SWEEPS = 2 * (4 + 3)  # 2 chunks x (4 closest + 3 shadow) at maxdepth 4
FOURIER = dict(xres=256, yres=256, spp=8, maxdepth=4)  # phase 4's config 3
FOURIER_TABLE = dict(n_mu=64, orders=8)
SPECTRAL = dict(xres=256, yres=256, spp=8, maxdepth=4)  # phase 4's config 3
SPECTRAL_BINS = 15  # --sampled-spectrum: Options.n_spectral_bins, 5 passes of 3 bins
FEATURE_PARITY = dict(xres=16, yres=16, spp=2, maxdepth=3)  # (b), (c): card against CPU (32x32 before phase 19)
BDPT_GRAD = dict(xres=256, yres=256, spp=4, maxdepth=4)  # phase 15's config 3 at 4 spp
BDPT_GRAD_PROBE = 4096  # pixels of the steps that size the batch
BDPT_GRAD_MEMORY = 40 * 2**30  # the step's peak must stay below this
BDPT_GRAD_PARITY = dict(xres=16, yres=16, spp=1, maxdepth=3)


def phase_features(card):
    """Phase 17: hair and fur, the fourier BSDF, sampled-spectrum rendering
    and BDPT gradients through the pbrt command (scene files under
    ``build/chip_smoke/``).  Returns (the numbers, K2's on the fur ball)."""
    import os

    import numpy as np
    import torch

    from pbrt_tpu_torch.testscenes import (config3_scenefile, fur_text, glossy_fourier_table,
                                           write_torus_ply)

    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    ply = f"{d}/torus.ply"
    write_torus_ply(ply)
    res = {}

    def parity(label, path, renders=1):
        imgs, seconds = {}, {}
        for dev in (DEVICE, "cpu"):
            t0 = time.time()
            imgs[dev] = cli_render(
                [path, "-o", path.replace(".pbrt", f"_{dev}.pfm"), "-q"]
                + (["--sampled-spectrum"] if renders > 1 else []), device=dev, renders=renders)[0]["image"]
            seconds[dev] = time.time() - t0
        log(f"  {label}: card {seconds[DEVICE]:.1f} s, cpu {seconds['cpu']:.1f} s with the "
            "builds")
        return compare_images(label, imgs[DEVICE], imgs["cpu"])

    log(f"== phase 17 (a): a fur ball of {FUR_CURVES} curves under a hair material through "
        f"cli.main, {FUR}, ray_batch {FUR_BATCH}")
    with open(f"{d}/fur.pbrt", "w") as f:
        f.write(fur_text(FUR_CURVES, **FUR, filename=f"{d}/fur.pfm"))
    got, build_s, launches = cli_render([f"{d}/fur.pbrt", "--ray-batch", str(FUR_BATCH), "-q"])
    r = got["renderer"]
    tris = int(r.compiled.tri_data.count)
    curve_tris = int((np.abs(r.compiled.tri_data.tan0).sum(axis=-1) > 0).sum())
    log(f"  cli.main: build {build_s:.2f} s ({tris} triangles, {curve_tris} of them curve "
        f"triangles), first frame {got['seconds']:.3f} s")
    if curve_tris != FUR_CURVES * 96:
        raise AssertionError(f"the fur ball has {curve_tris} curve triangles")
    frame, k2 = k2_frame("the fur ball", r, FUR_SWEEPS, card,
                         first=(got["seconds"], launches, got["image"]), plain_stride=FUR_STRIDE)
    frame["profile"] = phase_profile("fur-ball", r, frame["frame_s"])
    del got, r
    with open(f"{d}/fur_small.pbrt", "w") as f:
        f.write(fur_text(FUR_CURVES, **FUR_PARITY))
    frame["parity"] = parity(f"the fur ball, {FUR_PARITY}", f"{d}/fur_small.pbrt")
    res["fur"] = dict(curves=FUR_CURVES, triangles=tris, build_s=build_s, launches=launches,
                      **frame)

    log(f"== phase 17 (b): config 3's torus under Material \"fourier\" ({FOURIER_TABLE}, "
        f"written by FourierTable.write) through cli.main, {FOURIER}")
    glossy_fourier_table(**FOURIER_TABLE).write(f"{d}/glossy.bsdf")
    material = f'Material "fourier" "string bsdffile" "{d}/glossy.bsdf"'
    config3_scenefile(f"{d}/fourier.pbrt", ply, **FOURIER, material=material)
    got, build_s, launches = cli_render([f"{d}/fourier.pbrt", "--ray-batch",
                                         str(FEATURE_BATCH), "-o", f"{d}/fourier.pfm", "-q"])
    r = got["renderer"]
    img = got["image"]
    log(f"  cli.main: build {build_s:.2f} s, first frame {got['seconds']:.3f} s, launches "
        f"{launches}; image mean {img.mean():.6f}")
    if launches != {"stream_walk8": FEATURE_SWEEPS}:
        raise AssertionError(f"the fourier frame launched {launches}, want stream_walk8 x "
                             f"{FEATURE_SWEEPS}")
    if not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError("the fourier image is not finite or all black")
    median, times = timed(lambda: r.image(r.render()))
    log(f"  fourier frame {median:.4f} s ({[round(x, 4) for x in times]}) on {card}")
    res["fourier"] = dict(build_s=build_s, launches=launches, first_frame_s=got["seconds"],
                          frame_s=median, frames_s=times, card=card)
    del got, r
    config3_scenefile(f"{d}/fourier_small.pbrt", ply, **FEATURE_PARITY, material=material)
    res["fourier"]["parity"] = parity(f"fourier, {FEATURE_PARITY}",
                                      f"{d}/fourier_small.pbrt")

    log(f"== phase 17 (c): config 3 sampled-spectrum through cli.main --sampled-spectrum, "
        f"{SPECTRAL_BINS} bins ({SPECTRAL_BINS // 3} passes), {SPECTRAL}")
    config3_scenefile(f"{d}/spectral.pbrt", ply, **SPECTRAL)
    passes = SPECTRAL_BINS // 3
    torch.cuda.synchronize()
    t0 = time.time()
    got, build_s, launches = cli_render(
        [f"{d}/spectral.pbrt", "--ray-batch", str(FEATURE_BATCH), "--sampled-spectrum",
         "-o", f"{d}/spectral.pfm", "-q"],
        renders=passes + 1)
    wall = time.time() - t0
    img = got["image"]
    log(f"  cli.main: {passes} passes in {got['seconds']:.3f} s ({wall:.3f} s with the parse "
        f"and the image write), {build_s:.2f} s of it in the {passes} builds; launches "
        f"{launches}; image mean {img.mean(axis=(0, 1))}")
    if launches != {"stream_walk8": FEATURE_SWEEPS * passes}:
        raise AssertionError(f"the spectral render launched {launches}, want stream_walk8 x "
                             f"{FEATURE_SWEEPS * passes}")
    if not (np.isfinite(img).all() and img.max() > 0) or not os.path.exists(f"{d}/spectral.pfm"):
        raise AssertionError("the spectral image is not finite, all black or not written")
    res["spectral"] = dict(bins=SPECTRAL_BINS, passes=passes, render_s=got["seconds"],
                           wall_s=wall, build_s=build_s, launches=launches,
                           image_mean=img.mean(axis=(0, 1)).tolist(), card=card)
    del got
    config3_scenefile(f"{d}/spectral_small.pbrt", ply, **FEATURE_PARITY)
    res["spectral"]["parity"] = parity(f"sampled-spectrum, {FEATURE_PARITY}",
                                       f"{d}/spectral_small.pbrt", renders=passes + 1)

    res["bdpt_gradients"] = phase_bdpt_grad(card, d, ply)
    return res, k2


def phase_bdpt_grad(card, d, ply):
    """Phase 17 (d): one BDPT loss-and-gradient step on config 3 as a scene
    file against a target rendered with the floor's kd changed, at 4 spp
    over the largest power-of-two batch of pixels, up to all 65,536, whose
    step stays below BDPT_GRAD_MEMORY (sized from a 4,096-pixel step with
    and without remat, which must agree: BDPT ignores remat); forward and
    forward+backward seconds, K2's launches in each, peak memory, every
    leaf finite, the floor's kd against a central finite difference; every
    leaf card against CPU at 16x16."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, render_image_diff, value_and_grad
    from pbrt_tpu_torch.testscenes import config3_scenefile

    spp = BDPT_GRAD["spp"]
    log(f"== phase 17 (d): a BDPT gradient step on config 3 as a scene file, {BDPT_GRAD}, the "
        "floor's kd changed in the target")

    def step(r, target, theta, px, remat=True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value, g = value_and_grad(make_loss_fn(r, target, spp, remat=remat), theta, px)
        torch.cuda.synchronize()
        return value, g, torch.cuda.max_memory_allocated() - base

    config3_scenefile(f"{d}/bdpt_grad.pbrt", ply, **BDPT_GRAD, integrator="bdpt")
    r = file_renderer(f"{d}/bdpt_grad.pbrt", DEVICE)
    theta = r.compiled.initial_theta()
    if theta["kd"][FLOOR].tolist() != [0.4000000059604645, 0.4000000059604645,
                                       0.41999998688697815]:
        raise AssertionError(f"material row {FLOOR} is not the floor")
    t_theta = dict(theta, kd=theta["kd"].clone())
    t_theta["kd"][FLOOR] += torch.tensor([0.1, -0.08, 0.05], device=DEVICE)
    with torch.no_grad():
        target = render_image_diff(r, t_theta, spp=spp, batch=PIXELS).cpu().numpy()
    all_px = torch.as_tensor(r.film.cropped_pixel_bounds.offsets(), device=DEVICE)

    probe = all_px[:BDPT_GRAD_PROBE]
    _, g_on, peak_on = step(r, target, theta, probe, remat=True)
    _, g_off, peak_off = step(r, target, theta, probe, remat=False)
    on, off = dict(grad_leaves(g_on)), dict(grad_leaves(g_off))
    worst = max(float((v - on[k]).abs().max()) if v.numel() else 0.0 for k, v in off.items())
    scale = max(float(v.abs().max()) for v in on.values() if v.numel())
    log(f"  {BDPT_GRAD_PROBE} pixels: peak above the base {peak_on / 2**30:.3f} GiB with remat, "
        f"{peak_off / 2**30:.3f} GiB without; max |diff| of the gradients {worst:.3e} of "
        f"{scale:.3e}")
    if worst > 1e-6 * scale:
        raise AssertionError("bdpt gradients with and without remat differ")
    del g_on, g_off, on, off
    n = len(all_px)
    while n > BDPT_GRAD_PROBE and peak_on * n / BDPT_GRAD_PROBE > 0.8 * BDPT_GRAD_MEMORY:
        n //= 2
    px = all_px[:n]
    # li (the gradients' radiance) takes no light-tracing strategy: one
    # sweep fewer per s = 2..s_max than queries_per_sample counts
    bd = r.integrator
    closest, shadow = bd.queries_per_sample()
    sweeps = closest + shadow - (bd.s_max - 1) * int(bd.enable_t0 and bd._has_traceable_lights())
    loss = make_loss_fn(r, target, spp)
    fwd, bwd = {}, {}

    def counted(t, pixels):
        reset_counts()
        value = loss(t, pixels)
        torch.cuda.synchronize()
        fwd.update(read_counts())
        reset_counts()
        return value

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    value, grads = value_and_grad(counted, theta, px)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bwd.update(read_counts())
    fwd_l = {k: v for k, v in fwd.items() if v}
    bwd_l = {k: v for k, v in bwd.items() if v}
    log(f"  {n} pixels ({spp} spp): loss {float(value):.6e}; launches forward {fwd_l}, "
        f"backward {bwd_l}; peak {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} above the "
        f"{base / 2**30:.3f} GiB held before)")
    if fwd_l != {"stream_walk8": sweeps * spp} or bwd_l:
        raise AssertionError(f"the bdpt step launched {fwd_l} forward and {bwd_l} backward")
    if peak >= BDPT_GRAD_MEMORY:
        raise AssertionError(f"the bdpt step's peak {peak} is above {BDPT_GRAD_MEMORY}")
    for k, v in grad_leaves(grads):
        if not torch.isfinite(v).all():
            raise AssertionError(f"bdpt gradient {k} not finite")
    kept = dict(grad_leaves(grads))
    del grads
    log(f"  floor kd gradient {kept['kd'][FLOOR].tolist()}; area light "
        f"{kept['area_l'].tolist()}")
    with torch.no_grad():
        fwd_s, fwd_all = timed(lambda: loss(theta, px))
    step_s, step_all = timed(lambda: value_and_grad(loss, theta, px))
    log(f"  forward {fwd_s:.4f} s ({[round(x, 4) for x in fwd_all]}), forward+backward "
        f"{step_s:.4f} s ({[round(x, 4) for x in step_all]}), median of three, on {card}")
    fd = fd_check("bdpt on config 3", loss, theta, "kd", (FLOOR, 0),
                  float(kept["kd"][FLOOR, 0]), (px,))
    out = dict(pixels=n, spp=spp, loss=float(value), forward_s=fwd_s, forward_all_s=fwd_all,
               forward_backward_s=step_s, forward_backward_all_s=step_all, peak_bytes=peak,
               above_base_bytes=peak - base, probe_pixels=BDPT_GRAD_PROBE,
               probe_peak_bytes=dict(remat_true=peak_on, remat_false=peak_off),
               k2_launches_forward=fwd_l["stream_walk8"], k2_launches_backward=0,
               floor_kd_grad=kept["kd"][FLOOR].tolist(), fd=fd, card=card)
    del r, kept, loss

    config3_scenefile(f"{d}/bdpt_grad_small.pbrt", ply, **BDPT_GRAD_PARITY, integrator="bdpt")
    grads = {}
    for dev in (DEVICE, "cpu"):
        rr = file_renderer(f"{d}/bdpt_grad_small.pbrt", dev)
        bb = rr.film.cropped_pixel_bounds
        lf = make_loss_fn(rr, np.full((bb.height, bb.width, 3), 0.05, np.float32),
                          spp=BDPT_GRAD_PARITY["spp"])
        _, grads[dev] = value_and_grad(lf, rr.compiled.initial_theta(),
                                       torch.as_tensor(bb.offsets(), device=dev))
    out["parity_max_rel_to_scale"] = compare_grads(f"bdpt, {BDPT_GRAD_PARITY}", grads[DEVICE],
                                                   grads["cpu"])
    log(f"  {BDPT_GRAD_PARITY}: every leaf equal, max |card - cpu| "
        f"{out['parity_max_rel_to_scale']:.3e} of the largest magnitude")
    return out


SWITCHES = {  # phase 18 (a): Renderer arguments -> the reference's variables
    "sorted": {},
    "unsorted": dict(shadow_sort="unsorted"),  # PBRT_TPU_SC_NOSORT_SHADOW=1
    "merged": dict(shadow_sort="merged"),  # PBRT_TPU_SC_MERGED=1
    "no_sorted_carry": dict(sorted_carry=False),  # PBRT_TPU_NO_SORTED_CARRY=1
    "no_deadbit": dict(deadbit=False),  # PBRT_TPU_NO_DEADBIT=1
    "key_obits4": dict(key_obits=4),  # PBRT_TPU_KEY_OBITS=4
}
SHARD_RANKS = 4  # (c), (e), (f): gloo ranks sharing the one card
SHARD_GRAD_PIXELS = 4096  # (c), (d): the step's pixels (the film's first 16 rows)
SHARD_GRAD_SAMPLES = 2  # (c), (d): samples a pixel, over sp
GEOM = dict(res=256, spp=4, max_depth=4)  # (e), (f): config 5's frame; (f): 65,536 pixels
GEOM_CAMERA = dict(eye=(2.8, 2.2, 2.8), look=(0.0, 0.0, 0.0), up=(0, 0, 1), fov=45.0)
SKIP_RANKS = 2  # (g)
SKIP = dict(res=256, spp=1, max_depth=3)  # (g)
SKIP_TORUS = dict(nu=224, nv=112)  # (g): config 3's 50,180 triangles
WORLD_TIMEOUT_S = 420
WORLD1_BACKEND = "nccl"  # (d)


def _compare_np_grads(label, got, want):
    import torch

    return compare_grads(label, {k: torch.as_tensor(v) for k, v in got.items()},
                         {k: torch.as_tensor(v) for k, v in want.items()})


def _check_loss(label, got, want):
    rel = abs(got - want) / max(abs(want), 1e-30)
    log(f"  {label}: loss {got:.6e} against {want:.6e}, rel diff {rel:.3e}")
    if rel > 1e-4:
        raise AssertionError(f"{label}: loss {got} against {want}")
    return rel


def frame_device_ms(r):
    """One frame's K2 sweeps and ``co_sort`` calls, each recorded and then
    timed alone on the card (CUDA events, mean of 20 after one) -> (K2 ms
    summed over the closest-hit sweeps, over the shadow sweeps, the sorts'
    ms summed, the number of sorts)."""
    import torch

    from pbrt_tpu_torch.integrators import path
    from pbrt_tpu_torch.ops import sortnet

    walk = r.compiled.intersector.walk
    sweeps = record_walks(r)
    sorts, orig = [], sortnet.co_sort

    def recording(operands, network="stable"):
        sorts.append((tuple(x.clone() for x in operands), network))
        return orig(operands, network)

    sortnet.co_sort = path.co_sort = recording
    try:
        r.render()
        torch.cuda.synchronize()
    finally:
        sortnet.co_sort = path.co_sort = orig
    k2 = {False: 0.0, True: 0.0}
    for o, d, t_max, any_hit in sweeps:
        fn, args, kw = kernel_call("stream_walk8", walk, o, d, t_max, any_hit)
        k2[any_hit] += cuda_ms(lambda: fn(*args, **kw), 20)
    sort_ms = 0.0
    for ops, network in sorts:
        sort_ms += cuda_ms(lambda: orig(ops, network), 20)
    return k2[False], k2[True], sort_ms, len(sorts)


def shard_walk(shard):
    """One rank's shard tables (``geomshard.local_shard``) as the walk that
    ``walk_call`` reads: K2's packed cluster tables or K6's skip-link rows."""
    from types import SimpleNamespace

    if shard["kind"] == "packed":
        return SimpleNamespace(nodes=shard["pk_nodes"], tris=shard["pk_tris"],
                               roots=shard["pk_roots"], cl_min=shard["pk_clmin"],
                               cl_max=shard["pk_clmax"], depth=shard["depth"])
    return SimpleNamespace(nodes_f=shard["sk_nodes_f"], nodes_i=shard["sk_nodes_i"],
                           tris=shard["sk_tris"])


def _shard_sweeps(name, label, shard_file, sweeps):
    """Phase 18's per-shard kernel checks, made here after the world has
    exited, so that no other rank shares the card: one rank's recorded
    sweeps (numpy o, d, t_max) on its shard tables (``shard_file``, loaded
    onto the card) through ``check_walk``, then timed alone by
    ``time_walks`` -> the kernel's JSON entry."""
    import numpy as np
    import torch

    from pbrt_tpu_torch.parallel.geomshard import local_shard

    with np.load(shard_file) as z:
        walk = shard_walk(local_shard({k: z[k] for k in z.files}, 0, DEVICE))
    checked = [check_walk(name, f"{label}, sweep {i}", walk,
                          *(torch.as_tensor(x, device=DEVICE) for x in sw), False)
               for i, sw in enumerate(sweeps)]
    errs, calls, works, stats, plain = zip(*checked)
    ms, plain_ms, dev = time_walks(name, calls, stats, plain)
    b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]))
    log(f"  {name} on {label}: {len(sweeps)} sweeps of {[len(sw[0]) for sw in sweeps]} rays, "
        f"each equal to its plain version, max |dt| {max(errs):.3e}; kernel mean "
        f"{np.mean(ms):.4f} ms ({min(ms):.4f}-{max(ms):.4f}), bound {b_ms:.5f} ms ({b_by}), "
        f"{b_ms / np.mean(ms):.2%} of it")
    entry = dict(max_abs_err=max(errs), ms=float(np.mean(ms)), sweep_ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, sweeps=len(sweeps),
                 sweep_live=[st[0] for st in stats])
    if dev is not None:
        entry["sweep_device_ms"] = dev
    return entry


def phase_sharded(card, default_image=None):
    """Phase 18: the sort switches, and the sharded paths in spawned
    worlds (``parallel/multihost.run_local_world``) on the one card."""
    import tempfile

    import torch

    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    out, k2, k6 = {"card": card}, {}, {}
    cfg3 = SCENES["config3"]
    log(f"== phase 18 (a): the sort switches on config 3 ({cfg3})")
    images, times, launches, rs = {}, {name: [] for name in SWITCHES}, {}, {}
    for name, sw in SWITCHES.items():
        r = rs[name] = mesh_scene_renderer(**cfg3, device=DEVICE, **sw)[0]
        torch.cuda.synchronize()
        reset_counts()
        images[name] = r.image(r.render())
        launches[name] = {k: v for k, v in read_counts().items() if v}
        closest, shadow = r.integrator.queries_per_sample()
        want = {"stream_walk8": (closest + shadow) * frame_chunks(r)}
        log(f"  {name} {sw}: launches {launches[name]}")
        if launches[name] != want:
            raise AssertionError(f"{name}: launches {launches[name]}, want {want}")
    for _ in range(3):  # frames taken in turns, as phase 6's
        for name, r in rs.items():
            times[name].append(timed(lambda: r.image(r.render()), reps=1)[0])
    frames = {name: (sorted(t)[1], t) for name, t in times.items()}
    for name in SWITCHES:
        log(f"  {name}: frame {frames[name][0]:.4f} s ({[round(x, 4) for x in frames[name][1]]})"
            f", median of three taken in turns, on {card}")
    log("  device ms a frame, each recorded K2 sweep and co_sort timed alone (CUDA events, "
        "mean of 20 after one)")
    device_ms = {}
    for name in ("sorted", "unsorted", "merged"):
        k2_c, k2_s, sort_ms, n_sorts = frame_device_ms(rs[name])
        device_ms[name] = dict(k2_closest_ms=k2_c, k2_shadow_ms=k2_s, sorts_ms=sort_ms,
                               sorts=n_sorts, total_ms=k2_c + k2_s + sort_ms)
        log(f"  {name}: K2 closest {k2_c:.4f} ms, K2 shadow {k2_s:.4f} ms, {n_sorts} co_sorts "
            f"{sort_ms:.4f} ms, together {k2_c + k2_s + sort_ms:.4f} ms, on {card}")
    del rs
    base = images["sorted"] if default_image is None else default_image
    out["switches"] = {
        name: dict(frame_s=frames[name][0], frames_s=frames[name][1], launches=launches[name],
                   **({"device_ms": device_ms[name]} if name in device_ms else {}),
                   parity=compare_images(f"{name} against the default image", images[name],
                                         base, ("default", name)))
        for name in SWITCHES}
    default_image = images["sorted"] if default_image is None else default_image

    log("== phase 18 (b): the 24x24 torus (1,156 triangles) under stream_min_tris=512")
    small = SCENES["small"]
    imgs = {}
    for label, kw in (("whole tree", {}), ("stream_min_tris=512", dict(stream_min_tris=512))):
        r, _ = mesh_scene_renderer(**small, device=DEVICE, **kw)
        reset_counts()
        imgs[label] = r.image(r.render())
        got = {k: v for k, v in read_counts().items() if v}
        log(f"  {label}: {type(r.compiled.intersector.walk).__name__}, launches {got}")
        want = {"wide_walk8": 7} if not kw else {"stream_walk8": 7}
        if got != want:
            raise AssertionError(f"small torus, {label}: launches {got}, want {want}")
    out["stream_min_tris"] = dict(launches=got, parity=compare_images(
        "the small torus, streaming against whole tree", imgs["stream_min_tris=512"],
        imgs["whole tree"], ("whole tree", "streaming")))

    log("== phase 18: building config 5's shard tables (tp=4 and tp=1, packed)")
    Path(SCENEFILE_DIR).mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="shards_", dir=SCENEFILE_DIR)
    try:
        return _phase_sharded_worlds(card, default_image, out, k2, k6, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _phase_sharded_worlds(card, default_image, out, k2, k6, tmp):
    """Phase 18 (c)-(g), with config 5's shard tables saved under ``tmp``."""
    import functools

    import numpy as np
    import torch

    from pbrt_tpu_torch.diff.grad import make_loss_fn, render_image_diff, value_and_grad
    from pbrt_tpu_torch.parallel import worlds
    from pbrt_tpu_torch.parallel.geomshard import shard_triangle_arrays
    from pbrt_tpu_torch.parallel.multihost import run_local_world
    from pbrt_tpu_torch.testscenes import mesh_scene_renderer

    cfg3 = SCENES["config3"]
    t0 = time.time()
    scene5 = worlds.config5_scene(CONFIG5["nu"], CONFIG5["nv"])
    files = {}
    for tp in (SHARD_RANKS, 1):
        tables = shard_triangle_arrays(*scene5, tp, packed=True)
        files[(tp, "packed")] = worlds.save_shards(tables, f"{tmp}/tp{tp}")
        if tp == SHARD_RANKS:
            shard_info = dict(clusters=int(tables["pk_nodes"].shape[1]),
                              node_rows=int(tables["pk_nodes"].shape[2]),
                              leaf_rows=int(tables["pk_tris"].shape[2]),
                              per_shard=int(tables["p0"].shape[1]))
        del tables
    build_s = time.time() - t0
    log(f"  {scene5[0].count} triangles; tables built and saved in {build_s:.2f} s; tp="
        f"{SHARD_RANKS} shard tables {shard_info}")
    out["config5_shards"] = dict(triangles=int(scene5[0].count), build_s=build_s, **shard_info)
    del scene5

    # the single-card references of (c) and (d): the step's target (the
    # floor's kd changed) and make_loss_fn's loss and gradient
    r3, _ = mesh_scene_renderer(**cfg3, device=DEVICE)
    theta = r3.compiled.initial_theta()
    t_theta = dict(theta, kd=theta["kd"].clone())
    t_theta["kd"][FLOOR] += torch.tensor([0.1, -0.08, 0.05], device=DEVICE)
    with torch.no_grad():
        target = render_image_diff(r3, t_theta, spp=SHARD_GRAD_SAMPLES).cpu().numpy()
    px = torch.as_tensor(r3.film.cropped_pixel_bounds.offsets()[:SHARD_GRAD_PIXELS],
                         device=DEVICE)
    value, g = value_and_grad(make_loss_fn(r3, target, spp=SHARD_GRAD_SAMPLES), theta, px)
    single_loss, single_grads = float(value), worlds.flat_leaves(g)
    del r3, g

    renderer_fn = functools.partial(worlds.scene_renderer, **cfg3)
    sharding_kw = dict(renderer_fn=renderer_fn, spp=cfg3["spp"], grad_samples=SHARD_GRAD_SAMPLES,
                       grad_pixels=SHARD_GRAD_PIXELS, grad_target=target)
    geom_kw = dict(res=GEOM["res"], spp=GEOM["spp"], max_depth=GEOM["max_depth"],
                   camera=GEOM_CAMERA, n_mats=3, shard_files=files)

    log(f"== phase 18 (c), (e), (f): a world of {SHARD_RANKS} gloo ranks on the one card")
    cases4 = [(1, SHARD_RANKS, "packed", "allreduce"), (1, SHARD_RANKS, "packed", "ring")]
    grads4 = [(1, SHARD_RANKS, "packed", True), (1, SHARD_RANKS, "packed", False)]
    t0 = time.time()
    world4 = run_local_world(worlds.rank_tasks, SHARD_RANKS, backend="gloo", device=DEVICE,
                             timeout_s=WORLD_TIMEOUT_S, args=([
                                 (worlds.rank_sharding, dict(sharding_kw, meshes=((2,),))),
                                 (worlds.rank_geomshard, dict(geom_kw, cases=cases4,
                                                              grad_cases=grads4, record_rank=0)),
                             ],))
    world4_s = time.time() - t0
    log(f"  the world ran in {world4_s:.1f} s (spawn, builds and every case)")

    log("== phase 18 (d), and the tp=1 references of (e), (f): a world of 1 under nccl")
    t0 = time.time()
    world1 = run_local_world(worlds.rank_tasks, 1, backend=WORLD1_BACKEND, device=DEVICE,
                             timeout_s=WORLD_TIMEOUT_S, args=([
                                 (worlds.rank_sharding, dict(sharding_kw, meshes=((1,),))),
                                 (worlds.rank_geomshard, dict(
                                     geom_kw, cases=[(1, 1, "packed", "allreduce")],
                                     grad_cases=[(1, 1, "packed", True)])),
                             ],))
    world1_s = time.time() - t0
    log(f"  the world ran in {world1_s:.1f} s")

    for label, world, sp in (("(c) dp=2 sp=2, 4 gloo ranks", world4, 2),
                             ("(d) dp=1 sp=1, 1 nccl rank", world1, 1)):
        res = [w[0] for w in world]
        img = res[0]["images"][sp]
        for rr in res[1:]:
            if not np.array_equal(rr["images"][sp], img):
                raise AssertionError(f"{label}: ranks hold different films")
        per_rank = [rr["launches"][sp]["stream_walk8"] for rr in res]
        chunks = -(-cfg3["spp"] // sp)  # one 65,536-pixel chunk a round
        if per_rank != [chunks * 7] * len(res):
            raise AssertionError(f"{label}: stream_walk8 launches per rank {per_rank}")
        log(f"  {label}: ShardedRenderer.render {[round(rr['seconds'][sp], 4) for rr in res]} s "
            f"per rank (the ranks start together: the render's whole time is the longest); "
            f"stream_walk8 {per_rank} per rank")
        entry = dict(render_s=[rr["seconds"][sp] for rr in res],
                     render_whole_s=max(rr["seconds"][sp] for rr in res), k2_launches=per_rank,
                     parity=compare_images(f"{label} against phase 4's default image", img,
                                           default_image, ("single card", "sharded")))
        loss_rel = _check_loss(f"{label} grad step against make_loss_fn", res[0]["loss"],
                               single_loss)
        worst = _compare_np_grads(f"{label} grad step", res[0]["grads"], single_grads)
        log(f"  {label}: grad step {[round(rr['grad_seconds'], 4) for rr in res]} s per rank, "
            f"stream_walk8 {[rr['grad_launches']['stream_walk8'] for rr in res]} per rank; "
            f"every leaf within rtol 1e-3 of make_loss_fn's (max {worst:.3e} of the largest)")
        entry.update(grad_s=[rr["grad_seconds"] for rr in res], grad_loss_rel=loss_rel,
                     grad_max_rel_to_scale=worst,
                     grad_k2_launches=[rr["grad_launches"]["stream_walk8"] for rr in res])
        out["sharded_renderer_" + ("gloo4" if sp == 2 else "nccl1")] = entry
    out["world_s"] = dict(gloo4=world4_s, nccl1=world1_s)

    g4 = [w[1] for w in world4]
    g1 = world1[0][1]
    ref_case = (1, 1, "packed", "allreduce")
    ref_img = g1["images"][ref_case]
    log(f"  (e) transports: {g4[0]['transport']}")
    geo = {"transport": g4[0]["transport"]}
    for case in cases4:
        img = g4[0]["images"][case]
        for rr in g4[1:]:
            if not np.array_equal(rr["images"][case], img):
                raise AssertionError(f"(e) {case}: ranks hold different films")
        per_rank = [rr["launches"][case]["stream_walk8"] for rr in g4]
        want = GEOM["max_depth"] * (SHARD_RANKS if case[3] == "ring" else 1)
        if per_rank != [want] * SHARD_RANKS:
            raise AssertionError(f"(e) {case}: stream_walk8 launches per rank {per_rank}, "
                                 f"want {want}")
        log(f"  (e) {case[3]}: {[round(rr['seconds'][case], 4) for rr in g4]} s per rank, "
            f"stream_walk8 {per_rank} per rank")
        geo[case[3]] = dict(seconds=[rr["seconds"][case] for rr in g4], k2_launches=per_rank,
                            parity=compare_images(f"(e) tp={SHARD_RANKS} {case[3]} against "
                                                  "tp=1", img, ref_img, ("tp=1", "tp=4")))
    log(f"  (e) the tp=1 image: mean {ref_img.mean():.6f}, max {ref_img.max():.4f}")
    geo["ring_vs_allreduce"] = compare_images(
        "(e) ring against allreduce", g4[0]["images"][cases4[1]], g4[0]["images"][cases4[0]],
        ("allreduce", "ring"))
    geo["tp1"] = dict(seconds=g1["seconds"][ref_case],
                      k2_launches=g1["launches"][ref_case]["stream_walk8"])
    k2.update(_shard_sweeps("stream_walk8", f"rank 0's shard of config 5 (tp={SHARD_RANKS}, "
                            "allreduce)", files[(SHARD_RANKS, "packed")][0],
                            g4[0]["sweeps"]["packed"]))
    k2["launches_per_rank"] = {c[3]: geo[c[3]]["k2_launches"] for c in cases4}
    out["geomshard"] = geo

    log(f"== phase 18 (f): make_sharded_grad_fn at {GEOM['res'] ** 2} pixels, tp="
        f"{SHARD_RANKS} against tp=1")
    ref = g1["grads"][(1, 1, "packed", True)]
    gr = {}
    for case in grads4:
        got = g4[0]["grads"][case]
        loss_rel = _check_loss(f"(f) remat={case[3]}", got["loss"], ref["loss"])
        worst = _compare_np_grads(f"(f) remat={case[3]}", got["grads"], ref["grads"])
        e = gr[f"remat_{str(case[3]).lower()}"] = dict(
            loss=got["loss"], loss_rel=loss_rel, max_rel_to_scale=worst,
            seconds=[rr["grads"][case]["seconds"] for rr in g4],
            k2_launches=[rr["grads"][case]["launches"]["stream_walk8"] for rr in g4],
            peak_bytes=[rr["grads"][case]["peak_bytes"] for rr in g4])
        log(f"  remat={case[3]}: {[round(x, 4) for x in e['seconds']]} s per rank, "
            f"stream_walk8 {e['k2_launches']} per rank, peak bytes {e['peak_bytes']} per rank; "
            f"every leaf within rtol 1e-3 of tp=1's (max {worst:.3e} of the largest)")
    on, off = gr["remat_true"]["k2_launches"], gr["remat_false"]["k2_launches"]
    if not all(b == GEOM["max_depth"] < a for a, b in zip(on, off)):
        raise AssertionError(f"(f) stream_walk8 launches with remat {on}, without {off}: the "
                             "replay must launch it")
    gr["tp1"] = dict(loss=ref["loss"], seconds=ref["seconds"], peak_bytes=ref["peak_bytes"])
    out["sharded_grad"] = gr
    k2["grad_launches_per_rank"] = dict(remat_true=on, remat_false=off)

    log(f"== phase 18 (g): a world of {SKIP_RANKS} gloo ranks with skip-link shards of config "
        f"3's triangles ({SKIP})")
    cases2 = [(1, SKIP_RANKS, "skip", "allreduce"), (1, SKIP_RANKS, "skip", "ring"),
              (1, SKIP_RANKS, "packed", "allreduce")]
    skip_scene = functools.partial(worlds.config5_scene, **SKIP_TORUS)
    skip_files = worlds.save_shards(shard_triangle_arrays(*skip_scene(), SKIP_RANKS, bvh=True),
                                    f"{tmp}/skip{SKIP_RANKS}")
    t0 = time.time()
    world2 = [w[0] for w in run_local_world(
        worlds.rank_tasks, SKIP_RANKS, backend="gloo", device=DEVICE, timeout_s=WORLD_TIMEOUT_S,
        args=([(worlds.rank_geomshard, dict(
            SKIP, cases=cases2, camera=GEOM_CAMERA, record_rank=0, n_mats=3, scene=skip_scene,
            shard_files={(SKIP_RANKS, "skip"): skip_files}))],))]
    log(f"  the world ran in {time.time() - t0:.1f} s")
    per_rank = {c[3] + "_" + c[2]: [rr["launches"][c] for rr in world2] for c in cases2}
    log(f"  launches per rank: {per_rank}")
    for c in cases2[:2]:
        want = SKIP["max_depth"] * (SKIP_RANKS if c[3] == "ring" else 1)
        if [rr["launches"][c]["skip_walk"] for rr in world2] != [want] * SKIP_RANKS:
            raise AssertionError(f"(g) {c}: skip_walk launches {per_rank}")
    k6.update(_shard_sweeps("skip_walk", f"rank 0's skip-link shard (tp={SKIP_RANKS}, "
                            "allreduce)", skip_files[0], world2[0]["sweeps"]["skip"]))
    k6["launches_per_rank"] = {c[3]: [rr["launches"][c]["skip_walk"] for rr in world2]
                               for c in cases2[:2]}
    out["skip_shards"] = dict(
        seconds={c[3] + "_" + c[2]: world2[0]["seconds"][c] for c in cases2},
        skip_vs_packed=compare_images("(g) skip-link shards against packed ones",
                                      world2[0]["images"][cases2[0]],
                                      world2[0]["images"][cases2[2]], ("packed", "skip")),
        ring_vs_allreduce=compare_images("(g) skip ring against allreduce",
                                         world2[0]["images"][cases2[1]],
                                         world2[0]["images"][cases2[0]], ("allreduce", "ring")))
    return out, k2, k6


DOUBLE_RTOL = 1e-12  # K7<double> against its plain version (fma against two roundings)
DOUBLE_CORNELL_PARITY = dict(xres=32, yres=32, spp=2, maxdepth=5)  # phase 8's Cornell
REF_BOX = dict(xres=16, yres=16, spp=4, maxdepth=4)  # tests/test_refrender.py's GI box
# tests/test_torch_refrender.py's bounds on the GI box: (pixels off by more
# than 0.02, |mean difference|[, pixels off by more than 2e-6])
REF_BOX_BOUNDS = {False: (0.03, 5e-3), True: (0.01, 1e-3, 0.08)}


def phase_double(card):
    """Phase 19: the float64 policy.  (a) config 3 in double (K2 x 14,
    every sweep checked, the image against float32's, frames in turns);
    (b) phase 16 (a)'s config 3 in motion, in double through ``cli.main
    --double`` (K7's double instance x 14, every 5th sweep against its
    plain version, every sweep timed, its bound at the FP64 rate); (c)
    Cornell in double (frame seconds; 32x32 card against CPU); (d) the GI
    box in float32 and double against ``refrender.py``.
    Returns (the numbers, K7<double>'s kernel entry)."""
    import os

    import numpy as np
    import torch

    from pbrt_tpu_torch import Options
    from pbrt_tpu_torch.core.api import PbrtAPI
    from pbrt_tpu_torch.refrender import RefScene, look_at, render_reference
    from pbrt_tpu_torch.render import Renderer
    from pbrt_tpu_torch.testscenes import (config3_scenefile, cornell_renderer,
                                           mesh_scene_renderer, ref_gi_box, sample_table,
                                           write_torus_ply)

    res = {}
    log(f"== phase 19 (a): config 3 in double, {SCENES['config3']}")
    rd = mesh_scene_renderer(**SCENES["config3"], device=DEVICE, double=True)[0]
    if rd.compiled.tables["tri"]["p0"].dtype != torch.float64:
        raise AssertionError("config 3 in double: the tables are not float64")
    closest, shadow = rd.integrator.queries_per_sample()
    frame, k2 = k2_frame("config 3 in double", rd, (closest + shadow) * frame_chunks(rd), card)
    img_d = rd.image(rd.render())
    rs = mesh_scene_renderer(**SCENES["config3"], device=DEVICE)[0]
    img_s = rs.image(rs.render())
    if img_d.dtype != np.float64 or img_s.dtype != np.float32:
        raise AssertionError(f"image dtypes {img_d.dtype} (double), {img_s.dtype} (float32)")
    parity = compare_images("config 3: double against float32", img_d, img_s,
                            sides=("float32", "double"))
    turns = {"double": [], "float32": []}
    for _ in range(3):
        for name, r in (("double", rd), ("float32", rs)):
            turns[name].append(timed(lambda: r.image(r.render()), reps=1)[0])
    med = {k: sorted(v)[1] for k, v in turns.items()}
    log(f"  frames in turns on {card}: double {[round(t, 4) for t in turns['double']]} s, "
        f"float32 {[round(t, 4) for t in turns['float32']]} s; medians {med['double']:.4f} / "
        f"{med['float32']:.4f} s")
    res["config3"] = dict(frame, k2=k2, parity_with_float32=parity, turns_s=turns,
                          median_double_s=med["double"], median_float32_s=med["float32"])
    del rd, rs
    # K5 moves the float64 payload columns (rays, carried radiance) as bytes
    rb = mesh_scene_renderer(**SCENES["config3"], device=DEVICE, double=True,
                             sort="bitonic")[0]
    sorts = record_sorts(rb)
    if len(sorts) != 2 * (closest - 1) * frame_chunks(rb):
        raise AssertionError(f"config 3 in double under bitonic: {len(sorts)} co_sorts")
    for i, ops in enumerate(sorts):
        if i == 0 and not any(x.dtype == torch.float64 for x in ops):
            raise AssertionError("config 3 in double: no float64 payload in the co_sort")
        check_sort(f"config 3 in double, call {i}", ops)
    res["config3"]["bitonic_sorts_checked"] = len(sorts)
    del rb, sorts

    log(f"== phase 19 (b): phase 16 (a)'s config 3 in motion, in double through cli.main "
        f"--double, {MOTION}, ray_batch {MOTION_BATCH}")
    os.makedirs(SCENEFILE_DIR, exist_ok=True)
    d = os.path.abspath(SCENEFILE_DIR)
    ply = f"{d}/torus.ply"
    write_torus_ply(ply)
    config3_scenefile(f"{d}/motion_double.pbrt", ply, **MOTION, rotate=MOTION_ROTATE,
                      shift=MOTION_SHIFT)
    got, build_s, launches = cli_render([f"{d}/motion_double.pbrt", "--ray-batch",
                                         str(MOTION_BATCH), "--double", "-o",
                                         f"{d}/motion_double.pfm", "-q"])
    r, img, first_s = got["renderer"], got["image"], got["seconds"]
    log(f"  build {build_s:.2f} s, first frame {first_s:.3f} s, launches {launches}; "
        f"image {img.dtype} mean {img.mean():.6f}")
    if launches != {"anim_walk_f64": MOTION_SWEEPS}:
        raise AssertionError(f"the double motion frame launched {launches}, want "
                             f"anim_walk_f64 x {MOTION_SWEEPS}")
    if img.dtype != np.float64 or not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError(f"the double motion image: {img.dtype}, not finite or black")
    calls = record_anim_walks(r)
    if len(calls) != MOTION_SWEEPS or calls[0][2].dtype != torch.float64:
        raise AssertionError(f"the double motion frame: {len(calls)} K7 sweeps, keys "
                             f"{calls[0][2].dtype}")
    works, plain, err, db, worst = [], [], 0.0, 0.0, None
    for i, call in enumerate(calls[::MOTION_STRIDE]):
        e, work, p_ms, b, w = check_anim(f"double sweep {i * MOTION_STRIDE}", call,
                                         DOUBLE_RTOL)
        err = max(err, e)
        if w is not None and b > db:
            db, worst = b, dict(w, sweep=i * MOTION_STRIDE)
        works.append(work)
        plain.append(p_ms)
    if worst is not None:
        log(f"  the largest |db|, {worst['db']:.3e}: sweep {worst['sweep']}, lane "
            f"{worst['lane']}, prim {worst['prim']}, time {worst['time']!r}, weights "
            f"{worst['weights']}, det {worst['det']!r} (|e1| |d x e2| {worst['scale']!r}), "
            f"b0 / b1 numerators {worst['b0_num']!r} / {worst['b1_num']!r}, b0 b1 kernel / "
            f"plain {worst['b']}, keys {worst['keys']}")
    swept = time_anim_sweeps(calls)
    ms = [t for t, _ in swept]
    log("  " + sweep_stats_line(swept))
    del calls, got, r
    b_ms, b_by = bound(np.mean([w[0] for w in works]), np.mean([w[1] for w in works]),
                       F64_OPS_PER_S)
    ms_checked = float(np.mean(ms[::MOTION_STRIDE]))
    log(f"  anim_walk_f64 per sweep {[round(t, 4) for t in ms]} ms: mean {np.mean(ms):.4f} ms "
        f"({ms_checked:.4f} over the checked sweeps, bound {b_ms:.5f} ms ({b_by}), "
        f"{b_ms / ms_checked:.2%} of it); plain on the card {[round(t, 1) for t in plain]} ms; "
        f"max |dt| {err:.3e}, max |db| {db:.3e}; on {card}")
    k7_double = dict(max_abs_err=err, max_abs_db=db, worst_b_lane=worst, ms=float(np.mean(ms)),
                     plain_ms=float(np.mean(plain)), bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, sweep_ms=ms, sweep_stats=[st for _, st in swept],
                     ms_at_plain_sweeps=ms_checked,
                     plain_stride=MOTION_STRIDE, launches_per_frame=launches["anim_walk_f64"])
    res["motion"] = dict(build_s=build_s, first_frame_s=first_s, image_mean=float(img.mean()),
                         card=card)

    log(f"== phase 19 (c): Cornell in double, {CORNELL}")
    rc = cornell_renderer(**CORNELL, device=DEVICE, double=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    img = rc.image(rc.render())
    first_s = time.time() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    if launches or img.dtype != np.float64 or not (np.isfinite(img).all() and img.max() > 0):
        raise AssertionError(f"Cornell in double: launches {launches}, image {img.dtype}")
    median, times = timed(lambda: rc.image(rc.render()))
    log(f"  first frame {first_s:.3f} s; frame {median:.4f} s ({[round(x, 4) for x in times]}) "
        f"on {card}; image mean {img.mean():.6f}")
    del rc
    imgs = {dev: cornell_renderer(**DOUBLE_CORNELL_PARITY, device=dev, double=True)
            for dev in (DEVICE, "cpu")}
    imgs = {dev: r.image(r.render(progress=False)) for dev, r in imgs.items()}
    rel = np.abs(imgs[DEVICE] - imgs["cpu"]) / np.abs(imgs["cpu"]).clip(min=1e-300)
    log(f"  32x32: {float((rel <= 1e-9).all(axis=-1).mean()):.4f} of pixels within rtol 1e-9")
    res["cornell"] = dict(first_frame_s=first_s, frame_s=median, frames_s=times, card=card,
                          parity=compare_images("Cornell in double at 32x32", imgs[DEVICE],
                                                imgs["cpu"]))

    log(f"== phase 19 (d): tests/test_refrender.py's GI box, {REF_BOX}, on the card against "
        "refrender.py on the card's sample stream")
    text, args, (eye, look, up, fov) = ref_gi_box(**REF_BOX)
    n, spp, depth = REF_BOX["xres"], REF_BOX["spp"], REF_BOX["maxdepth"]
    res["refrender"] = {}
    for double in (False, True):
        api = PbrtAPI(Options(ray_batch=n * n * spp, double=double),
                      render_on_world_end=False, device=DEVICE)
        api.init()
        api.parse_string(text)
        r = Renderer(api.scene, api.opt, device=DEVICE)
        dev_img = r.image(r.render(spp=spp, progress=False))
        table = sample_table(r, n, n, spp, 5 + 7 * depth)
        ref = render_reference(RefScene(*args), look_at(eye, look, up), fov, n, n, spp, depth,
                               table)
        off = np.abs(dev_img - ref).max(axis=-1)
        got = (float((off > 0.02).mean()), abs(float(dev_img.mean() - ref.mean())),
               float((off > 2e-6).mean()))
        label = "double" if double else "float32"
        log(f"  {label}: {got[0]:.4f} of pixels off by > 0.02, |mean difference| "
            f"{got[1]:.3e}, {got[2]:.4f} off by > 2e-6")
        if not all(g < b for g, b in zip(got, REF_BOX_BOUNDS[double])):
            raise AssertionError(f"the GI box in {label} against refrender.py: {got}")
        res["refrender"][label] = dict(off_002=got[0], mean_diff=got[1], off_2e6=got[2])
    if res["refrender"]["double"]["off_2e6"] > res["refrender"]["float32"]["off_2e6"]:
        raise AssertionError("the GI box: double is further from refrender.py than float32")
    return res, k7_double


# the phases that need nothing but the card, by number: ``--phase N`` runs
# one of them alone after phases 1 and 2
ALONE = {12: lambda card: phase_integrators(), 14: phase_volume, 15: phase_bdpt,
         16: phase_motion, 17: phase_features,
         18: lambda card: phase_sharded(card)[0], 19: lambda card: phase_double(card)[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--phase", type=int, choices=sorted(ALONE),
                    help="after the card and the build, run this phase alone; the last "
                         "line then lists the phases run")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    log(f"== phase 1: torch {torch.__version__} cuda {torch.version.cuda}; card:")
    log(card)

    from pbrt_tpu_torch.kernels import anim_walk, bitonic, build, bvh2_walk, bvh8_walk

    seconds = build.build()
    for mod in (bvh8_walk, bvh2_walk, bitonic, anim_walk):
        mod.load_library()
    log(f"== phase 2: kernels built in {seconds:.2f} s (one nvcc per source, together)")
    for src, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  {src}: {line.strip()}")

    if args.phase is not None:
        print(json.dumps({f"phase_{args.phase}": ALONE[args.phase](card)}, default=str))
        print(json.dumps({"ok": True, "phases": [1, 2, args.phase], "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    rs = renderers()
    kern = phase_kernels(rs)
    launches, first_s, config3_image = phase_main_path(rs)
    phase_parity()
    frames = phase_frames(rs)
    if args.profile:
        phase_profile("config-3", rs["default"], frames["default"][0])
    closest, shadow = rs["default"].integrator.queries_per_sample()
    queries = PIXELS * 8 * (closest + shadow)
    log(f"== phase 6: config-3 frame seconds (median of three, taken in turns; "
        f"{queries} closest+shadow queries/frame) on {card}")
    for name, (median, t) in frames.items():
        log(f"  {name}: {median:.4f} s ({[round(x, 4) for x in t]}), "
            f"{queries / median / 1e6:.3f} Mray/s; first frame {first_s[name]:.3f} s")
    del rs
    cornell, cornell_frame = phase_cornell(card)
    if args.profile:
        cornell_frame["profile"] = phase_profile("Cornell", cornell, cornell_frame["frame_s"])
    del cornell
    cornell_frame["parity"] = phase_cornell_parity()
    print(json.dumps({"cornell": cornell_frame}))
    r5, config5, kern["stream_walk8"]["config5"] = phase_config5(card)
    if args.profile:
        config5["profile"] = phase_profile("config-5", r5, config5["frame_s"])
    print(json.dumps({"config5": config5}))
    step = phase_grad_step(r5, card)
    del r5
    gradients = dict(config5_step=step, parity=phase_grad_parity())
    kern["stream_walk8"]["config5"].update(
        grad_launches_forward=step["k2_launches_forward"],
        grad_launches_backward=step["k2_launches_backward"])
    kern["wide_walk8"]["grad_launches"] = gradients["parity"]["torus_24x24"]["launches"].get(
        "wide_walk8", 0)
    print(json.dumps({"gradients": gradients}))
    r4, config4, kern["stream_walk8"]["config4"] = phase_config4(card)
    if args.profile:
        config4["profile"] = phase_profile("config-4", r4, config4["frame_s"])
    config4["gradient_step"] = phase_config4_grad(r4, card)
    del r4
    kern["stream_walk8"]["config4"].update(
        grad_launches_forward=config4["gradient_step"]["k2_launches_forward"],
        grad_launches_backward=config4["gradient_step"]["k2_launches_backward"])
    print(json.dumps({"config4": config4}))
    print(json.dumps({"integrators": phase_integrators()}))
    scenefile, kern["stream_walk8"]["scenefile"] = phase_scenefile(card, config3_image,
                                                                   args.profile)
    kern["stream_walk8"]["scenefile"].update(
        config3_cli_launches=scenefile["config3"]["launches"]["stream_walk8"])
    print(json.dumps({"scenefile": scenefile}))
    volume, kern["stream_walk8"]["volume"] = phase_volume(card, args.profile)
    print(json.dumps({"volume": volume}))
    bdpt, kern["stream_walk8"]["bdpt"], kern["stream_walk8"]["mlt"], k2_grad = phase_bdpt(
        card, args.profile)
    kern["stream_walk8"]["volume"].update(k2_grad)
    print(json.dumps({"bdpt": bdpt}))
    motion, kern["anim_walk"], kern["stream_walk8"]["sppm"] = phase_motion(card)
    launches["anim_walk"] = kern["anim_walk"]["launches_per_frame"]
    print(json.dumps({"motion": motion}))
    features, kern["stream_walk8"]["fur"] = phase_features(card)
    print(json.dumps({"features": features}))
    sharded, kern["stream_walk8"]["sharded"], kern["skip_walk"]["sharded"] = phase_sharded(
        card, config3_image)
    print(json.dumps({"sharded": sharded}, default=str))
    double, kern["anim_walk_f64"] = phase_double(card)
    launches["anim_walk_f64"] = kern["anim_walk_f64"]["launches_per_frame"]
    k7_ms = kern["anim_walk"]["ms"], kern["anim_walk_f64"]["ms"]
    double["motion"]["k7_double_over_float"] = k7_ms[1] / k7_ms[0]
    log(f"  K7 on phase 16 (a)'s frame: float {k7_ms[0]:.4f} ms, double {k7_ms[1]:.4f} ms a "
        f"sweep ({k7_ms[1] / k7_ms[0]:.2f}x) on {card}")
    print(json.dumps({"double": double}, default=str))

    print(json.dumps({"kernels": [
        dict({"name": name, "route": "cuda", "source": CSRC + src, "replaces": replaces,
              "launches": launches[name]}, **kern[name])
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
