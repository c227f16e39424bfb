"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 5] [--width 1920] [--height 1080]

Phases, one line each (any failure exits non-zero):
  1. device: a CUDA card must be present; prints its name and power limit.
  2. build:  compiles the hand-written kernels from flexlight_tpu_torch/csrc
     (one nvcc per source, in parallel) and prints ptxas' registers, stack
     and spills of each kernel.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card, on the inputs one real theater 1080p frame hands it: the PRE and
     POST kernels of scheme="fused_split" on the state block of every call
     of a frame (5 bounces) and of one resampling PRE (2 spp), PRE at the
     top of its range (a 1024-triangle scene, wave with 9 x 9 pillars and
     50 seeded triangles, at this size, held against the plain version on
     every 16th ray), and POST's
     live-ray list kernel on the state of each POST call (the same rays,
     each once; per call POST's time, its live rays and the list's time);
     the traversal kernels on every cast of a scheme="kernel" frame (5
     closest, 5 any hit, each timed against its bound, which counts each
     (ray, triangle) pair up to the record test's reject, with W's full
     count beside it, and summed per frame), on a seeded random bounce
     wavefront, and at the top of the scheme's range: the dragon
     stand-in's 1080p camera rays against its first 4095 triangles (held
     against the plain version on every 16th ray); the shade kernel on the
     state of each of the 5 bounces of that scheme="kernel" frame with
     shade_kernel=True (per call its shaded rays, and its list, POST's
     list kernel on its state, held and timed as a sub-row); the three
     disc passes on every call (3 + 3 + 1) of one theater (fused_split),
     one dragon stand-in (sparse) and one wave
     (fused) frame, with per-frame sums of time and bound, and FXAA on
     the FXAA input of the theater frame and on an edge-heavy image of
     the same size (seeded random 2 x 2 cells), each with its share of
     edge pixels; and the
     four worklist kernels of scheme="sparse" (tile flags, nearest2 key,
     closest hit, any hit) on the wavefronts of a dragon stand-in 1080p
     frame with shade_kernel=True: the flags and the key on every call of
     the frame (10 and 9, each against its plain version, with the share
     of (ray, cluster) pairs the flags' interval cull skips and the
     per-frame sums of time and bound), closest hit and any hit on its
     primary cast, its first shadow cast and its first bounce cast (and
     timed on every cast of the frame, 5 + 5, against their summed bound,
     with the ray-triangle tests their warp walk issues beside those the
     bound counts), and the interp_shade kernel on the state of each of its 5
     bounces (with its alive list, `alive_list`, held and timed as a
     sub-row); and the whole-frame kernel of scheme="fused"
     (fused_frame) on wave's 1080p camera rays at 1 spp (the frame the port
     renders) and at 2 spp, 5 bounces, with its live ray-bounces and the
     share of its lane-slots that did live work (its `lane_stats` counts,
     which must count each live ray-bounce once) beside a block-wide
     schedule's share on the same frame. Each
     kernel takes the same operations in the same order as its plain
     version, so their outputs must be identical; prints the number of
     differing values, the max abs difference, the median CUDA-event time
     of both sides (the slow plain worklist casts: one timed call) and the
     least time the card could take (bound). The bounds of PRE, POST and
     fused_frame count each cast's (ray, triangle) pairs up to the record
     test's reject that takes them (`table_cast_ops`), on the card in
     chunks; PRE's has W's count beside it.
  4. main path: theater at 1080p (stand-in wood texture from --seed), full
     pipeline (temporal 4, 3+3+final filter, FXAA, 1 spp, 5 bounces)
     through FlexLight(...).renderer = "pathtracer" and render_frame(),
     scheme "auto", which must resolve to "fused_split"; checks the output,
     that each frame launched PRE once, POST five times (and its live-ray
     list kernel five times) and the filter and FXAA kernels, and that the
     frames match the same frames rendered with
     every kernel swapped for its plain version (<= 1% of values over 2e-3,
     max <= 0.5).
  5. the scheme="kernel" path: the same frame at half size (960x540 by
     default), 2 frames, through the same entry points with the renderer's
     scheme set to "kernel"; checks that the traversal kernels (and, by
     default on theater's textured floor, the shade kernel) were launched
     and the frames against their plain frames as above.
  6. the sparse path: the dragon stand-in (scenes.dragon: seeded OBJ files
     from --seed under build/objects/, 44,890 triangles, glass dragon and
     sphere) at 1080p, full pipeline, through FlexLight(...).renderer =
     "pathtracer" and render_frame(), the monkey head's look-at animation
     applied before every frame; scheme "auto" must resolve to "sparse",
     and every frame must launch the flags 10x, the key 9x, closest hit 5x
     and any hit 5x, and (the default shading route: no textures)
     interp_shade and its alive list 5x (shade and POST's list never). The
     frames against the same frames with the plain versions as above (the
     plain worklist casts take seconds each at 1080p: ~20 s per plain
     frame). The phase's tracers are freed before phase 7, whose peaks
     then compare with this phase's.
  7. the shading routes, through the same entry points: (a) the dragon
     stand-in at 1080p as in phase 6 with the renderer's shade_kernel
     switch off (the eager loop), which must launch no shading kernel
     besides the worklist kernels' 10 / 9 / 5 / 5, its frames against
     phase 6's plain frames (the plain shading versions are the eager
     stage functions, so those frames serve); (b) theater at 1080p on
     scheme="kernel" with the switch on, 2 frames, which must launch shade
     and its list (POST's list kernel) 5x per frame (interp_shade and the
     alive list never), against their plain frames.
  8. the fused path: wave (scenes.wave: 4 pillars on a plane, 50
     triangles, 1 light, a 2x2048 PBR atlas) at 1080p, full pipeline,
     through FlexLight(...).renderer = "pathtracer" with the renderer's
     scheme set to "fused" and render_frame(), its animation applied
     before every frame; every frame must launch fused_frame once and no
     PRE, POST, traversal or shading kernel, and match its plain frame as
     above; one frame's MRT on scheme="fused" must be identical to the
     same frame's on scheme="fused_split" (both through the kernels), and
     the CUDA-event time of both MRT passes is printed.
  9. the rasterizer, TAA and the simple renderer, through FlexLight(...)
     and render_frame(): (a) the engine's default renderer, the
     Rasterizer, with the default Config (FXAA) on theater at 1080p; "auto"
     must resolve to "kernel", and each frame must launch closest_hit once
     a layer, any_hit once a light and layer and FXAA once, and the
     shading kernels of csrc/raster.cu (raster_surface and raster_shade
     once a layer, raster_rays once a light and layer), its frames
     against the same frames through the plain versions (the golden budget,
     and identical: the kernels are bit-exact, so one differing value
     fails, as in (b) and (c)); then each shading kernel against its plain
     version on every call of the first plain frame (identical), each call
     timed beside its bound; (b) the
     Rasterizer on the dragon stand-in at half size (960x540), 2 frames:
     "auto" must resolve to "sparse" (unsorted casts: the flags once a cast,
     closest hit once a layer, any hit once a light and layer, the key
     never; the shading kernels as in (a)), against its plain frames; (c)
     the PathTracer on theater at
     1080p with antialiasing="taa", 11 frames so that the 9-frame history
     wraps, on "fused_split" (PRE 1x, POST 5x, the filter passes, no
     FXAA), against its plain frames; (d) api="simple" on theater at 1080p,
     2 frames, finite and not black, no kernel launched (its scan casts are
     plain PyTorch, as in flexlight_tpu). Each path prints its median frame
     ms, its device-busy ms a frame (torch.profiler over 2 more frames),
     its idle share and its peak device memory.
 10. serve, on theater at the headline config: (a) render_frame_u8 24 times
     on each of six fresh renderers, at pipelined depths 0, 4, 1, 1, 4, 0,
     the camera moved a little before each frame; every pipelined call
     must be identical to the first synchronous run's frame that the
     warm-up rule names (call i returns frame max(0, i - depth)); the
     median steady frame ms (calls 7-24) of each run at depths 0, 1 and 4,
     the device-busy ms (torch.profiler) and idle shares, and the calls of
     a steady depth-4 frame that synchronize
     with the device (torch.cuda.set_sync_debug_mode("warn")), each by its
     source line, with the frame's uploads as they were before the repair
     (pageable copies) and as they are (pinned, non-blocking); (b) the
     frame server (serve.FrameServer on 127.0.0.1, port 0, renderer
     "pathtracer"): GET / answers 200, /frame.png decodes to an [H, W, 3]
     uint8 frame that is not black, POST /input KeyW moves the camera and a
     mouse message turns it, POST /config {"max_reflections": 3} lands
     between frames, /stats has fps > 0 and scheme "fused_split", a
     counting KernelSet on the server's renderer and the wrappers' own
     counts see PRE once a frame, POST and its list once a bounce (5, then
     3), the 7 disc passes and FXAA once a frame; with `freeze` set, the
     served PNG must be the plain versions' frame of the same index, bit
     for bit; the served fps and median frame ms; the server stops and its
     threads join within 10 s; (c) a FailoverRunner over 8 frames
     (mirror_every 4) and checkpoint_now() (snapshot and write seconds of
     the ~530 MB state, written under build/smoke/ and removed after): a
     fresh renderer that resume()s renders the next frame identical to the
     uninterrupted renderer's.
 11. the last slice's paths (casts_and_ranks_phase): (a) theater at
     1080p, the headline config, on scheme="mxu" through render_frame, 2
     frames identical to the same frames on scheme="kernel" (the same
     k-order products), with the disc passes and FXAA launched and no
     cast kernel; (b) the dragon stand-in at 1080p with the direct config
     (bench.py:68-91: 1 spp, 5 bounces, no post) on scheme="clustered",
     one frame through render_frame, then its MRT (CUDA events around the
     pass) against the scheme="sparse" MRT of the same frame: at most
     0.01% of the pixels may differ (rays whose two nearest triangles lie
     within rounding of each other; 4 of 2,073,600 on the H100); (c) the
     rasterizer at half size on scheme="mxu" (theater, identical to
     "kernel") and "clustered" (the dragon stand-in, against "sparse", the
     same 0.01%); (d)-(f) two ranks
     spawned on this one card (NCCL takes one rank a card, so they mesh
     over gloo): frame_pipeline_sharded_halo on theater 1080p, tile 2, 3
     frames, each display identical to the one-process display of the
     same seeds and states, each rank's kernels launched exactly as the
     one-process frame launches them (PRE 1, POST 5, the passes 3 + 3 + 1
     and FXAA 1 a frame), and the frame ms of both ("two ranks sharing one
     card, not a scaling number"); render_mrt_sharded at 2
     spp on tile 1 x sample 2 (colour within 1e-4, every other channel
     identical); and broadcast_scene (rank 1 starts from zeros; both ranks
     end with the buffers of this process). Each path's frame ms, device
     ms and peak memory in its [paths] line.
Then one JSON line per the kernels (PRE: the theater call, with W's
bound w_bound_ms, the resampling call's resample_ms, resample_plain_ms
and resample_bound_ms, and the 1024-triangle call's cap_ms,
cap_plain_ms_16th (the plain version on every 16th ray), cap_bound_ms and
cap_w_bound_ms; FXAA: the frame's input, with the edge-heavy image's
edge_ms, edge_plain_ms and edge_bound_ms; POST and its list kernel: the
sums over the frame's 5 calls; shade, interp_shade and the alive list:
the sums over their frame's 5 calls, shade with its lists' list_ms,
list_plain_ms, list_bound_ms and list_launches; fused_frame: the 1-spp
launch, with the 2-spp launch's ms_2spp, plain_ms_2spp and bound_ms_2spp; the four worklist kernels' ms and
bound_ms are those of their first compared call, frame_ms and
frame_bound_ms the sums over the frame's calls; the flags add
frame_all_pairs_bound_ms, the bound of testing every live pair; the
traversal kernels' ms and bound_ms are the primary / shadow-0 cast's,
frame_ms, frame_plain_ms and frame_bound_ms the sums over the theater
frame's 5 casts and frame_w_bound_ms that of W's full count, and closest
hit adds t4095_ms, t4095_bound_ms and t4095_w_bound_ms at 4095 triangles;
the rasterizer's kernels add raster_theater_launches /
raster_dragon_launches, their counts in phase 9 (a) / (b), and the
served frames' kernels serve_launches, their counts in phase 10 (b),
and their counts on phase 11's paths (mxu_, clustered_, raster_mxu_,
raster_clustered_launches, and ranks_launches: rank 0's over its 3
sharded frames);
the disc passes' ms and bound_ms are the theater frame's first call's,
frame_ms and frame_bound_ms the sums over its calls of that pass; the
rasterizer's shading kernels' ms, plain_ms and bound_ms are phase 9 (a)'s
first call's (layer 0, light 0), frame_ms, frame_plain_ms and
frame_bound_ms the sums over the frame's 4 + 36 + 4 calls), the
card's name and power limit, and a last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

# the share of pixels in which a clustered frame or MRT may differ from its
# sparse counterpart: rays whose two nearest triangles lie within rounding
# of each other take either (4 of 2,073,600 pixels at 1080p and 0 of
# 518,400 at 960x540 on the H100); 0.01% is 207 and 51 pixels
KNIFE_EDGE_SHARE = 1e-4
# the least time the card could take: the H100 SXM's memory rate and its
# fp32 rate outside the tensor cores (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations per unit of work, counted from the kernels' sources: an
# add, multiply, divide, square root, sine, arctangent, floor, truncation,
# compare or clamp bound counts one; selects, negations, conversions and
# integer and address arithmetic count none, and so does work that a
# data-dependent branch may skip (a gated tap, a first-surface update), so
# each count is the least its inputs need.
# One Moeller-Trumbore test of W's rows (ops/intersect_kernel.py
# closest_hit_plain: W's count, in brackets beside the bounds of PRE and
# the traversal kernels) needs only their non-zero terms
# (ops/intersect_kernel.py tri_rows: det 3, udet 9, vdet 9, sdet 3 and a
# constant): 24 multiplies and 21 adds, the divide, the three scales, u + v
# and 8 compares; an any hit keeps no running minimum (7 compares). The
# record test (the traversal kernels, PRE, POST, FRAME and the worklist
# casts) is counted per pair up to its reject (OPS_REC_*).
OPS_CLOSEST_TEST = 58
OPS_ANY_TEST = 57
OPS_MAKE_RAY = 15        # W's ray features: |d|^2, its test, d (x) o
OPS_BOUNCE_PRE = 205     # trace.cuh fl_bounce_pre: 55, and 50 per vertex
# trace.cuh fl_bounce_shade outside the light loop and the noise: the frame
# (ray_dir 14, sign 8, flip 3, noise phase 1, random sphere 25, brdf 9,
# rough normal 20, half vector 14, v.h 6, (1-v.h)^5 4, Fresnel 15, decision
# 2), the id packing (2 atan2 phases 8, 2 nibble packs 10, 3 sums), the
# filter tests 2, the reservoir normals 6 and its epilogue (light dir 11,
# tests 8, offset target 6, length 6); the scale of the ids adds one
# multiply per bounce index
OPS_SHADE = 181
OPS_FIRST_LENGTH = 21    # and, at bounce 1, the first ray length
OPS_APPLY = 65           # trace.cuh fl_bounce_apply with next_ray_dir
OPS_LIGHT = 148          # one light of the reservoir loop: position, fl_forward_trace (130),
                         # weight, selection; a light that is on adds its 5 sums
OPS_LIGHT_ON = 5
OPS_TEX_SELECT = 3       # shade.cu: interp_shade's three texture-number tests
# trace.cuh fl_fetch_tex: the miss test alone where the texture number is
# -1; else also the height factor 1, the texture number's remainder 4
# (fmod and 3 compares), the coordinates 7, and per pixel axis a remainder
# 4 with its scale, floor and truncation 3; a u8 table adds 3 byte scales
OPS_TEX_MISS = 1
OPS_TEX_FETCH = 26
OPS_TEX_U8 = 3
OPS_FRAME_SAMPLE = 6     # fused.cu FRAME per ray and sample: the ambient epilogue
OPS_FRAME_RAY = 3        # and per ray the scale by 1 / spp (each later sample adds 3 sums)
OPS_NOISE = {"hash": (5, 8), "counter": (0, 2)}  # one noise call: (per call, per output)
# The words a live ray reads and writes in the shading kernels (shade.cu):
# shade reads 19 carry words, the surface's normal and offset (4), the
# textures (9) and the NDC (2), and writes the 13 carry words bounce_shade
# changes and the 26-word request; interp_shade reads the 26 carry words
# bounce_pre and bounce_shade take and the NDC, and writes ray_origin, the
# 13 carry words and the 30-word request (with emis and tpo), besides the
# 49-float material row of each triangle its rays hit. At bounce 1 both
# read and write the first ray length too. Every ray reads m (shade) or
# alive and writes m (interp_shade).
SHADE_WORDS = (34, 39)
STEP_WORDS = (28, 46)
MAT_C = 49
OPS_DISC_TAP = {"first_blur": 4, "second_blur": 10, "final_blur": 10}  # what every tap runs
OPS_FXAA_PIXEL = 39      # fxaa.cu: the 3x3 luma test every pixel runs
# raster.cu, per pixel: the surface (the weights 2, the local position 15,
# its rotation 15 and shift 3); a light's shadow ray (the vector 3, its
# length 6, the clamp and the 3 divides); the shade outside its textures
# and lights: the weights and local position 17, the normal (15, its
# rotation 15, the normalize 10), the texture coordinates 10, the ambient
# 3, the view vector 13 and the epilogue (albedo 3, peak 2, fade 3, blend
# 12, clamp 3, alpha 2), under hdr Reinhard + gamma 7 a channel; per light
# the light vector 3, fl_forward_trace 130, its zero test 7 and the
# strength test (the sums of a light that adds are data-dependent and
# count none); each texture as OPS_TEX_*
OPS_RASTER_SURFACE = 35
OPS_RASTER_RAY = 13
OPS_RASTER_SHADE = 108
OPS_RASTER_HDR = 21
OPS_RASTER_LIGHT = 141
# sparse.cu: one slab test of a ray against a box (fl_slab_entry) is per
# axis two subtracts, two multiplies, a min and a max, and two to fold the
# axes in (the first axis folds none): 22; a tile flag adds entry =
# max(tmin, BIAS), the two hit compares and the running minimum; a key box
# entry, the two hit compares and the best two's two compares. Per ray:
# 1 / d with its zero test (6); the flags add the live test and the ray
# tile's span (12 min / max of origin and 1 / d, the largest max_len); the
# key the dead and live tests and the octant. Per (live ray tile,
# cluster): the flags' interval cull (fl_cull: per axis 4 subtracts, 8
# multiplies, 14 min / max; the folds, entry_lo and 2 compares), and, for a
# tile's second cluster that survives it, the compare with the first's
# minimum. Dead rays need none of it.
OPS_SLAB = 22
OPS_FLAG = OPS_SLAB + 4
OPS_KEY_BOX = OPS_SLAB + 5
OPS_INV_DIR = 6
OPS_FLAGS_RAY = OPS_INV_DIR + 1 + 13
OPS_KEY_RAY = OPS_INV_DIR + 2 + 3
OPS_CULL = 85
OPS_SKIP = 1
KEY_RAYS, KEY_BLOCK_RAYS = 2, 512   # sparse.cu: rays a thread and a block of the key hold
# sparse.cu's worklist casts test a 16-float triangle record and stop at the
# first exact reject that takes the pair, so each pair the bound needs
# counts the operations its own test reaches: det (3 multiplies, 2 adds)
# and its reject; then, closest hit, det's sign, sdet (3 multiplies, 3
# adds) and its sign test, any hit sdet and its test; then udet and vdet
# (9 multiplies, 8 adds each), each with its reject where the window's u /
# v edge is above 0 (bounce casts, every any hit); a survivor then takes
# 1 / det and the three scales, and the window's compares up to its first
# false one (u + v adds one); an accepted closest hit adds the running
# minimum's compare. Per ray: |d|^2, its test and six products of d and o.
OPS_REC_RAY = 12
OPS_REC_DET = 6
OPS_REC_SDET = {True: 8, False: 7}   # closest hit, any hit
OPS_REC_UV = 17
OPS_REC_DIVIDE = 4
# a pair that an any hit accepts passes every reject and the window's 7 compares
OPS_REC_ACCEPT = OPS_REC_DET + OPS_REC_SDET[False] + 2 * (OPS_REC_UV + 1) + OPS_REC_DIVIDE + 7


def raster_shading(raster) -> dict:
    """The shading launches of one rasterizer frame: every scheme shades a
    hit layer in csrc/raster.cu, a surface and a shade launch a layer and
    a ray launch a light and layer."""
    layers, n_lights = raster.resolved_layers(), raster._buffers.lights.shape[0]
    return {"raster_surface": layers, "raster_rays": layers * n_lights, "raster_shade": layers}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, setup=None) -> float:
    """Median CUDA-event time of fn() in ms, after one warm-up call.
    `setup()` runs before each call, outside the timed events (it restores
    the state that an in-place kernel overwrites)."""
    import torch

    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the float operations over the fp32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flags_cull(amin, amax, o3, d3, max_len, ray_tile: int):
    """The flags kernel's interval cull (csrc/sparse.cu fl_cull) in the
    same float operations, per (ray tile, cluster box): ([RT, K] bool, no
    ray of the tile can flag the box; [RT, K] f32, the least entry any of
    its rays can have; [RT] bool, the tile has a live ray). The bounds come
    from each tile's span over its live rays (a NaN component left out): the
    least and largest origin and 1 / d per axis, and the largest max_len.
    It says which (ray tile, cluster) pairs the kernel tests, for the
    flags' bound (and tests/test_torch_sparse_slab.py holds it exact)."""
    import torch

    from flexlight_tpu_torch.ops.intersect import BIAS
    from flexlight_tpu_torch.ops.intersect_sparse_kernel import _inv_dir

    rt = max_len.shape[0] // ray_tile
    live = (max_len > 0.0).reshape(rt, ray_tile)

    def span(x):
        x = x.reshape(rt, ray_tile)
        keep = live & ~torch.isnan(x)
        return (torch.where(keep, x, float("inf")).amin(dim=1)[:, None],
                torch.where(keep, x, float("-inf")).amax(dim=1)[:, None])

    ml = torch.where(live, max_len.reshape(rt, ray_tile), float("-inf")).amax(dim=1)[:, None]
    tmin_lo = tmax_hi = None
    for c in range(3):
        olo, ohi = span(o3[c])
        ilo, ihi = span(_inv_dir(d3[c]))
        lo, hi = amin[None, :, c], amax[None, :, c]
        prods = torch.stack([x * i for x in (lo - ohi, lo - olo, hi - ohi, hi - olo)
                             for i in (ilo, ihi)])
        least, most = prods.amin(dim=0), prods.amax(dim=0)   # NaN-propagating, as fl_min_nan
        tmin_lo = least if c == 0 else torch.maximum(tmin_lo, least)
        tmax_hi = most if c == 0 else torch.minimum(tmax_hi, most)
    entry_lo = torch.maximum(tmin_lo, tmin_lo.new_tensor(BIAS))
    none = (tmax_hi < entry_lo) | (tmin_lo >= ml)
    return none, entry_lo, live.any(dim=1)


def golden_budget(a, b):
    """(fraction of values over 2e-3, max abs diff) of two images."""
    d = (a.float() - b.float()).abs()
    return float((d > 2e-3).float().mean()), float(d.max())


def ptxas_usage(log: str):
    """{kernel function: {registers, stack, spill_st, spill_ld, smem}} from
    the output of nvcc -Xptxas -v (smem: bytes of static shared memory)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r"fl_[a-z0-9_]+?_kernel", m.group(1))
            name = short.group(0) if short else m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                                            spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {}).update(registers=int(m.group(1)))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out.setdefault(name, {}).update(smem=int(m.group(1)))
    return out


def decode_png(data: bytes):
    """[H, W, 3] uint8 of a PNG as utils.image.png_bytes or png_bytes_parts
    writes it (its IDATs joined into one zlib stream, filter 0 on every
    row); fails on any other PNG."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail("the served frame is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        fail("the served PNG has rows with a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def serve_phase(args, dev, engine, counted, device_busy, paths) -> dict:
    """Phase 10 on theater at the headline config: (a) the path tracer's
    pipelined fetch against the synchronous frames, its frame ms at depths
    0, 1 and 4 and the synchronizing calls of a steady frame; (b) the
    frame server on 127.0.0.1 through every endpoint; (c) a FailoverRunner
    checkpoint resumed in a fresh renderer. Returns the kernels' launches
    over the served frames."""
    import collections
    import traceback
    import urllib.request
    import warnings

    import numpy as np
    import torch

    from flexlight_tpu_torch import Camera
    from flexlight_tpu_torch.kernels import KERNELS, PLAIN, KernelSet
    from flexlight_tpu_torch.models.pathtracer import PathTracer
    from flexlight_tpu_torch.ops import fused as F
    from flexlight_tpu_torch.ops import fused_kernel as SK
    from flexlight_tpu_torch.ops import pathtrace as P
    from flexlight_tpu_torch.serve import FrameServer
    from flexlight_tpu_torch.utils import failover as FO

    w, h = args.width, args.height
    root = os.path.dirname(os.path.abspath(__file__))
    depth = 4

    # (a) the pipelined fetch ------------------------------------------------
    def pipelined_run(pipe, n=24):
        """render_frame_u8() n times at depth `pipe` on a fresh renderer,
        the camera moved a little before each (so that every frame differs);
        (renderer, frames, host ms of each call, peak GiB)."""
        e = engine(w, h)
        e.renderer = "pathtracer"
        r = e.renderer
        r.pipelined = pipe
        x0 = e.camera.x
        frames, ms = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(n):
            e.camera.x = x0 + 0.05 * i
            t = time.perf_counter()
            frames.append(r.render_frame_u8())
            ms.append((time.perf_counter() - t) * 1000.0)
        return r, frames, ms, torch.cuda.max_memory_allocated() / 2 ** 30

    def steady(ms):
        return statistics.median(ms[6:])

    # two rounds in the order 0, 4, 1, 1, 4, 0: every pipelined frame is
    # held against the first round's synchronous frames
    order = (0, depth, 1, 1, depth, 0)
    sync, runs = None, {0: [], 1: [], depth: []}
    for k, pipe in enumerate(order):
        r, frames, ms, peak = pipelined_run(pipe)
        if sync is None:
            sync = frames
            same = [i for i in range(len(sync) - 1) if np.array_equal(sync[i], sync[i + 1])]
            if same:
                fail(f"pipelined: synchronous frames {same} equal their successors; the "
                     "check could not tell frames apart")
        wrong = [i for i, f in enumerate(frames)
                 if not np.array_equal(f, sync[max(0, i - pipe)])]
        print(f"[serve] pipelined depth {pipe} (run {k + 1} of {len(order)}): {len(frames)} "
              f"frames against the synchronous frames of the warm-up rule (call i returns "
              f"frame max(0, i - {pipe})): tolerance: identical; {len(wrong)} differ -> "
              f"{'ok' if not wrong else 'FAIL'}; median steady frame {steady(ms):.2f} ms "
              f"(calls 7-{len(ms)})", flush=True)
        if wrong:
            fail(f"pipelined depth {pipe}: calls {wrong} differ from their synchronous frames")
        runs[pipe].append(ms)
        if pipe == depth:
            r4, ms4, peak4 = r, ms, peak
        del r, frames
    # device busy of this renderer's frame (torch.profiler over 2 frames of
    # _render_device); device_busy takes the median of frame_ms[1:], so it
    # is handed the steady calls after one more
    device_busy("serve-pipelined-depth4", r4, ms4[5:], peak4)
    busy = paths["serve-pipelined-depth4"]["device_busy_ms"]
    frame_ms = {pipe: [steady(ms) for ms in runs[pipe]] for pipe in (0, 1, depth)}
    ms_txt = "; ".join(f"depth {k} " + " / ".join(f"{v:.2f}" for v in vs)
                       for k, vs in frame_ms.items())
    idle_txt = "; ".join(f"depth {k} " + " / ".join(f"{1.0 - busy / v:.3f}" for v in vs)
                         for k, vs in frame_ms.items())
    print(f"[serve] median steady frame ms (calls 7-24, render_frame_u8, host wall time; "
          f"round 1 / round 2): {ms_txt}; device busy {busy:.3f} ms a frame; idle share "
          f"{idle_txt}", flush=True)
    paths["serve-pipelined-depth4"].update(
        frame_ms_steady={str(k): v for k, v in frame_ms.items()},
        frame_ms_all={str(k): v for k, v in runs.items()})

    def sync_calls(r, n=4):
        """{file:line: calls a frame} of the calls that synchronize with the
        device (torch.cuda.set_sync_debug_mode("warn")) over n more frames
        of `r`, each at the innermost line of this repository it came from."""
        seen = collections.Counter()

        package = os.path.join(root, "flexlight_tpu_torch")

        def hook(message, category, filename, lineno, file=None, line=None):
            if "called a synchronizing CUDA operation" not in str(message):
                return
            stack = traceback.extract_stack()[:-1]
            frames = ([fr for fr in stack if fr.filename.startswith(package)]
                      or [fr for fr in stack if fr.filename.startswith(root)])
            where = (f"{os.path.relpath(frames[-1].filename, root)}:{frames[-1].lineno}"
                     if frames else f"{filename}:{lineno}")
            seen[where] += 1

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(n):
                    r.render_frame_u8()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return {k: v / n for k, v in sorted(seen.items())}

    def blocking_upload(values, device):
        """The uploads before the repair: copies from pageable memory."""
        return torch.as_tensor(values, dtype=torch.float32, device=device)

    repaired = P.upload
    P.upload = F.upload = blocking_upload
    try:
        before = sync_calls(r4)
    finally:
        P.upload = F.upload = repaired
    after = sync_calls(r4)
    print(f"[serve] synchronizing calls a steady frame at depth {depth} "
          f"(set_sync_debug_mode, 4 frames): before the upload repair "
          f"{sum(before.values()):g} {before}; after {sum(after.values()):g} {after}",
          flush=True)
    paths["serve-pipelined-depth4"].update(sync_calls_before=before, sync_calls_after=after)
    del r4, sync
    torch.cuda.empty_cache()

    # (b) the frame server ---------------------------------------------------
    e = engine(w, h)
    e.renderer = "pathtracer"
    sr = e.renderer
    calls = collections.Counter()

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    sr.kernels = KernelSet(*(counting(n, k) for n, k in zip(KernelSet._fields, KERNELS)))
    per_frame = []   # (calls, launches, bounces) of each rendered frame
    real_render = sr._render_device

    def render_counted():
        c0, l0 = dict(calls), {n: k.launches for n, k in counted}
        out = real_render()
        per_frame.append(({n: calls[n] - c0.get(n, 0) for n in KernelSet._fields},
                          {n: k.launches - l0[n] for n, k in counted},
                          sr.config.max_reflections))
        return out

    sr._render_device = render_counted
    for _, k in counted:
        k.launches = 0
    server = FrameServer(e, port=0)
    url = server.start()

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as res:
            return res.status, res.headers.get("Content-Type"), res.read()

    def post(path, obj):
        req = urllib.request.Request(url + path, data=json.dumps(obj).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as res:
            return res.status, json.loads(res.read() or b"{}")

    def wait(n, what):
        if not server.wait_for_frame(n, timeout=300.0):
            fail(f"serve: {what}: the server served {server._seq} frames, not {n}")

    try:
        wait(8, "first frames")
        status, ctype, body = get("")
        if status != 200 or not ctype.startswith("text/html") or b"/frame.png" not in body:
            fail(f"serve: GET / answered {status} {ctype}")
        status, ctype, body = get("frame.png")
        img = decode_png(body)
        if status != 200 or ctype != "image/png" or img.shape != (h, w, 3) or img.max() == 0:
            fail(f"serve: /frame.png answered {status} {ctype}, {img.shape}, max {img.max()}")
        print(f"[serve] {url}: GET / 200 text/html; after {server._seq} frames /frame.png 200 "
              f"image/png decodes to {list(img.shape)} uint8, mean {img.mean():.2f}", flush=True)
        cam = e.camera
        pos0 = (cam.x, cam.y, cam.z)
        post("input", {"type": "keydown", "code": "KeyW"})
        wait(server._seq + 3, "frames with KeyW held")
        post("input", {"type": "keyup", "code": "KeyW"})
        pos1 = (cam.x, cam.y, cam.z)
        fx0 = cam.fx
        post("input", {"type": "mouse", "dx": 40, "dy": 0})
        if pos1 == pos0 or cam.fx == fx0:
            fail(f"serve: input did not reach the camera ({pos0} -> {pos1}, fx {fx0} -> "
                 f"{cam.fx})")
        print(f"[serve] POST /input: KeyW moved the camera {pos0} -> {pos1}; the mouse turned "
              f"it, fx {fx0:.4f} -> {cam.fx:.4f}", flush=True)
        status, accepted = post("config", {"max_reflections": 3})
        seq_config = server._seq
        wait(seq_config + 2, "frames after POST /config")
        knobs = json.loads(get("config")[2])
        if accepted != {"accepted": {"max_reflections": 3}} or knobs["max_reflections"] != 3:
            fail(f"serve: POST /config answered {accepted}, GET /config {knobs}")
        t_a, seq_a = time.perf_counter(), server._seq
        wait(seq_a + 8, "frames after the config change")
        t_b, seq_b = time.perf_counter(), server._seq
        stats = json.loads(get("stats")[2])
        if not stats["fps"] > 0 or stats["last"].get("scheme") != "fused_split":
            fail(f"serve: /stats {stats}")
        sr.freeze = True
        wait(server._seq + 2, "frames after freeze")
        n_since = sr._frame_count
        served = decode_png(get("frame.png")[2])
    finally:
        t = time.perf_counter()
        server.stop()
        stop_s = time.perf_counter() - t
    alive = [th.name for th in server._threads if th.is_alive()]
    print(f"[serve] stopped in {stop_s:.2f} s; threads alive after the join: {alive}",
          flush=True)
    if alive or stop_s > 10.0:
        fail("serve: the server's threads did not join within 10 s")
    launches = {n: k.launches for n, k in counted}
    served_fps = (seq_b - seq_a) / (t_b - t_a)
    steady_ms = [rec["frame_ms"] for rec in sr.metrics.records
                 if rec["max_reflections"] == 3][2:]
    print(f"[serve] served fps {served_fps:.2f} ({seq_b - seq_a} frames served in "
          f"{t_b - t_a:.2f} s after the config change; /stats fps {stats['fps']}); median "
          f"frame ms {statistics.median(steady_ms):.2f} (render_frame_u8 at depth {depth}, "
          f"{len(steady_ms)} frames); {len(per_frame)} frames rendered, {server._seq} served",
          flush=True)
    paths["serve-theater-1080p"] = {"served_fps": served_fps, "stats_fps": stats["fps"],
                                    "frame_ms_median": statistics.median(steady_ms),
                                    "frames_rendered": len(per_frame),
                                    "frames_served": server._seq, "stop_s": stop_s}

    # the counting KernelSet's calls and the wrappers' launches, frame by frame
    bounce_seq = [b for _, _, b in per_frame]
    k5 = bounce_seq.index(3) if 3 in bounce_seq else -1
    if k5 <= 0 or set(bounce_seq[:k5]) != {5} or set(bounce_seq[k5:]) != {3}:
        fail(f"serve: bounces per served frame {bounce_seq}, expected 5, ..., then 3, ...")
    wrong = []
    for i, (c, lau, b) in enumerate(per_frame):
        expect = {"sp_pre": 1, "sp_post": b, "first_blur": 3, "second_blur": 3,
                  "final_blur": 1, "fxaa": 1}
        got_calls = {n: v for n, v in c.items() if v}
        got_launches = {n: v for n, v in lau.items() if v}
        if got_calls != expect or got_launches != dict(expect, sp_live_list=b):
            wrong.append((i, got_calls, got_launches))
    print(f"[serve] kernels a served frame (the counting KernelSet's calls; the wrappers' "
          f"launches): {len(per_frame)} frames, bounces {bounce_seq[0]} then "
          f"{bounce_seq[-1]} from frame {k5}; {len(wrong)} frames off the expected PRE 1, "
          f"POST and its list once a bounce, 3 + 3 + 1 disc passes, FXAA 1 -> "
          f"{'ok' if not wrong else 'FAIL'}; launches in all {launches}", flush=True)
    if wrong:
        fail(f"serve: launches off on frames {wrong[:3]}")

    # the frozen frame against the plain frame of the same index: the camera
    # has not moved since the config change, which restarted the
    # accumulation, so the plain renderer replays that view
    index = max(0, n_since - 1 - depth)
    if not np.array_equal(served, sr._last_frame) or index < 3:
        fail(f"serve: the frozen served frame is not the renderer's last frame, or its "
             f"index {index} is too early to show the accumulation")
    pcam = Camera()
    pcam.x, pcam.y, pcam.z, pcam.fx, pcam.fy, pcam.fov = (cam.x, cam.y, cam.z, cam.fx,
                                                          cam.fy, cam.fov)
    plain = PathTracer(w, h, e.scene, pcam, e.config, dev, kernels=PLAIN)
    for _ in range(index + 1):
        ref = plain.render_frame_u8()
    count = int((served != ref).sum())
    print(f"[serve] frozen served frame: frame {index} of {n_since} rendered since the config "
          f"change (depth {depth}) against the same frame through the plain versions: "
          f"tolerance: identical; {count} values differ -> {'ok' if count == 0 else 'FAIL'}",
          flush=True)
    if count:
        fail("serve: the frozen served frame differs from its plain frame")
    del plain, e, sr, server
    torch.cuda.empty_cache()

    # (c) the checkpoint -------------------------------------------------------
    ck_dir = os.path.join(root, "build", "smoke")
    os.makedirs(ck_dir, exist_ok=True)
    ck_path = os.path.join(ck_dir, "state.npz")
    if os.path.exists(ck_path):
        os.remove(ck_path)
    timed = {}

    def timing(name, fn):
        def call(*a):
            t = time.perf_counter()
            out = fn(*a)
            timed[name] = time.perf_counter() - t
            return out
        return call

    real_fo = FO.snapshot_render_state, FO.write_render_state
    FO.snapshot_render_state = timing("snapshot", real_fo[0])
    FO.write_render_state = timing("write", real_fo[1])
    try:
        e = engine(w, h)
        e.renderer = "pathtracer"
        r = e.renderer
        runner = FO.FailoverRunner(r, ck_path, mirror_every=4)
        for _ in range(8):
            runner.step()
        runner.checkpoint_now()
    finally:
        FO.snapshot_render_state, FO.write_render_state = real_fo
    state_mb = sum(a.nbytes for a in runner._mirror["arrays"].values()) / 1e6
    file_mb = os.path.getsize(ck_path) / 1e6
    uninterrupted = r.render_frame()
    del runner, r, e
    torch.cuda.empty_cache()
    e = engine(w, h)
    e.renderer = "pathtracer"
    runner = FO.FailoverRunner(e.renderer, ck_path)
    t = time.perf_counter()
    resumed_ok = runner.resume()
    load_s = time.perf_counter() - t
    if not resumed_ok or e.renderer._frame_count != 8:
        fail(f"checkpoint: resume() {resumed_ok}, frame count {e.renderer._frame_count}")
    resumed = runner.step()
    count = int((resumed != uninterrupted).sum())
    print(f"[serve] checkpoint: FailoverRunner, 8 frames (mirror_every 4), checkpoint_now(): "
          f"snapshot {timed['snapshot']:.3f} s, write {timed['write']:.3f} s ({state_mb:.1f} MB "
          f"of state, {file_mb:.1f} MB file), resume {load_s:.3f} s; the resumed renderer's "
          f"next frame against the uninterrupted one: tolerance: identical; {count} values "
          f"differ -> {'ok' if count == 0 else 'FAIL'}", flush=True)
    if count:
        fail("checkpoint: the resumed frame differs from the uninterrupted one")
    paths["checkpoint-theater-1080p"] = {"snapshot_s": timed["snapshot"],
                                         "write_s": timed["write"], "resume_s": load_s,
                                         "state_mb": state_mb, "file_mb": file_mb}
    os.remove(ck_path)
    del runner, e
    torch.cuda.empty_cache()
    summary = {k: v for k, v in paths.items() if k.startswith(("serve", "checkpoint"))}
    print(f"[serve] {json.dumps(summary)}", flush=True)
    return launches



def _leaves(t):
    for x in t:
        if isinstance(x, tuple):
            yield from _leaves(x)
        else:
            yield x


def _digest(buffers) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in _leaves(buffers):
        h.update(str(tuple(x.shape)).encode() + str(x.dtype).encode())
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_main(rank: int, out_dir: str, width: int, height: int, seed: int, n_frames: int):
    """One of phase 11's two ranks (start method spawn): both render on
    cuda:0 over a "cpu" (gloo) mesh, since NCCL takes one rank a card. It
    joins the group through a file store under `out_dir`, takes rank 0's
    scene buffers (f), renders n_frames of the strip-sharded headline
    pipeline on a tile-2 mesh (d) and one 2-spp MRT on a tile-1 x sample-2
    mesh (e), and writes what it got, its frame ms and its kernels'
    launches to out_dir/rank<r>.pt. An exception fails its process, and so
    the phase."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flexlight_tpu_torch import Config, reset_global_registry
    from flexlight_tpu_torch.kernels import KERNELS, KernelSet
    from flexlight_tpu_torch.ops.buffers import build_scene_buffers
    from flexlight_tpu_torch.parallel import multihost
    from flexlight_tpu_torch.parallel import tile_sharding as T
    from flexlight_tpu_torch.post.taa import taa_history
    from flexlight_tpu_torch.post.temporal import TemporalState
    from flexlight_tpu_torch.scenes import stand_in_wood_texture, theater

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    multihost.initialize(f"file://{os.path.join(out_dir, 'store')}", 2, rank)
    config = Config(temporal=True, temporal_samples=4, filter=True, antialiasing="fxaa",
                    samples_per_ray=1, max_reflections=5)
    reset_global_registry()
    e = theater(stand_in_wood_texture(seed), device=dev)
    local = build_scene_buffers(e.scene, dev)
    res = {"local_digest": _digest(local)}
    # (f) rank 1 starts from zeros of the leader's shapes
    mine = local if rank == 0 else type(local)(*(
        type(x)(*(torch.zeros_like(y) for y in x)) if isinstance(x, tuple)
        else torch.zeros_like(x) for x in local))
    res["zeros_before"] = rank == 1 and all(float(x.abs().max()) == 0.0 for x in _leaves(mine)
                                            if x.numel())
    buffers = multihost.broadcast_scene(mine)
    res["digest"] = _digest(buffers)
    res["is_leader"] = multihost.is_leader()

    # (d) the strip-sharded headline: two 540-row strips, halo pipeline
    mesh = T.make_mesh(2, 1, "cpu")
    pos, view = e.camera.position, e.camera.view_matrix(width, height)
    temporal = TemporalState.create(config.temporal_samples, height, width, dev)
    taa = taa_history(config.antialiasing, height, width, dev)
    for k in KERNELS:
        k.launches = 0
    displays, frame_ms = [], []
    for f in range(n_frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        display, temporal, taa = T.frame_pipeline_sharded_halo(
            buffers, pos, view, float(f % config.temporal_samples), temporal, taa, width,
            height, config, mesh, scheme="fused_split", kernels=KERNELS)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1000.0)
        displays.append(display.cpu())
    res["displays"] = displays
    res["frame_ms"] = frame_ms
    res["launches"] = {name: k.launches for name, k in zip(KernelSet._fields, KERNELS)
                       if k.launches}
    res["halo"] = min(max(32, T.required_post_halo(config)), height // 2)

    # (e) the sample-sharded MRT at 2 spp
    mesh2 = T.make_mesh(1, 2, "cpu")
    cfg2 = config.replace(samples_per_ray=2)
    res["mrt"] = tuple(x.cpu() for x in T.render_mrt_sharded(
        buffers, width, height, pos, view, cfg2, 0.0, mesh2, scheme="fused_split",
        kernels=KERNELS))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    # a barrier on a host tensor: gloo's, never NCCL's on this shared card
    torch.distributed.all_reduce(torch.zeros(1))
    torch.distributed.destroy_process_group()


def casts_and_ranks_phase(args, dev, smi: str, engine, dragon_engine, tools) -> dict:
    """Phase 11, this slice's paths: (a) the path tracer on theater at the
    headline config on scheme="mxu", against the same frames on
    scheme="kernel"; (b) the dragon stand-in at the direct config
    (bench.py:68-91: 1 spp, 5 bounces, no post) on scheme="clustered",
    its MRT against the scheme="sparse" MRT of the same frame; (c) the
    rasterizer at half size on scheme="mxu" (theater, against "kernel") and
    "clustered" (the dragon stand-in, against "sparse"); (d)-(f) two
    spawned ranks on this one card over a gloo mesh: the strip-sharded
    headline pipeline (frame_pipeline_sharded_halo, tile 2) against the
    one-process frames of the same seeds and states, the sample-sharded
    2-spp MRT (render_mrt_sharded, tile 1 x sample 2) against the
    one-process MRT, and broadcast_scene. `tools` holds phase 4's
    drive_frames / expect_launches / device_busy, the counted wrappers
    and the paths dict. Returns each path's launches for the kernels
    line."""
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from flexlight_tpu_torch import Config
    from flexlight_tpu_torch.kernels import KERNELS
    from flexlight_tpu_torch.models.pathtracer import frame_pipeline
    from flexlight_tpu_torch.ops.buffers import build_scene_buffers
    from flexlight_tpu_torch.ops.pathtrace import render_mrt
    from flexlight_tpu_torch.post.taa import taa_history
    from flexlight_tpu_torch.post.temporal import TemporalState

    w, h = args.width, args.height
    w2, h2 = w // 2, h // 2
    n = 2
    launches = {}
    disc = {"first_blur": 3, "second_blur": 3, "final_blur": 1, "fxaa": 1}
    off = {name: 0 for name in ("closest_hit", "any_hit", "sp_pre", "sp_post", "sparse_flags",
                                "sparse_key", "sparse_closest", "sparse_any", "fused_frame",
                                "shade", "interp_shade")}

    def busy_line(label, renderer, frame_ms, peak, n_profiled=2):
        """device_busy, then its numbers again beside the card's name and
        power limit."""
        tools.device_busy(label, renderer, frame_ms, peak, n_profiled=n_profiled)
        p = tools.paths[label]
        print(f"[{label}] frame {p['frame_ms_median']:.1f} ms, device busy "
              f"{p['device_busy_ms']:.3f} ms, peak {p['peak_gib']:.2f} GiB | {smi}", flush=True)

    # (a) mxu: theater, the headline, 1920 x 1080 ----------------------------
    e = engine(w, h)
    e.renderer = "pathtracer"
    e.renderer.scheme = "kernel"
    ref = tools.drive_frames("mxu-reference, scheme 'kernel'", e.renderer, n)[0]
    e = engine(w, h)
    e.renderer = "pathtracer"
    e.renderer.scheme = "mxu"
    frames, counts, frame_ms, peak = tools.drive_frames("mxu", e.renderer, n)
    tools.expect_launches("theater on scheme='mxu'", counts, n, dict(off, **disc))
    differ = sum(int((a != b).any(axis=-1).sum()) for a, b in zip(frames, ref))
    print(f"[mxu] theater {w}x{h}, headline config: {n} frames against the same frames on "
          f"scheme 'kernel' (the same k-order products and accept window): tolerance: "
          f"identical; {differ} pixels differ -> {'ok' if differ == 0 else 'FAIL'}", flush=True)
    if differ:
        fail("scheme='mxu' renders other frames than scheme='kernel'")
    if not np.isfinite(frames[-1]).all() or float(frames[-1].max()) <= 0.0:
        fail("mxu: the frame is not finite or all black")
    busy_line(f"mxu-theater-{h}p", e.renderer, frame_ms, peak)
    launches["mxu"] = counts
    del e, frames, ref
    torch.cuda.empty_cache()

    # (b) clustered: the dragon stand-in, direct config, 1920 x 1080 ---------
    direct = Config(temporal=False, filter=False, antialiasing=None, samples_per_ray=1,
                    max_reflections=5)
    e, _ = tools.dragon_direct(w, h, direct)
    e.renderer.scheme = "clustered"
    frames, counts, frame_ms, peak = tools.drive_frames("clustered", e.renderer, 1)
    tools.expect_launches("the dragon stand-in on scheme='clustered'", counts, 1,
                          dict(off, first_blur=0, second_blur=0, final_blur=0, fxaa=0))
    if not np.isfinite(frames[-1]).all() or float(frames[-1].max()) <= 0.0:
        fail("clustered: the frame is not finite or all black")
    buffers = e.renderer._buffers
    mrt_args = (buffers, w, h, e.camera.position, e.camera.view_matrix(w, h), direct, 0.0)
    # the MRT pass between two CUDA events (the profiler's per-kernel
    # records of ~10^6 small torch kernels would cost more than the frame)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    mrt_c = render_mrt(*mrt_args, scheme="clustered")
    end.record()
    end.synchronize()
    mrt_ms = (time.perf_counter() - t) * 1000.0
    event_ms = start.elapsed_time(end)
    tools.paths[f"clustered-dragon-{h}p-direct"] = {
        "frame_ms_median": frame_ms[0], "frame_ms": frame_ms, "mrt_ms": mrt_ms,
        "mrt_device_ms_events": event_ms, "peak_gib": peak}
    print(f"[clustered] dragon stand-in {w}x{h}, direct config: frame {frame_ms[0]:.1f} ms "
          f"(render_frame), its MRT pass {mrt_ms:.1f} ms on the host, {event_ms:.1f} ms "
          f"between CUDA events on the device (idle gaps included; busy not measured), peak "
          f"device memory {peak:.2f} GiB | {smi}", flush=True)
    mrt_s = render_mrt(*mrt_args, scheme="sparse", kernels=KERNELS)
    n_px = w * h
    differ = torch.zeros(n_px, dtype=torch.bool, device=dev)
    for a, b in zip(mrt_c, mrt_s):
        differ |= (a != b).reshape(n_px, -1).any(dim=-1)
    share = float(differ.float().mean())
    print(f"[clustered] its MRT against the scheme 'sparse' MRT of the same frame (the same "
          f"record products; a ray whose two nearest triangles lie within rounding of each "
          f"other may take either): {int(differ.sum())} of {n_px} pixels differ "
          f"({share:.4%}; bound {KNIFE_EDGE_SHARE:.2%}) -> "
          f"{'ok' if share <= KNIFE_EDGE_SHARE else 'FAIL'}", flush=True)
    if share > KNIFE_EDGE_SHARE:
        fail("the clustered MRT differs from the sparse MRT beyond the knife-edge share")
    launches["clustered"] = counts
    del e, frames, mrt_c, mrt_s, buffers, mrt_args
    torch.cuda.empty_cache()

    # (c) the rasterizer on both schemes, 960 x 540 --------------------------
    raster_config = Config()
    e = engine(w2, h2)
    e.config = raster_config
    e.renderer.scheme = "kernel"
    ref = tools.drive_frames("raster-mxu-reference, scheme 'kernel'", e.renderer, n)[0]
    e = engine(w2, h2)
    e.config = raster_config
    e.renderer.scheme = "mxu"
    layers = e.renderer.resolved_layers()
    frames, counts, frame_ms, peak = tools.drive_frames("raster-mxu", e.renderer, n)
    tools.expect_launches("the rasterizer on scheme='mxu'", counts, n,
                          dict(off, fxaa=1, **raster_shading(e.renderer)))
    differ = sum(int((a != b).any(axis=-1).sum()) for a, b in zip(frames, ref))
    print(f"[raster-mxu] theater {w2}x{h2}, {layers} layers: against the scheme 'kernel' "
          f"frames: tolerance: identical; {differ} pixels differ -> "
          f"{'ok' if differ == 0 else 'FAIL'}", flush=True)
    if differ:
        fail("the rasterizer on scheme='mxu' renders other frames than on 'kernel'")
    busy_line(f"rasterizer-mxu-theater-{h2}p", e.renderer, frame_ms, peak)
    launches["raster_mxu"] = counts
    e, _ = tools.dragon_direct(w2, h2, raster_config, renderer="rasterizer")
    e.renderer.scheme = "sparse"
    ref = tools.drive_frames("raster-clustered-reference, scheme 'sparse'", e.renderer, 1)[0]
    e.renderer.scheme = "clustered"
    layers = e.renderer.resolved_layers()
    frames, counts, frame_ms, peak = tools.drive_frames("raster-clustered", e.renderer, 1)
    tools.expect_launches("the rasterizer on scheme='clustered'", counts, 1,
                          dict(off, fxaa=1, **raster_shading(e.renderer)))
    differ = int((frames[0] != ref[0]).any(axis=-1).sum())
    share = differ / (w2 * h2)
    print(f"[raster-clustered] dragon stand-in {w2}x{h2}, {layers} layers: against the "
          f"scheme 'sparse' frame: {differ} pixels differ ({share:.4%}; bound "
          f"{KNIFE_EDGE_SHARE:.2%}) -> {'ok' if share <= KNIFE_EDGE_SHARE else 'FAIL'}",
          flush=True)
    if share > KNIFE_EDGE_SHARE:
        fail("the rasterizer on scheme='clustered' differs from 'sparse' beyond the bound")
    busy_line(f"rasterizer-clustered-dragon-{h2}p", e.renderer, frame_ms, peak, n_profiled=1)
    launches["raster_clustered"] = counts
    del e, frames, ref
    torch.cuda.empty_cache()

    # (d)-(f) two ranks on this card over a gloo mesh ------------------------
    n_ranks_frames = 3
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke",
                           "ranks")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t = time.perf_counter()
    try:
        mp.start_processes(rank_main, args=(out_dir, w, h, args.seed, n_ranks_frames),
                           nprocs=2, start_method="spawn")
    except Exception as exc:  # a rank's failure fails the run
        fail(f"a rank failed: {exc}")
    spawn_s = time.perf_counter() - t
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    shutil.rmtree(out_dir, ignore_errors=True)

    # the one-process frames of the same seeds and states
    e = engine(w, h)
    config = e.config
    buffers = build_scene_buffers(e.scene, dev)
    pos, view = e.camera.position, e.camera.view_matrix(w, h)
    temporal = TemporalState.create(config.temporal_samples, h, w, dev)
    taa = taa_history(config.antialiasing, h, w, dev)
    one, one_ms = [], []
    for f in range(n_ranks_frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        display, temporal, taa = frame_pipeline(buffers, pos, view,
                                                float(f % config.temporal_samples), temporal,
                                                taa, w, h, config, KERNELS,
                                                scheme="fused_split")
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t) * 1000.0)
        one.append(display.cpu())
    # identical, the blur key of the tile row that straddles the strip
    # border (rows 512-543 of 32-row tiles, summed from the strips' partial
    # sums) included: 0 pixels differed on the H100 in every run so far
    halo = ranks[0]["halo"]
    differ = [[int((got != want).any(dim=-1).sum()) for got, want in
               zip(ranks[r]["displays"], one)] for r in range(2)]
    same = not any(map(any, differ))
    print(f"[ranks] tile 2 (two {h // 2}-row strips, halo {halo}), frame_pipeline_sharded_halo on "
          f"theater {w}x{h}, headline config, {n_ranks_frames} frames, against the one-process "
          f"frames of the same seeds and states: tolerance: identical; pixels that differ, "
          f"rank 0 {differ[0]}, rank 1 {differ[1]} -> {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail("a sharded display differs from the one-process display")
    a_frame = {"sp_pre": 1, "sp_post": 5, "first_blur": 3, "second_blur": 3, "final_blur": 1,
               "fxaa": 1}
    for r in range(2):
        per_frame = {k: c / n_ranks_frames for k, c in ranks[r]["launches"].items()}
        print(f"[ranks] rank {r}'s launches a frame {per_frame} (expected {a_frame}) -> "
              f"{'ok' if per_frame == a_frame else 'FAIL'}", flush=True)
        if per_frame != a_frame:
            fail(f"rank {r} did not launch the one-process frame's kernels")
    print(f"[ranks] frame ms, two ranks sharing one card, not a scaling number: sharded "
          f"rank 0 {[round(x, 1) for x in ranks[0]['frame_ms']]}, rank 1 "
          f"{[round(x, 1) for x in ranks[1]['frame_ms']]}; one process "
          f"{[round(x, 1) for x in one_ms]} (the spawn, both ranks' start-up included, "
          f"{spawn_s:.1f} s) | {smi}", flush=True)
    tools.paths[f"ranks-theater-{h}p-halo"] = {"sharded_ms": ranks[0]["frame_ms"],
                                               "one_process_ms": one_ms,
                                               "note": "two ranks sharing one card"}

    # (e) the sample-sharded MRT against one process's
    cfg2 = config.replace(samples_per_ray=2)
    ref_mrt = render_mrt(buffers, w, h, pos, view, cfg2, 0.0, scheme="fused_split",
                         kernels=KERNELS)
    for r in range(2):
        got = ranks[r]["mrt"]
        cerr = float((got[0] - ref_mrt.color.cpu()).abs().max())
        others = {f: int((a != b.cpu()).sum()) for f, a, b in
                  zip(ref_mrt._fields[1:], got[1:], ref_mrt[1:])}
        ok = cerr <= 1e-4 and not any(others.values())
        print(f"[ranks] rank {r}: tile 1 x sample 2, render_mrt_sharded at 2 spp against "
              f"the one-process MRT: colour max abs {cerr:.3g} (tolerance 1e-4), other "
              f"channels' differing values {others} (tolerance: identical) -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("the sample-sharded MRT differs from the one-process MRT")
    # (f) the scene broadcast
    local = _digest(buffers)
    same = ranks[0]["digest"] == ranks[1]["digest"] == local
    print(f"[ranks] broadcast_scene: rank 1 started from zeros ({ranks[1]['zeros_before']}), "
          f"both ranks hold identical buffers, equal to this process's: {same}; leaders "
          f"{[x['is_leader'] for x in ranks]} -> {'ok' if same else 'FAIL'}", flush=True)
    if not same or not ranks[1]["zeros_before"] or [x["is_leader"] for x in ranks] != [True,
                                                                                          False]:
        fail("broadcast_scene did not give both ranks the leader's buffers")
    launches["ranks"] = ranks[0]["launches"]
    del e, buffers, temporal, taa, ref_mrt
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    args = ap.parse_args()

    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device: chip_smoke.py drives the port on a CUDA "
              "card and has nothing to check without one", flush=True)
        return 2
    smi = nvidia_smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    return drive(args, torch.device("cuda:0"), smi)


def drive(args, dev, smi: str) -> int:
    """Phases 2-10 on `dev`."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from flexlight_tpu_torch import Config, _native, reset_global_registry
        from flexlight_tpu_torch.kernels import KERNELS, PLAIN, KernelSet
        from flexlight_tpu_torch.models.pathtracer import PathTracer
        from flexlight_tpu_torch.ops import fused as F
        from flexlight_tpu_torch.ops import fused_kernel as SK
        from flexlight_tpu_torch.ops import shade as H
        from flexlight_tpu_torch.ops import shade_kernel as HK
        from flexlight_tpu_torch.ops.intersect import BIAS, POW32
        from flexlight_tpu_torch.ops.geometry import world_geometry
        from flexlight_tpu_torch.ops.intersect_kernel import _safe_dirs, build_w4
        from flexlight_tpu_torch.ops.buffers import build_scene_buffers
        from flexlight_tpu_torch.ops.intersect_sparse import REC
        from flexlight_tpu_torch.ops.intersect_sparse_kernel import (CAST_LANES, EXIT_ABS,
                                                                     EXIT_REL, TRI_TILE,
                                                                     cluster_minima_plain,
                                                                     record_products)
        from flexlight_tpu_torch.ops.pathtrace import (camera_rays, inverse_view, render_mrt,
                                                       sample_cos)
        from flexlight_tpu_torch.post.filter_kernel import byte_i
        from flexlight_tpu_torch.scenes import dragon, stand_in_wood_texture, theater, wave
    except ImportError as exc:
        fail(f"the flexlight_tpu_torch package is not importable beside this script: {exc}")
    t_start = time.perf_counter()

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib = _native.library()
    print(f"[build] kernels built and loaded from flexlight_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for fn, use in sorted(ptxas_usage(_native.build_log(lib)).items()):
        print(f"[build] {fn}: {use.get('registers')} registers, {use.get('stack')} bytes "
              f"stack, {use.get('spill_st')}/{use.get('spill_ld')} bytes spill stores/loads, "
              f"{use.get('smem', 0)} bytes static shared memory",
              flush=True)

    w, h = args.width, args.height
    config = Config(temporal=True, temporal_samples=4, filter=True,
                    antialiasing="fxaa", samples_per_ray=1, max_reflections=5)
    texture = stand_in_wood_texture(args.seed)

    def engine(width, height):
        reset_global_registry()
        e = theater(texture, device=dev)
        e.canvas = (width, height)
        e.config = config
        return e

    objects = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "objects")

    def dragon_engine(width, height):
        """The dragon stand-in from --seed on a FlexLight of width x height;
        (engine, animate)."""
        reset_global_registry()
        e, animate = dragon(args.seed, objects, device=dev)
        e.canvas = (width, height)
        e.config = config
        return e, animate

    def wave_engine(width, height):
        """wave on a FlexLight of width x height; (engine, animate)."""
        reset_global_registry()
        e, animate = wave(device=dev)
        e.canvas = (width, height)
        e.config = config
        return e, animate

    def fused_frame_args(buffers, camera, cfg):
        """fused_frame's inputs for camera's w x h frame over `buffers`
        (seed 0), as render_mrt(scheme="fused") passes them."""
        cam, dirs, ndc, w4, ids, mat = F.frame_inputs(buffers, w, h, camera.position,
                                                      camera.view_matrix(w, h))
        cos = torch.tensor([sample_cos(s) for s in range(cfg.samples_per_ray)],
                           dtype=torch.float32, device=dev)
        return (dirs, ndc, w4, ids, mat, buffers.lights.contiguous(), buffers.ambient,
                buffers.albedo_tab, buffers.pbr_tab, buffers.tpo_tab, cam,
                torch.tensor(0.0, device=dev), cos, cfg)

    sparse_names = ("sparse_flags", "sparse_key", "sparse_closest", "sparse_any")
    in_place = ("sp_pre", "sp_post", "shade", "interp_shade")
    traversal = ("closest_hit", "any_hit")
    disc_names = ("first_blur", "second_blur", "final_blur")
    raster_names = ("raster_surface", "raster_rays", "raster_shade")

    # ---- the frames of phases 4-11, through the user's entry points ---------
    # every kernel wrapper with its count: the KernelSet's and the lists of
    # POST (and shade) and of interp_shade
    counted = list(zip(KernelSet._fields, KERNELS)) + [("sp_live_list", SK.sp_live_list),
                                                       ("alive_list", HK.alive_list)]

    def drive_frames(label, renderer, n_frames, step=None):
        """render_frame() n_frames times with every count set to 0 just
        before; (frames, launches of the run)."""
        for _, k in counted:
            k.launches = 0
        frames, frame_ms = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(n_frames):
            if step is not None:
                step(i)
            t = time.perf_counter()
            frames.append(renderer.render_frame())
            frame_ms.append((time.perf_counter() - t) * 1000.0)
        counts = {name: k.launches for name, k in counted}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{label}] {n_frames} frames, scheme {renderer.metrics.last['scheme']!r}, "
              f"shade_kernel {getattr(renderer, 'shade_kernel', None)}: ms per frame "
              f"{[round(x, 1) for x in frame_ms]} (median of frames 2..: "
              f"{statistics.median(frame_ms[1:] or frame_ms):.1f} ms); peak device memory "
              f"{peak_gb:.2f} GiB; launches per frame "
              f"{ {n: c / n_frames for n, c in counts.items() if c} }", flush=True)
        return frames, counts, frame_ms, peak_gb

    def expect_launches(label, counts, n_frames, expect):
        """Fail unless each kernel of `expect` ran its count per frame."""
        wrong = {name: counts[name] / n_frames for name, c in expect.items()
                 if counts[name] != c * n_frames}
        if wrong:
            fail(f"{label}: launches per frame {wrong}, expected {expect}")

    def check_frames(label, frames, plain_frames, shape):
        """The last frame's shape, finite values and light; each frame
        within the golden budget of its plain frame."""
        last = frames[-1]
        if last.shape != shape:
            fail(f"{label}: frame shape {last.shape}")
        if not np.isfinite(last).all():
            fail(f"{label}: frame has non-finite values")
        if float(last.max()) <= 0.0:
            fail(f"{label}: frame is all black")
        for i, (a, b) in enumerate(zip(frames, plain_frames)):
            frac, mx = golden_budget(torch.from_numpy(a), b)
            print(f"[{label}] frame {i}: kernels vs plain: {frac:.4%} of values over 2e-3, "
                  f"max {mx:.4f} (budget 1%, 0.5)", flush=True)
            if frac > 0.01 or mx > 0.5:
                fail(f"{label}: kernel frame outside the golden budget of the plain frame")
        print(f"[{label}] output {list(last.shape)}, mean {float(last.mean()):.4f}, finite",
              flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    paths = {}

    def device_busy(label, renderer, frame_ms, peak_gb, step=None, n_profiled=2):
        """Device ms a frame (torch.profiler: the sum of the device time of
        every kernel over n_profiled more frames of the renderer's
        _render_device(), as tools/profile_frame.py takes it) beside the
        median host ms of the counted frames and their peak memory."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(n_profiled):
                if step is not None:
                    step(100 + i)
                renderer._render_device()
            torch.cuda.synchronize()
        busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA) / 1000.0 / n_profiled
        if busy <= 0.0:
            fail(f"{label}: the profiler recorded no device time")
        med = statistics.median(frame_ms[1:] or frame_ms)
        paths[label] = {"frame_ms_median": med, "frame_ms": frame_ms, "device_busy_ms": busy,
                        "idle_share": 1.0 - busy / med, "peak_gib": peak_gb}
        print(f"[{label}] median frame {med:.1f} ms (frames 2..), device busy {busy:.3f} ms a "
              f"frame (torch.profiler, {n_profiled} frames), idle share {1.0 - busy / med:.3f}, "
              f"peak device memory {peak_gb:.2f} GiB", flush=True)

    def expect_identical(label, frames, plain_frames):
        """The kernels are bit-exact with their plain versions, so each frame
        must equal its plain frame value for value, beside the golden
        budget that check_frames holds it to."""
        count = sum(int((torch.from_numpy(a) != b).sum()) for a, b in zip(frames, plain_frames))
        print(f"[{label}] kernels vs plain frames: tolerance: identical; {count} values differ "
              f"-> {'ok' if count == 0 else 'FAIL'}", flush=True)
        if count:
            fail(f"{label}: {count} values differ from the plain frames")

    def dragon_direct(width, height, cfg, renderer="pathtracer"):
        """The dragon stand-in with `cfg` on `renderer`; (engine, animate)."""
        e, animate = dragon_engine(width, height)
        e.config = cfg
        e.renderer = renderer
        return e, animate

    tools = types.SimpleNamespace(drive_frames=drive_frames, expect_launches=expect_launches,
                                  device_busy=device_busy, dragon_direct=dragon_direct,
                                  counted=counted, paths=paths)
    # ---- 3. kernels vs plain --------------------------------------------
    t0 = time.perf_counter()

    def clone(a):
        return tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a)

    captured = {}

    def first_call(name, fn):
        def rec(*a):
            captured.setdefault(name, a)
            return fn(*a)
        return rec

    def every_call(name, fn):
        """The fused and shading kernels update their blocks in place: keep
        a copy of the inputs of every call, made before it."""
        def rec(*a):
            captured.setdefault(name, []).append(clone(a))
            return fn(*a)
        return rec

    # every call of the disc passes of one theater (fused_split), dragon
    # stand-in (sparse) and wave (fused) frame: {frame: [(name, args)]}
    disc_calls = {"theater": [], "dragon": [], "wave": []}

    def disc_call(frame, name, fn):
        def rec(*a):
            disc_calls[frame].append((name, clone(a)))
            return fn(*a)
        return rec

    def recording_disc(kset, frame):
        return kset._replace(**{n: disc_call(frame, n, getattr(kset, n)) for n in disc_names})

    # one fused_split frame and one scheme="kernel" frame (shade_kernel on)
    # with the plain versions, recording the kernels' inputs (the traversal
    # kernels' on every cast)
    rec_set = KernelSet(*(every_call(n, f) if n in in_place + traversal else first_call(n, f)
                          for n, f in zip(KernelSet._fields, PLAIN)))
    # the worklist kernels' inputs: every call of one dragon stand-in frame
    # through the kernels (flags: primary, then shadow b and bounce b + 1 in
    # turn; key: the same but the primary; closest hit: primary, bounces
    # 1-4; any hit: shadows 0-4)
    bounces = config.max_reflections
    keep = {"sparse_flags": 2 * bounces, "sparse_key": 2 * bounces - 1,
            "sparse_closest": bounces, "sparse_any": bounces}
    sparse_calls = {name: [] for name in sparse_names}

    def first_calls(name, fn):
        def rec(*a):
            if len(sparse_calls[name]) < keep[name]:
                sparse_calls[name].append(a)
            return fn(*a)
        return rec

    de, animate = dragon_engine(w, h)
    tracer = PathTracer(w, h, de.scene, de.camera, config, dev, shade_kernel=True,
                        kernels=recording_disc(KERNELS, "dragon")._replace(
        **{name: first_calls(name, getattr(KERNELS, name)) for name in sparse_names},
        interp_shade=every_call("interp_shade", KERNELS.interp_shade)))
    if tracer.resolved_scheme() != "sparse":
        fail(f"the dragon stand-in resolves to scheme {tracer.resolved_scheme()!r}, not sparse")
    animate(0)
    for k in KERNELS:
        k.launches = 0
    tracer.render_frame()
    print("[kernel] the dragon frame (shade_kernel on) launched " + ", ".join(
        f"{name} {getattr(KERNELS, name).launches}x" for name in sparse_names + ("interp_shade",)),
        flush=True)
    # the traversal kernels at the top of their range (the kernel scheme
    # serves up to 4095 triangles): the stand-in's first 4095 triangles and
    # its camera rays
    big_w4, big_ids = build_w4(world_geometry(tracer._buffers),
                               tracer._buffers.id_buffer[:4095])
    big_cam = torch.as_tensor(de.camera.position, dtype=torch.float32, device=dev)
    big_dirs = camera_rays(w, h, big_cam, inverse_view(de.camera.view_matrix(w, h)).to(dev))[1]
    del tracer, de
    if any(len(sparse_calls[name]) < keep[name] for name in sparse_names):
        fail(f"the dragon frame made too few worklist casts: "
             f"{ {name: len(c) for name, c in sparse_calls.items()} }")
    e = engine(w, h)
    tracer = PathTracer(w, h, e.scene, e.camera, config, dev,
                        kernels=recording_disc(rec_set, "theater"))
    if tracer.resolved_scheme() != "fused_split":
        fail(f"theater resolves to scheme {tracer.resolved_scheme()!r}, not fused_split")
    tracer.render_frame()
    PathTracer(w, h, e.scene, e.camera, config, dev, scheme="kernel", kernels=rec_set,
               shade_kernel=True).render_frame()
    resample = []

    def sp_pre_resample(*a):
        if a[6]:  # the `resample` argument
            resample.append(clone(a))
        return PLAIN.sp_pre(*a)

    PathTracer(w, h, e.scene, e.camera, config.replace(samples_per_ray=2), dev,
               kernels=PLAIN._replace(sp_pre=sp_pre_resample)).render_frame()
    del tracer
    missing = [n for n in KernelSet._fields
               if n not in captured
               and n not in sparse_names + disc_names + raster_names + ("fused_frame",)]
    if missing or len(resample) != 1:
        fail(f"the frames did not reach {missing or 'a resampling PRE'}")
    calls = {n: len(captured[n]) for n in in_place + traversal}
    if calls != {"sp_pre": 1, "sp_post": bounces, "shade": bounces, "interp_shade": bounces,
                 "closest_hit": bounces, "any_hit": bounces}:
        fail(f"the frames made {calls} calls of the in-place and traversal kernels")

    results = {}

    def differences(ko, po, packed: bool):
        """(number of differing elements, max abs difference) of the
        kernel's and the plain version's outputs (NaN equals NaN); on
        packed rgba8 planes the difference is the largest byte step / 255."""
        ko = ko if isinstance(ko, tuple) else (ko,)
        po = po if isinstance(po, tuple) else (po,)
        count, err = 0, 0.0
        for a, b in zip(ko, po):
            differ = a != b
            if a.dtype.is_floating_point:
                differ &= ~(torch.isnan(a) & torch.isnan(b))
            count += int(differ.sum())
            if packed:
                step = max(int((byte_i(a, i) - byte_i(b, i)).abs().max()) for i in range(4))
                err = max(err, step / 255.0)
            elif count:
                err = max(err, float((a.double() - b.double())[differ].abs().max()))
        return count, err

    def report(name, label, count, err, k_ms, p_ms, bnd, main: bool, extra=""):
        print(f"[kernel] {name} ({label}): tolerance: identical to the plain version "
              f"(same operations in the same order, no fma contraction); "
              f"{count} values differ, max abs {err:.3g}{extra} -> "
              f"{'ok' if count == 0 else 'FAIL'}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]})", flush=True)
        prev = results.get(name)
        if main:
            results[name] = {"max_abs_err": max(err, prev["max_abs_err"] if prev else 0.0),
                             "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                             "bound_by": bnd[1], "library_ms": None}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)
        if count:
            fail(f"{name} ({label}) disagrees with its plain version")

    def check(name, label, args_, bnd, packed=False, main=True):
        """Kernel vs plain on one input: the outputs must be identical.
        Returns (kernel ms, plain ms)."""
        kernel_fn = lambda: getattr(KERNELS, name)(*args_)  # noqa: E731
        plain_fn = lambda: getattr(PLAIN, name)(*args_)  # noqa: E731
        count, err = differences(kernel_fn(), plain_fn(), packed)
        k_ms, p_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        report(name, label, count, err, k_ms, p_ms, bnd, main)
        return k_ms, p_ms

    def check_state(name, label, args_, bnd, main=True):
        """The same for the kernels that update their blocks in place (PRE /
        POST: the state, args_[0]; shade / interp_shade: the state and the
        request, args_[0:2]): each side runs on its own copy of the recorded
        blocks."""
        blocks = 2 if name in ("shade", "interp_shade") else 1
        ka, pa = clone(args_), clone(args_)
        ko = getattr(KERNELS, name)(*ka)
        po = getattr(PLAIN, name)(*pa)
        ko = ko if isinstance(ko, tuple) else (ko,)
        po = po if isinstance(po, tuple) else (po,)
        count, err = differences(ko, po, False)
        extra = ""
        if count:
            for block, a, b in zip(("state", "request"), ko, po):
                rows = (a != b).any(dim=1).nonzero().flatten().tolist()
                rays = int((a != b).any(dim=0).sum())
                extra += f" ({block} rows {rows}, {rays} rays)"
        del ko, po, ka, pa
        work = [a.clone() for a in args_[:blocks]]
        rest = args_[blocks:]

        def restore():
            for x, a in zip(work, args_):
                x.copy_(a)

        k_ms = cuda_ms(lambda: getattr(KERNELS, name)(*work, *rest), setup=restore)
        p_ms = cuda_ms(lambda: getattr(PLAIN, name)(*work, *rest), setup=restore)
        del work
        report(name, label, count, err, k_ms, p_ms, bnd, main, extra)
        return k_ms, p_ms

    def check_list(name, kernel, plain, state, words, label, main):
        """A list kernel against its plain version on its own copy of the
        state (the alive list writes m there): the same count, the same
        entries (in any order of its warps' runs), each once, and the same
        state; timed, and bounded by the `words` it moves and one compare a
        ray. Returns (kernel ms, plain ms, bound ms)."""
        ka, pa = state.clone(), state.clone()
        got, count = kernel(ka)
        ref, ref_count = plain(pa)
        k = int(ref_count)
        differ = (int(int(count) != k) + int((got[:k].sort().values != ref[:k]).sum())
                  + differences(ka, pa, False)[0])
        bnd = bound(f32 * words, state.shape[1])
        l_ms = cuda_ms(lambda: kernel(ka))
        lp_ms = cuda_ms(lambda: plain(pa))
        report(name, label, differ, 0.0, l_ms, lp_ms, bnd, main)
        return l_ms, lp_ms, bnd[0]

    def frame_sums(name, sums):
        """A kernel's numbers in the kernels line are per frame: the sums of
        its calls."""
        results[name].update(ms=sums[0], plain_ms=sums[1], bound_ms=sums[2])

    def rec_test_ops(det, udet, vdet, sdet, ml, edge, closest):
        """int32 per pair: the operations of the record test (trace.cuh
        fl_rec_closest / fl_rec_any) of each (ray, triangle) pair with these
        products, up to the reject that takes it (OPS_REC_*)."""
        cull = not closest or edge > 0
        if closest:
            go, pos = det.abs() >= BIAS, det > 0

            def sign(x):
                return torch.where(pos, x > 0, x < 0)
        else:
            go = det >= BIAS

            def sign(x):
                return x > 0
        ops = torch.full(det.shape, OPS_REC_DET, dtype=torch.int32, device=det.device)
        ops += go * OPS_REC_SDET[closest]
        go &= sign(sdet)
        for x in (udet, vdet):
            ops += go * (OPS_REC_UV + cull)
            if cull:
                go &= sign(x)
        ops += go * OPS_REC_DIVIDE
        inv = 1.0 / det
        u, v, s = udet * inv, vdet * inv, sdet * inv
        for step, ok in ((1, u >= edge), (1, u <= 1.0), (1, v >= edge), (2, u + v <= 1.0),
                         (1, s > BIAS), (1, s <= ml)):
            ops += go * step
            go &= ok
        return ops + go if closest else ops

    def table_cast_ops(rec, closest, o3, d3, ml, edge, hit):
        """The operations of one cast of POST or FRAME (a thread's loop over
        the whole record table `rec` [T, 16], csrc/trace.cuh fl_table_*):
        per live ray (max_len > 0) its record ray, and every pair up to its
        reject (closest hit: every triangle; any hit: the whole table for a
        ray that nothing occludes, one accepted pair for one that is
        occluded, `hit`). Counted on the card in chunks of pairs."""
        d3 = _safe_dirs(d3)
        live = (ml > 0).nonzero().flatten()
        q = [rec[None, :, k] for k in range(REC)]
        step = max(1, (1 << 24) // max(rec.shape[0], 1))
        total = live.numel() * OPS_REC_RAY
        for a0 in range(0, live.numel(), step):
            idx = live[a0:a0 + step]
            prods = record_products(q, [c[idx][:, None] for c in o3],
                                    [c[idx][:, None] for c in d3])
            ops = rec_test_ops(*prods, ml[idx][:, None], edge, closest).sum(dim=1,
                                                                            dtype=torch.int64)
            if not closest:
                ops = torch.where(hit[idx], OPS_REC_ACCEPT, ops)
            total += int(ops.sum())
        return total

    def plain_casts(fn, args, on_cast):
        """fn(*args) (a plain version that casts through ops.fused's
        closest_hit_plain / any_hit_plain), calling on_cast(closest, o3, d3,
        max_len, edge, hit) after each of its casts; fn's result."""
        real_closest, real_any = F.closest_hit_plain, F.any_hit_plain

        def closest(w4_, ids_, o3, d3, ml, edge=BIAS):
            out = real_closest(w4_, ids_, o3, d3, ml, edge)
            on_cast(True, o3, d3, ml, edge, out[3] >= 0)
            return out

        def any_(w4_, o3, d3, ml):
            out = real_any(w4_, o3, d3, ml)
            on_cast(False, o3, d3, ml, BIAS, out)
            return out

        F.closest_hit_plain, F.any_hit_plain = closest, any_
        try:
            return fn(*args)
        finally:
            F.closest_hit_plain, F.any_hit_plain = real_closest, real_any

    # PRE / POST (scheme="fused_split")
    state0, dirs, w4, ids = captured["sp_pre"][0][:4]
    n, tp = dirs.shape[1], w4.shape[1]
    f32 = 4

    def pre_bound(pre_args):
        """(bound, W's bound) of a casting PRE call: per ray 3 rows read and
        55 written, its record ray, every (ray, triangle) pair up to the
        record test's reject (table_cast_ops; W's count: every pair in full)
        and bounce_pre(0)."""
        dirs_, w4_, cam_ = pre_args[1], pre_args[2], pre_args[5]
        n_, tp_ = dirs_.shape[1], w4_.shape[1]
        o3 = tuple(cam_[k].expand(n_) for k in range(3))
        ml = torch.full((n_,), POW32, dtype=torch.float32, device=dev)
        ops = table_cast_ops(F.record_from_w4(w4_), True, o3, tuple(dirs_), ml, -BIAS, None)
        nbytes = (3 + F.SP_C) * f32 * n_
        return (bound(nbytes, ops + n_ * OPS_BOUNCE_PRE),
                bound(nbytes, n_ * (OPS_MAKE_RAY + tp_ * OPS_CLOSEST_TEST + OPS_BOUNCE_PRE)))

    def pre_line(label, k_ms, bnd, w_bnd):
        print(f"[pre] {label}: kernel {k_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
              f"{k_ms / bnd[0]:.1f}x) [W's count {w_bnd[0]:.4f} ms ({w_bnd[1]})]", flush=True)

    bnd, w_bnd = pre_bound(captured["sp_pre"][0])
    k_ms, _ = check_state("sp_pre", f"primary hit + bounce_pre(0), {n} rays x {tp} triangles",
                          captured["sp_pre"][0], bnd)
    pre_line(f"theater, {tp} triangles", k_ms, bnd, w_bnd)
    results["sp_pre"].update(w_bound_ms=w_bnd[0])
    bnd = bound((3 + 4 + 8 + F.SP_C) * f32 * n, n * OPS_BOUNCE_PRE)
    k_ms, p_ms = check_state("sp_pre", f"resampling (2nd of 2 spp), {n} rays", resample[0], bnd,
                             main=False)
    results["sp_pre"].update(resample_ms=k_ms, resample_plain_ms=p_ms, resample_bound_ms=bnd[0])
    # PRE at the top of its range: a 1024-triangle scene (wave with 9 x 9
    # pillars and 50 seeded triangles: a 64 KB record table) at this size,
    # held against the plain version on every 16th ray
    reset_global_registry()
    ce, ce_step = wave(side_length=9, device=dev)
    crng = np.random.default_rng(args.seed)
    for _ in range(50):
        c = crng.uniform(-4, 12, 3).astype(np.float32)
        c[1] = abs(c[1])
        ce.scene.queue.push(ce.scene.Triangle(c, c + [0.5, 0.0, 0.0], c + [0.0, 0.5, 0.5]))
    ce_step(0)
    cb = build_scene_buffers(ce.scene, dev)
    ccam, cdirs, _, cw4, cids, cmat = F.frame_inputs(cb, w, h, ce.camera.position,
                                                     ce.camera.view_matrix(w, h))
    if cw4.shape[1] != F.MAX_TRIS:
        fail(f"the cap scene has {cw4.shape[1]} triangles, not {F.MAX_TRIS}")
    nc = cdirs.shape[1]
    cap = (torch.zeros((F.SP_C, nc), dtype=torch.float32, device=dev), cdirs, cw4, cids, cmat,
           ccam, False, config)
    got = KERNELS.sp_pre(*clone(cap))
    sub = torch.arange(0, nc, 16, device=dev)
    t_start_ev = torch.cuda.Event(enable_timing=True)
    t_end_ev = torch.cuda.Event(enable_timing=True)
    t_start_ev.record()
    ref = PLAIN.sp_pre(cap[0][:, sub].contiguous(), cdirs[:, sub].contiguous(), *cap[2:])
    t_end_ev.record()
    t_end_ev.synchronize()
    count, err = differences(got[:, sub], ref, False)
    bnd, w_bnd = pre_bound(cap)
    k_ms = cuda_ms(lambda: KERNELS.sp_pre(*cap))
    report("sp_pre", f"{F.MAX_TRIS}-triangle scene, {nc} rays, held on every 16th ray "
           f"({sub.numel()}), {int((got[F.PPART + 3] >= 0).sum())} hits", count, err, k_ms,
           t_start_ev.elapsed_time(t_end_ev), bnd, main=False)
    pre_line(f"at {F.MAX_TRIS} triangles", k_ms, bnd, w_bnd)
    results["sp_pre"].update(cap_ms=k_ms, cap_plain_ms_16th=t_start_ev.elapsed_time(t_end_ev),
                             cap_bound_ms=bnd[0], cap_w_bound_ms=w_bnd[0])
    del cap, got, ref, ce, cb, cdirs, cw4, cmat
    post_sum, list_sum = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    lights = captured["sp_post"][0][6]
    n_lights, lights_on = lights.shape[0], int((lights[:, 1, 0] > 0).sum())
    per_call, per_out = OPS_NOISE[config.rng]
    rec = F.record_from_w4(captured["sp_post"][0][3])
    for call in captured["sp_post"]:
        i = call[-2]
        state = call[0]
        live = int((state[F.SURF] > 0).sum())
        nxt = i + 1 < config.max_reflections
        # the state's m row, then the live rays' words and the table (the
        # list's bytes are the list kernel's own bound)
        nbytes = f32 * (n + live * (32 + 4 + 9 + 2 + 32 + (19 if nxt else 0)) + tp * REC)
        per_ray = (OPS_SHADE + i + (OPS_FIRST_LENGTH if i == 1 else 0)
                   + 2 * per_call + 6 * per_out
                   + n_lights * (OPS_LIGHT + per_call + 2 * per_out) + lights_on * OPS_LIGHT_ON
                   + OPS_APPLY + (OPS_BOUNCE_PRE if nxt else 0))
        cast_ops = [0]

        def count_cast(closest, o3, d3, ml, edge, hit):
            cast_ops[0] += table_cast_ops(rec, closest, o3, d3, ml, edge, hit)

        plain_casts(F.sp_post_plain, clone(call), count_cast)
        bnd = bound(nbytes, live * per_ray + cast_ops[0])
        k_ms, p_ms = check_state("sp_post", f"bounce {i}, {live} of {n} rays live", call, bnd,
                                 main=(i == 0))
        post_sum = [post_sum[0] + k_ms, post_sum[1] + p_ms, post_sum[2] + bnd[0]]
        # the live-ray list (launched by every POST call, and timed within it)
        l_ms, lp_ms, l_bnd = check_list(
            "sp_live_list", SK.sp_live_list, F.live_list_plain, state, n + live + 1,
            f"bounce {i}, {live} of {n} rays live; the same rays, each once, in any order "
            f"of the warps' runs", main=(i == 0))
        list_sum = [list_sum[0] + l_ms, list_sum[1] + lp_ms, list_sum[2] + l_bnd]
        print(f"[post] bounce {i}: POST {k_ms:.3f} ms (its list kernel {l_ms:.3f} ms) at {live} "
              f"of {n} rays live, {k_ms * 1e6 / max(live, 1):.3f} ns a live ray; bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}, {k_ms / bnd[0]:.1f}x)", flush=True)
    frame_sums("sp_post", post_sum)
    frame_sums("sp_live_list", list_sum)
    print(f"[post] per frame ({len(captured['sp_post'])} calls): POST {post_sum[0]:.3f} ms "
          f"(the list kernel {list_sum[0]:.3f} ms), bound {post_sum[2]:.4f} ms "
          f"({post_sum[0] / post_sum[2]:.1f}x)", flush=True)
    del captured["sp_pre"], captured["sp_post"], resample
    torch.cuda.empty_cache()

    # the shading kernels: shade on the theater frame's bounces (scheme
    # "kernel"), interp_shade on the dragon frame's (scheme "sparse")
    def shade_ops(i, n_lights, lights_on):
        """Float operations of bounce_shade(i) for one live ray."""
        return (OPS_SHADE + i + (OPS_FIRST_LENGTH if i == 1 else 0) + 2 * per_call
                + 6 * per_out + n_lights * (OPS_LIGHT + per_call + 2 * per_out)
                + lights_on * OPS_LIGHT_ON)

    # Each call's wrapper first writes the list of the rays it shades (shade:
    # POST's list of the rays with m = 1; interp_shade: its alive list, which
    # also writes m = 0 for the rays that are not alive) and then walks it;
    # the kernel's time is the wrapper's, its list's the sub-row's.
    for name in ("shade", "interp_shade"):
        sums, list_sums = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        for call in captured[name]:
            state, i = call[0], call[-2]
            lights = call[4] if name == "shade" else call[5]
            n_lights, lights_on = lights.shape[0], int((lights[:, 1, 0] > 0).sum())
            n = state.shape[1]
            extra = 1 if i == 1 else 0
            if name == "shade":
                # every ray's m; a listed ray's words (the list's bytes are
                # its own sub-row's)
                live = listed = int((state[F.SURF] > 0).sum())
                nbytes = f32 * (n + live * (SHADE_WORDS[0] + SHADE_WORDS[1] + 2 * extra)
                                + 6 * n_lights)
                ops = live * shade_ops(i, n_lights, lights_on)
                list_args = ("sp_live_list", SK.sp_live_list, F.live_list_plain, state,
                             n + live + 1)
            else:
                # the rays the step shades: alive ones that the importance
                # test keeps, as the plain version decides. Every ray's
                # alive read and m written; an alive ray that the test kills
                # reads its importancy and original colour and writes alive
                listed = int((state[F.ALIVE] > 0).sum())
                probe = PLAIN.interp_shade(*clone(call))[0]
                shaded = probe[F.SURF] > 0
                live = int(shaded.sum())
                tris = int(torch.unique(call[0][F.TRI][shaded]).numel())
                nbytes = f32 * (2 * n + (listed - live) * 7
                                + live * (STEP_WORDS[0] + STEP_WORDS[1] + 2 * extra)
                                + tris * MAT_C + 6 * n_lights)
                ops = live * (OPS_BOUNCE_PRE + OPS_TEX_SELECT + shade_ops(i, n_lights, lights_on))
                del probe
                # the list reads alive, writes m of the rays that are not
                # alive, the entries and the count
                list_args = ("alive_list", HK.alive_list, H.alive_list_plain, state, 2 * n + 1)
            bnd = bound(nbytes, ops)
            k_ms, p_ms = check_state(name, f"bounce {i}, {live} of {n} rays shaded", call, bnd,
                                     main=(i == 0))
            sums = [sums[0] + k_ms, sums[1] + p_ms, sums[2] + bnd[0]]
            l_ms, lp_ms, l_bnd = check_list(
                *list_args, f"{name}'s list, bounce {i}, {listed} of {n} rays listed; the same "
                f"rays, each once, in any order of the warps' runs",
                main=(name == "interp_shade" and i == 0))
            list_sums = [list_sums[0] + l_ms, list_sums[1] + lp_ms, list_sums[2] + l_bnd]
            # the 32-byte sectors of a state row (8 rays) that hold a listed ray
            listed_rows = state[F.SURF if name == "shade" else F.ALIVE] > 0
            sectors = int(torch.nn.functional.pad(listed_rows.int(), (0, -n % 8)).reshape(-1, 8)
                          .amax(dim=1).sum())
            print(f"[shade] {name} bounce {i}: {k_ms:.3f} ms (its list {l_ms:.3f} ms, bound "
                  f"{l_bnd:.4f}) at {live} of {n} rays shaded, {listed} listed, "
                  f"{k_ms * 1e6 / max(live, 1):.3f} ns a shaded ray; {sectors} of "
                  f"{(n + 7) // 8} sectors of a row hold a listed ray; bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}, {k_ms / bnd[0]:.1f}x)", flush=True)
        frame_sums(name, sums)
        if name == "shade":
            results["shade"].update(list_ms=list_sums[0], list_plain_ms=list_sums[1],
                                    list_bound_ms=list_sums[2])
        else:
            frame_sums("alive_list", list_sums)
        print(f"[shade] {name} per frame ({len(captured[name])} calls): {sums[0]:.3f} ms "
              f"(its lists {list_sums[0]:.3f} ms, bound {list_sums[2]:.4f}), bound "
              f"{sums[2]:.4f} ms ({sums[0] / sums[2]:.1f}x)", flush=True)
        del captured[name]
    torch.cuda.empty_cache()

    # the disc passes' inputs of one wave frame (scheme="fused")
    we, wave_step = wave_engine(w, h)
    wave_step(0)
    PathTracer(w, h, we.scene, we.camera, config, dev, scheme="fused",
               kernels=recording_disc(KERNELS, "wave")).render_frame()
    # the whole-frame kernel (scheme="fused") on wave's camera rays: 1 spp
    # (the frame the port renders) and 2 spp
    we, _ = wave_engine(w, h)
    wb = build_scene_buffers(we.scene, dev)

    def frame_bound(fargs, cfg):
        """The work this frame's data needs of fused_frame: its plain
        version with POST's inputs counted (live rays per bounce, fetches
        that read an atlas) and every cast counted per pair up to its
        reject (table_cast_ops). (bound, live ray-bounces, atlas fetches,
        the live share of a block-wide schedule's lane-slots: a block of
        128 rays runs a sample's bounce b while any of its rays is live
        there)."""
        tabs = fargs[7:10]
        nf = fargs[0].shape[1]
        frec = F.record_from_w4(fargs[2])
        bounce_live, fetched, cast_ops, block_slots = [], [0, 0], [0], [0]
        per_ray = torch.zeros(nf, dtype=torch.int32, device=dev)

        def counting_post(state, *rest):
            m = state[F.SURF] > 0
            bounce_live.append((rest[-2], int(m.sum())))
            per_ray.add_(m.to(torch.int32))
            if rest[-2] + 1 == cfg.max_reflections:
                blocks = torch.nn.functional.pad(per_ray, (0, -nf % 128)).reshape(-1, 128)
                block_slots[0] += 128 * int(blocks.amax(dim=1).sum())
                per_ray.zero_()
            for k, tab in enumerate(tabs):
                hits = int((state[F.TEXIN + 2 + k][m] != -1.0).sum())
                fetched[0] += hits
                fetched[1] += hits if tab.texels.dtype == torch.uint8 else 0
            return F.sp_post_plain(state, *rest)

        def count_cast(closest, o3, d3, ml, edge, hit):
            cast_ops[0] += table_cast_ops(frec, closest, o3, d3, ml, edge, hit)

        plain_casts(lambda: F.split_frame(*fargs[:7], wb, *fargs[10:], F.sp_pre_plain,
                                          counting_post), (), count_cast)
        n_lights, lights_on = wb.lights.shape[0], int((wb.lights[:, 1, 0] > 0).sum())
        table_bytes = sum(t.numel() * t.element_size() for tab in tabs for t in tab)
        nbytes = (f32 * (5 + F.FR_C) * nf + table_bytes
                  + sum(t.numel() * t.element_size() for t in fargs[2:7] + fargs[10:13]))
        spp = cfg.samples_per_ray
        ops = (nf * OPS_FRAME_RAY + spp * nf * (OPS_BOUNCE_PRE + OPS_FRAME_SAMPLE)
               + (spp - 1) * 3 * nf + fetched[0] * OPS_TEX_FETCH + fetched[1] * OPS_TEX_U8
               + cast_ops[0])
        for i, live in bounce_live:
            nxt = i + 1 < cfg.max_reflections
            ops += live * (3 * OPS_TEX_MISS + shade_ops(i, n_lights, lights_on) + OPS_APPLY
                           + (OPS_BOUNCE_PRE if nxt else 0))
        live_bounces = sum(x for _, x in bounce_live)
        return bound(nbytes, ops), live_bounces, fetched[0], live_bounces / block_slots[0]

    for spp in (1, 2):
        cfg_s = config.replace(samples_per_ray=spp)
        fargs = fused_frame_args(wb, we.camera, cfg_s)
        nf = fargs[0].shape[1]
        bnd, live_bounces, fetches, block_share = frame_bound(fargs, cfg_s)
        k_ms, p_ms = check("fused_frame", f"wave, {nf} rays, {spp} spp x "
                           f"{cfg_s.max_reflections} bounces, {live_bounces} live ray-bounces, "
                           f"{fetches} atlas fetches", fargs, bnd, main=(spp == 1))
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        KERNELS.fused_frame(*fargs, lane_stats=stats)
        lanes, busy = stats.tolist()
        if busy != live_bounces:
            fail(f"fused_frame ran {busy} live ray-bounces, its plain version {live_bounces}")
        print(f"[frame] fused_frame, {spp} spp: {live_bounces} live ray-bounces; {busy} of "
              f"{lanes} lane-slots did live work ({busy / lanes:.4f}; a block-wide schedule of "
              f"the same frame: {block_share:.4f})", flush=True)
        del fargs
    # the kernels line keeps the 1-spp frame's numbers; the 2-spp launch's too
    results["fused_frame"].update(ms_2spp=k_ms, plain_ms_2spp=p_ms, bound_ms_2spp=bnd[0])
    del wb, we
    torch.cuda.empty_cache()

    # the traversal (scheme="kernel"): every cast of the theater frame, each
    # bounded per pair up to the record test's reject (W's count, which
    # tests every pair in full, in brackets), a seeded random bounce
    # wavefront, and the stand-in's 4095 triangles
    def cast_bound(w4_, closest, o3, d3, ml, edge, hit):
        """(bound, W's bound) of one cast: every ray's max_len in, a live
        ray's other 6 floats, each ray's outputs (4 words, or 1 byte) out,
        and the record table; per live ray its record ray and every pair up
        to its reject (an occluded ray: the pair that occludes it), counted
        on the card. A dead ray (max_len <= 0) needs only its miss."""
        n_, tp_ = ml.shape[0], w4_.shape[1]
        live = int((ml > 0).sum())
        nbytes = f32 * (n_ + 6 * live) + (f32 * 4 * n_ if closest else n_) + f32 * tp_ * REC
        ops = table_cast_ops(F.record_from_w4(w4_), closest, o3, d3, ml, edge, hit)
        if closest:
            w_ops = live * (OPS_MAKE_RAY + tp_ * OPS_CLOSEST_TEST)
        else:
            hits = int((hit & (ml > 0)).sum())
            w_ops = live * OPS_MAKE_RAY + (hits + (live - hits) * tp_) * OPS_ANY_TEST
        return bound(nbytes, ops), bound(nbytes, w_ops)

    gen = torch.Generator().manual_seed(args.seed)
    n = captured["closest_hit"][0][4].shape[0]
    rand_o = tuple((torch.rand(n, generator=gen) * 80.0 - 40.0).to(dev) for _ in range(3))
    rd = torch.randn(3, n, generator=gen)
    rd = rd / rd.norm(dim=0)
    rand_d = tuple(c.contiguous().to(dev) for c in rd)
    rand_ml = torch.where(torch.rand(n, generator=gen) < 0.1, 0.0, POW32).to(dev)
    rand_len = (torch.rand(n, generator=gen) * 60.0).to(dev)
    cast_labels = {"closest_hit": ["primary"] + [f"bounce {b}" for b in range(1, bounces)],
                   "any_hit": [f"shadow {b}" for b in range(bounces)]}
    for name in traversal:
        closest = name == "closest_hit"
        sums = [0.0, 0.0, 0.0, 0.0]
        for k, (cast, a) in enumerate(zip(cast_labels[name], captured[name])):
            w4_, o3, d3, ml = (a[0], a[2], a[3], a[4]) if closest else a
            edge = a[5] if closest else BIAS
            out = PLAIN.any_hit(*a) if not closest else PLAIN.closest_hit(*a)
            bnd, w_bnd = cast_bound(w4_, closest, o3, d3, ml, edge,
                                    out[3] >= 0 if closest else out)
            del out
            k_ms, p_ms = check(name, f"theater {cast} cast, {int((ml > 0).sum())} of "
                               f"{ml.shape[0]} rays live, {w4_.shape[1]} triangles", a, bnd,
                               main=k == 0)
            print(f"[cast] {name} ({cast}): kernel {k_ms:.3f} ms, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}, {k_ms / bnd[0]:.1f}x) [W's count {w_bnd[0]:.4f} ms, "
                  f"{k_ms / w_bnd[0]:.1f}x]", flush=True)
            sums = [sums[0] + k_ms, sums[1] + p_ms, sums[2] + bnd[0], sums[3] + w_bnd[0]]
        print(f"[cast] {name}: per theater frame ({len(captured[name])} casts) kernel "
              f"{sums[0]:.3f} ms, bound {sums[2]:.4f} ms ({sums[0] / sums[2]:.1f}x) [W's count "
              f"{sums[3]:.4f} ms]", flush=True)
        results[name].update(frame_ms=sums[0], frame_plain_ms=sums[1], frame_bound_ms=sums[2],
                             frame_w_bound_ms=sums[3])
    w4, ids = captured["closest_hit"][0][:2]
    check("closest_hit", f"random bounce, {n} rays", (w4, ids, rand_o, rand_d, rand_ml, BIAS),
          cast_bound(w4, True, rand_o, rand_d, rand_ml, BIAS,
                     PLAIN.closest_hit(w4, ids, rand_o, rand_d, rand_ml, BIAS)[3] >= 0)[0],
          main=False)
    check("any_hit", f"random bounce, {n} rays", (w4, rand_o, rand_d, rand_len),
          cast_bound(w4, False, rand_o, rand_d, rand_len, BIAS,
                     PLAIN.any_hit(w4, rand_o, rand_d, rand_len))[0], main=False)
    del captured["closest_hit"], captured["any_hit"]
    # the stand-in's first 4095 triangles against its camera rays: the
    # kernel on every ray, held against the plain version on every 16th
    nb = big_dirs[0].shape[0]
    big_o3 = tuple(big_cam[k].expand(nb).contiguous() for k in range(3))
    big_d3 = tuple(c.contiguous() for c in big_dirs)
    big_ml = torch.full((nb,), POW32, dtype=torch.float32, device=dev)
    big = (big_w4, big_ids, big_o3, big_d3, big_ml, -BIAS)
    got = KERNELS.closest_hit(*big)
    sub = torch.arange(0, nb, 16, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ref = PLAIN.closest_hit(big_w4, big_ids, tuple(c[sub] for c in big_o3),
                            tuple(c[sub] for c in big_d3), big_ml[sub], -BIAS)
    end.record()
    end.synchronize()
    count, err = differences(tuple(x[sub] for x in got), ref, False)
    bnd, w_bnd = cast_bound(big_w4, True, big_o3, big_d3, big_ml, -BIAS, got[3] >= 0)
    k_ms = cuda_ms(lambda: KERNELS.closest_hit(*big))
    report("closest_hit", f"dragon stand-in primary, {nb} rays x {big_w4.shape[1]} triangles, "
           f"held on every 16th ray ({sub.numel()}), {int((got[3] >= 0).sum())} hits",
           count, err, k_ms, start.elapsed_time(end), bnd, main=False)
    print(f"[cast] closest_hit at {big_w4.shape[1]} triangles: kernel {k_ms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}, {k_ms / bnd[0]:.1f}x) [W's count {w_bnd[0]:.4f} ms, "
          f"{k_ms / w_bnd[0]:.1f}x]", flush=True)
    results["closest_hit"].update(t4095_ms=k_ms, t4095_bound_ms=bnd[0],
                                  t4095_w_bound_ms=w_bnd[0])
    del got, ref, big, big_w4, big_o3, big_d3, big_ml, big_dirs

    # the disc passes on every call of the theater, dragon and wave frames
    # (3 first, 3 second, 1 final each), and FXAA (of the theater frame)
    def disc_bound(name, planes):
        """Each of the five planes read once and the outputs written once;
        the taps every pixel needs (a first-pass pixel whose key is 0 needs
        none)."""
        px = planes[0].numel()
        if name == "first_blur":
            taps = 37 * int((byte_i(planes[4], 3) != 0).sum())
            return bound(px * (20 + 8), taps * OPS_DISC_TAP[name])
        taps = px * (36 if name == "second_blur" else 37)
        return bound(px * (20 + 12), taps * OPS_DISC_TAP[name])

    for frame, calls in disc_calls.items():
        if [c[0] for c in calls] != ["first_blur"] * 3 + ["second_blur"] * 3 + ["final_blur"]:
            fail(f"the {frame} frame's disc passes: {[c[0] for c in calls]}")
        sums = {name: [0.0, 0.0] for name in disc_names}
        for k, (name, a) in enumerate(calls):
            label = f"{frame} frame, pass {k + 1} of 7"
            bnd = disc_bound(name, a)
            if frame == "theater" and name not in [c[0] for c in calls[:k]]:
                k_ms, _ = check(name, label, a, bnd, packed=name != "final_blur")
            else:
                # one timed call of the plain version (a second or more at 1080p)
                ko = getattr(KERNELS, name)(*a)
                start.record()
                po = getattr(PLAIN, name)(*a)
                end.record()
                end.synchronize()
                count, err = differences(ko, po, name != "final_blur")
                del ko, po
                k_ms = cuda_ms(lambda: getattr(KERNELS, name)(*a))  # noqa: B023
                report(name, label, count, err, k_ms, start.elapsed_time(end), bnd, main=False)
            sums[name] = [sums[name][0] + k_ms, sums[name][1] + bnd[0]]
        total = [sum(x[0] for x in sums.values()), sum(x[1] for x in sums.values())]
        print(f"[disc] {frame} frame: the 7 passes {total[0]:.3f} ms, bound {total[1]:.4f} ms "
              f"({total[0] / total[1]:.1f}x); " + ", ".join(
                  f"{name} {v[0]:.3f} ms (bound {v[1]:.4f})" for name, v in sums.items()),
              flush=True)
        if frame == "theater":
            for name, v in sums.items():
                results[name].update(frame_ms=v[0], frame_bound_ms=v[1])
    del disc_calls
    def edge_share(img):
        """The share of pixels that fail FXAA's 3x3 test (post/fxaa.py's
        low_contrast) and run the edge search."""
        luma = (img[..., 1] * (0.587 / 0.299) + img[..., 0]) * img[..., 3]
        pad = torch.nn.functional.pad(luma, (1, 1, 1, 1))
        cross = torch.stack([pad[:-2, 1:-1], pad[1:-1, :-2], pad[2:, 1:-1], pad[1:-1, 2:]])
        hi = torch.maximum(luma, cross.amax(dim=0))
        lo = torch.minimum(luma, cross.amin(dim=0))
        return float(((hi - lo) >= torch.clamp_min(hi * 0.5, 1.0 / 32.0)).float().mean())

    fimg = captured["fxaa"][0]
    px = fimg.shape[0] * fimg.shape[1]
    bnd = bound(px * (16 + 16), px * OPS_FXAA_PIXEL)
    check("fxaa", f"FXAA input of the frame, {edge_share(fimg):.2%} edge pixels", captured["fxaa"],
          bnd)
    # an edge-heavy image of the same size: seeded random colours in 2 x 2
    # cells, alpha 1, so most pixels run the search
    cells = torch.rand(((fimg.shape[0] + 1) // 2, (fimg.shape[1] + 1) // 2, 4), generator=gen)
    edgy = cells.repeat_interleave(2, 0).repeat_interleave(2, 1)[:fimg.shape[0], :fimg.shape[1]]
    edgy[..., 3] = 1.0
    edgy = edgy.contiguous().to(dev)
    k_ms, p_ms = check("fxaa", f"edge-heavy image, 2 x 2 random cells, {edge_share(edgy):.2%} "
                       f"edge pixels", (edgy,), bnd, main=False)
    results["fxaa"].update(edge_ms=k_ms, edge_plain_ms=p_ms, edge_bound_ms=bnd[0])
    del captured, edgy

    # the worklist kernels (scheme="sparse") on the dragon frame's wavefronts
    def check_sparse(name, label, args_, bound_of, main=True):
        """Kernel vs plain: identical outputs. The plain worklist casts take
        seconds at 1080p: their time is that of the compared call. Returns
        (kernel ms, bound_of's (bound, what else it counted), kernel
        outputs)."""
        kernel_fn = lambda: getattr(KERNELS, name)(*args_)  # noqa: E731
        ko = kernel_fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        po = getattr(PLAIN, name)(*args_)
        end.record()
        end.synchronize()
        count, err = differences(ko, po, False)
        k_ms, got = cuda_ms(kernel_fn), bound_of(args_, ko)
        report(name, label, count, err, k_ms, start.elapsed_time(end), got[0], main)
        return k_ms, got, ko

    def live_rays(ml):
        return int((ml > 0).sum())

    def flags_bound(a, out):
        """The work this call's data needs of the flags kernel: per live ray
        its setup, per (live ray tile, cluster) the interval cull, and the
        slab test of every live ray of a tile against each cluster the cull
        keeps (a tile's second cluster only where its least entry lies below
        the first's minimum, as the kernel decides); bytes: every ray's
        max_len, a live ray's origin and direction, the boxes and the flags.
        (bound, (the all-pairs bound, pairs tested, live pairs))."""
        amin, ml, rt_size = a[0], a[4], a[5]
        n, k, live = ml.shape[0], amin.shape[0], live_rays(ml)
        none, entry_lo, live_t = flags_cull(*a)
        per_tile = (ml > 0).reshape(-1, rt_size).sum(dim=1)
        kept = ~none & live_t[:, None]
        first, second = kept[:, 0::2], kept[:, 1::2]
        best = torch.where(first, cluster_minima_plain(*a)[:, 0::2], POW32)
        second_tested = second & ~(entry_lo[:, 1::2] >= best)
        tested = int(((first.sum(dim=1) + second_tested.sum(dim=1)) * per_tile).sum())
        nbytes = f32 * (n + 6 * live + 6 * k + out.numel())
        ops = (live * OPS_FLAGS_RAY + int(live_t.sum()) * k * OPS_CULL
               + int(second.sum()) * OPS_SKIP + tested * OPS_FLAG)
        all_pairs = bound(nbytes, live * (OPS_FLAGS_RAY + k * OPS_FLAG))
        return bound(nbytes, ops), (all_pairs, tested, live * k)

    def key_bound(a, out):
        """Per live ray its setup and its slab test against every box;
        bytes: every ray's max_len and key, a live ray's origin and
        direction, and the boxes. (bound, (warps that test boxes after each
        block packs its rays that are not dead, warps of the launch))."""
        bmin, ml = a[0], a[4]
        n, nb, live = ml.shape[0], bmin.shape[0], live_rays(ml)
        blocks = torch.nn.functional.pad(ml, (0, -n % KEY_BLOCK_RAYS)).reshape(-1, KEY_BLOCK_RAYS)
        packed = (~(blocks <= 0.0)).sum(dim=1)
        working = int(((packed + 32 * KEY_RAYS - 1) // (32 * KEY_RAYS)).sum())
        return (bound(f32 * (n + 6 * live + 6 * nb + n), live * (OPS_KEY_RAY + nb * OPS_KEY_BOX)),
                (working, blocks.shape[0] * KEY_BLOCK_RAYS // KEY_RAYS // 32))

    def tile_bytes(tlist, slots):
        """Bytes of the worklist slots [RT] that each ray tile reads and of
        the triangle records of the tiles those slots name."""
        used = torch.arange(tlist.shape[1], device=dev)[None] < slots[:, None]
        tiles = int(torch.unique(tlist[used]).numel())
        return f32 * (int(slots.sum()) + tiles * TRI_TILE * REC)

    def needed_test_ops(a, needed, closest, edge):
        """The operations of the tests the walk cannot skip: each ray
        against the 128 triangles of the first needed[rt, r] slots of its
        ray tile's worklist, each test up to its first reject."""
        rec, tlist = a[0], a[1]
        o3, d3, ml, rt_size = (a[4], a[5], a[6], a[8]) if closest else a[3:7]
        rt = tlist.shape[0]
        o = [x.reshape(rt, rt_size, 1) for x in o3]
        d = [x.reshape(rt, rt_size, 1) for x in d3]
        ml = ml.reshape(rt, rt_size, 1)
        total = 0
        for c in range(int(needed.max())):
            for g in (needed > c).any(dim=1).nonzero().flatten().split(1024):
                q = rec[tlist[g, c].long()][:, None]                  # [G, 1, 128, 16]
                prods = record_products([q[..., k] for k in range(REC)],
                                        [x[g] for x in o], [x[g] for x in d])
                ops = rec_test_ops(*prods, ml[g], edge, closest)
                total += int((ops * (needed[g] > c)[..., None]).sum(dtype=torch.int64))
        return total

    def closest_slots(a, out):
        """[RT, R]: the worklist slots each ray tests in the walk, those
        whose entry bound lies within the guard band of its own final best
        hit (the whole worklist where it hits nothing); none for dead rays."""
        tms, counts, ml, rt_size = a[2], a[3], a[6], a[8]
        rt = counts.shape[0]
        live = (ml > 0).reshape(rt, rt_size)
        best = torch.where(out[3] >= 0, out[0], POW32).reshape(rt, rt_size)
        reach = torch.searchsorted(tms, best * EXIT_REL + EXIT_ABS, right=True)
        return torch.where(live, torch.minimum(reach.clamp_min(1), counts[:, None].long()), 0)

    def any_slots(a, out):
        """[RT, R]: the worklist slots each ray tests in the walk, up to the
        first (in walk order) that occludes it, the whole worklist where none
        does; none for dead rays. Found slot by slot with the plain version."""
        rec, tlist, counts, o3, d3, ml, rt_size = a
        rt = counts.shape[0]
        live = (ml > 0).reshape(rt, rt_size)
        slots = torch.where(live, counts[:, None].long(), 0)
        todo = live & out.reshape(rt, rt_size)
        c = 0
        while bool(todo.any()):
            sel = (todo.any(dim=1) & (counts > c)).nonzero().flatten()

            def rays(x):
                return x.reshape(rt, rt_size)[sel].reshape(-1).contiguous()

            hit = PLAIN.sparse_any(rec, tlist[sel, c:c + 1].contiguous(),
                                   torch.ones_like(counts[sel]), tuple(rays(x) for x in o3),
                                   tuple(rays(x) for x in d3), rays(ml), rt_size)
            found = todo[sel] & hit.reshape(-1, rt_size)
            slots[sel] = torch.where(found, c + 1, slots[sel])
            todo[sel] &= ~found
            c += 1
        return slots

    # the casts give each ray CAST_LANES threads: a warp walks the slots of
    # RAYS_PER_WARP rays together
    RAYS_PER_WARP = 32 // CAST_LANES

    def lane_tests(slots):
        """The (ray, triangle) tests the warp walk issues: each warp's slots
        up to its last ray done x its RAYS_PER_WARP rays x 128 triangles."""
        per_warp = slots.reshape(slots.shape[0], -1, RAYS_PER_WARP).amax(dim=-1)
        return int(per_warp.sum()) * RAYS_PER_WARP * TRI_TILE

    def sparse_closest_bound(a, out):
        """The tests the walk cannot skip: for each live ray, the slots of
        its ray tile's worklist within the guard band of its own final best
        hit (`closest_slots`). (bound, (tests, their operations))."""
        tlist, ml, edge = a[1], a[6], float(a[7])
        n, rt = ml.shape[0], tlist.shape[0]
        needed = closest_slots(a, out)
        tests = int(needed.sum()) * TRI_TILE
        ops = needed_test_ops(a, needed, True, edge)
        slots = needed.amax(dim=1)
        # tms is read at the slots the walk reads, tlist the same
        # every ray's max_len in and its 4 outputs out, a live ray's origin
        # and direction
        nbytes = (f32 * (5 * n + 6 * live_rays(ml) + rt + int(slots.sum()))
                  + tile_bytes(tlist, slots))
        return bound(nbytes, live_rays(ml) * OPS_REC_RAY + ops), (tests, ops)

    def sparse_any_bound(a, out):
        """One test per occluded ray (the one that occludes it passes every
        reject and the window), the whole worklist per live ray that
        nothing occludes; a ray tile whose live rays are all occluded reads
        one slot. (bound, (tests, their operations))."""
        tlist, counts, ml, rt_size = a[1], a[2], a[5], a[6]
        n, rt = ml.shape[0], counts.shape[0]
        live = (ml > 0).reshape(rt, rt_size)
        open_ = live & ~out.reshape(rt, rt_size)
        occluded = int((out & (ml > 0)).sum())
        needed = torch.where(open_, counts[:, None].long(), 0)
        tests = occluded + int(needed.sum()) * TRI_TILE
        ops = occluded * OPS_REC_ACCEPT + needed_test_ops(a, needed, False, BIAS)
        open_rays = open_.sum(dim=1)
        slots = torch.where(open_rays > 0, counts, torch.minimum(counts, live.any(dim=1).int()))
        # every ray's max_len in and its byte out, a live ray's origin and
        # direction
        nbytes = f32 * (n + 6 * live_rays(ml) + rt) + n + tile_bytes(tlist, slots)
        return bound(nbytes, live_rays(ml) * OPS_REC_RAY + ops), (tests, ops)

    def rays_label(ml):
        return f"{live_rays(ml)} of {ml.shape[0]} rays live"

    # rows 8 and 9 on every call of the frame, each against its plain
    # version and its bound: the flags before every cast (primary, then
    # shadow b and bounce b + 1 in turn), the key before every hinted one
    n_casts = config.max_reflections
    flag_casts = ["primary"] + [c for b in range(n_casts)
                                for c in (f"shadow {b}", f"bounce {b + 1}")][:2 * n_casts - 1]
    frame = [0.0, 0.0, 0.0]
    for i, (cast, a) in enumerate(zip(flag_casts, sparse_calls["sparse_flags"])):
        k_ms, (bnd, (all_pairs, tested, pairs)), _ = check_sparse(
            "sparse_flags", f"{cast} cast, {rays_label(a[4])}, {a[0].shape[0]} cluster boxes",
            a, flags_bound, main=i == 0)
        print(f"[prepass] sparse_flags ({cast}): {tested} of {pairs} live (ray, cluster) pairs "
              f"tested, the cull rejects {1.0 - tested / max(pairs, 1):.4f}; kernel {k_ms:.3f} ms, "
              f"bound {bnd[0]:.4f} ms ({k_ms / bnd[0]:.1f}x), all-pairs bound {all_pairs[0]:.4f} "
              f"ms ({k_ms / all_pairs[0]:.1f}x)", flush=True)
        frame = [frame[0] + k_ms, frame[1] + bnd[0], frame[2] + all_pairs[0]]
    print(f"[kernel] sparse_flags: per frame ({len(flag_casts)} calls) kernel {frame[0]:.3f} ms, "
          f"bound {frame[1]:.4f} ms ({frame[0] / frame[1]:.1f}x), all-pairs bound "
          f"{frame[2]:.4f} ms ({frame[0] / frame[2]:.1f}x)", flush=True)
    results["sparse_flags"].update(frame_ms=frame[0], frame_bound_ms=frame[1],
                                   frame_all_pairs_bound_ms=frame[2])
    frame = [0.0, 0.0]
    for i, (cast, a) in enumerate(zip(flag_casts[1:], sparse_calls["sparse_key"])):
        k_ms, (bnd, (working, warps)), _ = check_sparse(
            "sparse_key", f"{cast} cast, {rays_label(a[4])}, {a[0].shape[0]} supertile boxes",
            a, key_bound, main=i == 0)
        print(f"[prepass] sparse_key ({cast}): {working} of {warps} warps test boxes after the "
              f"blocks pack their rays; kernel {k_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({k_ms / bnd[0]:.1f}x)", flush=True)
        frame = [frame[0] + k_ms, frame[1] + bnd[0]]
    print(f"[kernel] sparse_key: per frame ({len(flag_casts) - 1} calls) kernel {frame[0]:.3f} "
          f"ms, bound {frame[1]:.4f} ms ({frame[0] / frame[1]:.1f}x)", flush=True)
    results["sparse_key"].update(frame_ms=frame[0], frame_bound_ms=frame[1])
    # rows 6 and 7 on every cast of the frame: each timed against its bound;
    # the primary and bounce-1 closest hits and the shadow-0 any hit also
    # against their plain versions, with the lane-tests of the warp walk
    casts = {"sparse_closest": ["primary"] + [f"bounce {b}" for b in range(1, n_casts)],
             "sparse_any": [f"shadow {b}" for b in range(n_casts)]}
    compared = {"sparse_closest": ("primary", "bounce 1"), "sparse_any": ("shadow 0",)}
    for name in ("sparse_closest", "sparse_any"):
        ml_at, counts_at = (6, 3) if name == "sparse_closest" else (5, 2)
        bound_of = sparse_closest_bound if name == "sparse_closest" else sparse_any_bound
        frame = [0.0, 0.0]
        for cast, a in zip(casts[name], sparse_calls[name]):
            label = (f"{cast} cast, {rays_label(a[ml_at])}, worklists of "
                     f"{float(a[counts_at].float().mean()):.1f} tiles on average")
            if cast in compared[name]:
                k_ms, (bnd, (needed, ops)), out = check_sparse(
                    name, label, a, bound_of, main=cast == compared[name][0])
            else:
                out = getattr(KERNELS, name)(*a)
                bnd, (needed, ops) = bound_of(a, out)
                k_ms = cuda_ms(lambda: getattr(KERNELS, name)(*a))  # noqa: B023
                print(f"[kernel] {name} ({label}): kernel {k_ms:.3f} ms, bound {bnd[0]:.4f} ms "
                      f"({bnd[1]})", flush=True)
            slots = closest_slots(a, out) if name == "sparse_closest" else any_slots(a, out)
            issued = lane_tests(slots)
            walks = slots.amax(dim=1)
            print(f"[walk] {name} ({cast}): the warp walk issues {issued} ray-triangle tests "
                  f"(each warp's slots up to its last ray done x {RAYS_PER_WARP} rays x "
                  f"{TRI_TILE}{'' if name == 'sparse_closest' else ', at most'}); the bound "
                  f"counts {needed} ({issued / max(needed, 1):.2f}x), "
                  f"{ops / max(needed, 1):.2f} operations each on average (up to the first "
                  f"reject), {ops / max(needed, 1) / FP32_OPS_PER_S * 1e12:.3f} ps at the "
                  f"bound's rate; {k_ms * 1e9 / max(issued, 1):.3f} ps of kernel time per "
                  f"test issued; {int((walks > 0).sum())} ray tiles walk, "
                  f"{float(walks.float().mean()):.1f} slots on average, the longest "
                  f"{int(walks.max())}", flush=True)
            frame = [frame[0] + k_ms, frame[1] + bnd[0]]
            del out
        print(f"[kernel] {name}: per frame ({len(casts[name])} casts) kernel {frame[0]:.3f} ms, "
              f"bound {frame[1]:.4f} ms ({frame[0] / frame[1]:.1f}x)", flush=True)
        results[name].update(frame_ms=frame[0], frame_bound_ms=frame[1])
    del sparse_calls, a
    torch.cuda.empty_cache()
    print(f"[phase] kernels vs plain: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4. the main path through the user's entry points ---------------
    t0 = time.perf_counter()
    e = engine(w, h)
    plain = PathTracer(w, h, e.scene, e.camera, config, dev, kernels=PLAIN)
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(args.frames)]
    del plain
    torch.cuda.empty_cache()

    e = engine(w, h)
    e.renderer = "pathtracer"
    scheme = e.renderer.resolved_scheme()
    print(f"[main] theater {w}x{h}: scheme 'auto' resolves to {scheme!r}", flush=True)
    if scheme != "fused_split":
        fail("the main path must take scheme='fused_split'")
    frames, launches = drive_frames("main", e.renderer, args.frames)[:2]
    expect_launches("the main path", launches, args.frames,
                    {"sp_pre": 1, "sp_post": bounces, "sp_live_list": bounces,
                     "alive_list": 0})
    idle = [name for name in ("first_blur", "second_blur", "final_blur", "fxaa")
            if launches[name] == 0]
    if idle:
        fail(f"kernels not launched on the main path: {idle}")
    check_frames("main", frames, plain_frames, (h, w, 3))
    del frames, plain_frames, e
    torch.cuda.empty_cache()
    print(f"[phase] main path: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. the scheme="kernel" path --------------------------------------
    t0 = time.perf_counter()
    w2, h2, n2 = w // 2, h // 2, 2
    e = engine(w2, h2)
    plain = PathTracer(w2, h2, e.scene, e.camera, config, dev, scheme="kernel", kernels=PLAIN)
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(n2)]
    del plain
    e = engine(w2, h2)
    e.renderer = "pathtracer"
    e.renderer.scheme = "kernel"
    frames, kernel_launches = drive_frames(f"kernel-path, theater {w2}x{h2}", e.renderer,
                                           n2)[:2]
    idle = [name for name, c in kernel_launches.items()
            if c == 0 and name not in in_place + sparse_names + raster_names
            + ("fused_frame", "sp_live_list", "alive_list")]
    if idle:
        fail(f"kernels not launched on the scheme='kernel' path: {idle}")
    check_frames("kernel-path", frames, plain_frames, (h2, w2, 3))
    del frames, plain_frames, e
    torch.cuda.empty_cache()
    print(f"[phase] scheme='kernel' path: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 6. the sparse path: the dragon stand-in ----------------------------
    t0 = time.perf_counter()
    e, animate = dragon_engine(w, h)
    e.renderer = "pathtracer"
    scheme = e.renderer.resolved_scheme()
    n_tris = e.renderer._buffers.id_buffer.shape[0]
    print(f"[sparse-path] dragon stand-in (seed {args.seed}, {n_tris} triangles) {w}x{h}: "
          f"scheme 'auto' resolves to {scheme!r}", flush=True)
    if scheme != "sparse":
        fail("the dragon stand-in must take scheme='sparse'")
    frames, sparse_launches = drive_frames("sparse-path", e.renderer, args.frames,
                                           step=animate)[:2]
    expect = {"sparse_flags": 2 * bounces, "sparse_key": 2 * bounces - 1,
              "sparse_closest": bounces, "sparse_any": bounces}
    # no textures: by default the bounces shade in interp_shade
    expect_launches("the dragon stand-in", sparse_launches, args.frames,
                    dict(expect, interp_shade=bounces, alive_list=bounces, shade=0,
                         sp_live_list=0))
    idle = [name for name in ("first_blur", "second_blur", "final_blur", "fxaa")
            if sparse_launches[name] == 0]
    if idle:
        fail(f"kernels not launched on the sparse path: {idle}")
    t1 = time.perf_counter()
    de, step = dragon_engine(w, h)
    plain = PathTracer(w, h, de.scene, de.camera, config, dev, kernels=PLAIN)
    plain_frames = []
    for i in range(args.frames):
        step(i)
        plain_frames.append(torch.from_numpy(plain.render_frame()))
    plain_s = time.perf_counter() - t1
    check_frames("sparse-path", frames, plain_frames, (h, w, 3))
    print(f"[phase] sparse path: {time.perf_counter() - t0:.1f} s (the plain frames "
          f"{plain_s:.1f} s)", flush=True)
    # free the phase's tracers, so that the next phase's peak compares
    del frames, e, de, plain
    torch.cuda.empty_cache()

    # ---- 7. the shade-kernel paths ------------------------------------------
    t0 = time.perf_counter()
    # (a) the dragon stand-in on the eager loop, against phase 6's plain frames
    e, animate = dragon_engine(w, h)
    e.renderer = "pathtracer"
    e.renderer.shade_kernel = False
    frames, eager_launches = drive_frames("eager-shading dragon", e.renderer, args.frames,
                                          step=animate)[:2]
    expect_launches("the dragon with shade_kernel False", eager_launches, args.frames,
                    dict(expect, interp_shade=0, alive_list=0, shade=0, sp_live_list=0))
    check_frames("eager-shading dragon", frames, plain_frames, (h, w, 3))
    del frames, plain_frames, e
    torch.cuda.empty_cache()
    # (b) theater on scheme="kernel": shade, against its plain frames
    e = engine(w, h)
    plain = PathTracer(w, h, e.scene, e.camera, config, dev, scheme="kernel", kernels=PLAIN)
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(n2)]
    del plain
    e = engine(w, h)
    e.renderer = "pathtracer"
    e.renderer.scheme = "kernel"
    e.renderer.shade_kernel = True
    frames, shade_launches = drive_frames("shade-kernel theater", e.renderer, n2)[:2]
    expect_launches("theater on scheme='kernel' with shade_kernel", shade_launches, n2,
                    {"shade": bounces, "sp_live_list": bounces, "interp_shade": 0,
                     "alive_list": 0, "closest_hit": bounces, "any_hit": bounces})
    check_frames("shade-kernel theater", frames, plain_frames, (h, w, 3))
    del frames, plain_frames, e
    torch.cuda.empty_cache()
    print(f"[phase] shade-kernel paths: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 8. the fused path: wave on scheme="fused" ----------------------------
    t0 = time.perf_counter()
    e, step = wave_engine(w, h)
    plain = PathTracer(w, h, e.scene, e.camera, config, dev, scheme="fused", kernels=PLAIN)
    plain_frames = []
    for i in range(args.frames):
        step(i)
        plain_frames.append(torch.from_numpy(plain.render_frame()))
    del plain
    e, animate = wave_engine(w, h)
    e.renderer = "pathtracer"
    e.renderer.scheme = "fused"
    print(f"[fused-path] wave {w}x{h}: the renderer's scheme is "
          f"{e.renderer.resolved_scheme()!r}", flush=True)
    frames, fused_launches = drive_frames("fused-path", e.renderer, args.frames,
                                          step=animate)[:2]
    expect_launches("wave on scheme='fused'", fused_launches, args.frames,
                    {"fused_frame": 1, "sp_pre": 0, "sp_post": 0, "sp_live_list": 0,
                     "closest_hit": 0, "any_hit": 0, "shade": 0, "interp_shade": 0,
                     "alive_list": 0})
    idle = [name for name in ("first_blur", "second_blur", "final_blur", "fxaa")
            if fused_launches[name] == 0]
    if idle:
        fail(f"kernels not launched on the fused path: {idle}")
    check_frames("fused-path", frames, plain_frames, (h, w, 3))
    del frames, plain_frames
    # the last frame's scene on both fused schemes, through the kernels: the
    # same operations, so the same MRT
    wb = e.renderer._buffers
    mrt_args = (wb, w, h, e.camera.position, e.camera.view_matrix(w, h), config, 0.0)
    count, err = differences(tuple(render_mrt(*mrt_args, scheme="fused")),
                             tuple(render_mrt(*mrt_args, scheme="fused_split")), False)
    print(f"[fused-path] one frame's MRT, scheme 'fused' against 'fused_split' (kernels): "
          f"tolerance: identical; {count} values differ, max abs {err:.3g} -> "
          f"{'ok' if count == 0 else 'FAIL'}", flush=True)
    if count:
        fail("scheme='fused' and scheme='fused_split' render different MRTs")
    fused_ms = cuda_ms(lambda: render_mrt(*mrt_args, scheme="fused"))
    split_ms = cuda_ms(lambda: render_mrt(*mrt_args, scheme="fused_split"))
    fargs = fused_frame_args(wb, e.camera, config)
    kernel_ms = cuda_ms(lambda: KERNELS.fused_frame(*fargs))
    print(f"[fused-path] device time of the MRT pass (CUDA events, median of 10): scheme "
          f"'fused' {fused_ms:.3f} ms (its fused_frame launch alone, 1 spp: {kernel_ms:.3f} ms), "
          f"scheme 'fused_split' {split_ms:.3f} ms", flush=True)
    del e, fargs, wb, mrt_args
    torch.cuda.empty_cache()
    print(f"[phase] fused path: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 9. the rasterizer, the TAA frame and the simple renderer -------------
    t0 = time.perf_counter()
    from flexlight_tpu_torch.models.rasterizer import Rasterizer
    raster_config = Config()          # the engine's defaults: FXAA, hdr
    taa_config = config.replace(antialiasing="taa")

    # (a) the rasterizer with its defaults on theater at full size
    e = engine(w, h)
    e.config = raster_config
    raster = e.renderer
    if not isinstance(raster, Rasterizer):
        fail(f"the engine's default renderer is {type(raster).__name__}, not the Rasterizer")
    scheme, layers = raster.resolved_scheme(), raster.resolved_layers()
    n_lights = raster._buffers.lights.shape[0]
    print(f"[raster] theater {w}x{h}: the default renderer {type(raster).__name__}, scheme "
          f"'auto' resolves to {scheme!r}, {layers} layers, {n_lights} lights", flush=True)
    if scheme != "kernel":
        fail("the rasterizer on theater must take scheme='kernel'")
    shading = raster_shading(raster)
    # the first plain frame's calls of the shading kernels, recorded before
    # each call
    raster_calls = {name: [] for name in raster_names}

    def raster_call(name):
        def rec(*a):
            if len(raster_calls[name]) < shading[name]:
                raster_calls[name].append(clone(a))
            return getattr(PLAIN, name)(*a)
        return rec

    plain = Rasterizer(w, h, e.scene, e.camera, raster_config, dev,
                       kernels=PLAIN._replace(**{n: raster_call(n) for n in raster_names}))
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(args.frames)]
    del plain
    frames, raster_launches, frame_ms, peak = drive_frames("raster", raster, args.frames)
    expect_launches("the rasterizer on theater", raster_launches, args.frames,
                    {"closest_hit": layers, "any_hit": layers * n_lights, "fxaa": 1,
                     "sparse_flags": 0, "sparse_key": 0, "sparse_closest": 0,
                     "sparse_any": 0, "sp_pre": 0, "sp_post": 0, **shading})
    check_frames("raster", frames, plain_frames, (h, w, 3))
    expect_identical("raster", frames, plain_frames)
    device_busy("rasterizer-theater-1080p", raster, frame_ms, peak)
    del frames, plain_frames, e, raster
    torch.cuda.empty_cache()

    def scene_bytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def raster_bound(name, a):
        """The least time of one shading-kernel call: its per-pixel streams
        and the scene tables it gathers, each read once, beside its
        operations (OPS_RASTER_*; a texture's by its triangles' numbers)."""
        if name == "raster_surface":
            geometry, rotations, shifts, hu = a[:4]
            n = hu.shape[0]
            return bound(n * 24 + scene_bytes(geometry, rotations, shifts),
                         n * OPS_RASTER_SURFACE)
        if name == "raster_rays":
            n = a[0].shape[1]
            return bound(n * 28 + 12, n * OPS_RASTER_RAY)
        (geometry, attributes, rotations, alb, pbr, tpo, lights, ambient, cam, hu, _, slot,
         _, hdr) = a
        n, n_l = hu.shape[0], lights.shape[0]
        tri = torch.clamp_min(slot, 0).long()
        ops = n * (OPS_RASTER_SHADE + (OPS_RASTER_HDR if hdr else 0) + n_l * OPS_RASTER_LIGHT)
        for k, table in enumerate((alb, pbr, tpo)):
            fetched = int((attributes[tri, 15 + k] != -1.0).sum())
            per = OPS_TEX_FETCH + (OPS_TEX_U8 if table.texels.dtype == torch.uint8 else 0)
            ops += n * OPS_TEX_MISS + fetched * per
        nbytes = (n * (12 + n_l + 16) + scene_bytes(geometry, attributes, rotations, lights,
                                                     ambient, cam, *alb, *pbr, *tpo))
        return bound(nbytes, ops)

    # each shading kernel against its plain version on every call of the
    # frame (layer by layer, a light at a time), timed: the first call's
    # row, the frame's sums beside it
    for name in raster_names:
        sums = [0.0, 0.0, 0.0]
        for i, a in enumerate(raster_calls[name]):
            label = (f"theater {w}x{h}, layer {i // n_lights}, light {i % n_lights}"
                     if name == "raster_rays" else f"theater {w}x{h}, layer {i}")
            bnd = raster_bound(name, a)
            k_ms, p_ms = check(name, label, a, bnd, main=i == 0)
            sums = [sums[0] + k_ms, sums[1] + p_ms, sums[2] + bnd[0]]
        results[name].update(frame_ms=sums[0], frame_plain_ms=sums[1], frame_bound_ms=sums[2])
        print(f"[kernel] {name}: {len(raster_calls[name])} calls a frame, kernel "
              f"{sums[0]:.3f} ms, plain {sums[1]:.3f} ms, bound {sums[2]:.4f} ms a frame",
              flush=True)
    del raster_calls
    torch.cuda.empty_cache()

    # (b) the rasterizer on the dragon stand-in (sparse, glass: 4 layers)
    w2, h2, n2 = w // 2, h // 2, 2
    e, animate = dragon_engine(w2, h2)
    e.config = raster_config
    e.renderer = "rasterizer"
    raster = e.renderer
    scheme, layers = raster.resolved_scheme(), raster.resolved_layers()
    n_lights = raster._buffers.lights.shape[0]
    print(f"[raster-sparse] dragon stand-in {w2}x{h2}: scheme 'auto' resolves to {scheme!r}, "
          f"{layers} layers, {n_lights} lights", flush=True)
    if scheme != "sparse":
        fail("the rasterizer on the dragon stand-in must take scheme='sparse'")
    frames, raster_sparse_launches, frame_ms, peak = drive_frames(
        "raster-sparse", raster, n2, step=animate)
    expect_launches("the rasterizer on the dragon stand-in", raster_sparse_launches, n2,
                    {"sparse_flags": layers * (1 + n_lights), "sparse_closest": layers,
                     "sparse_any": layers * n_lights, "sparse_key": 0, "fxaa": 1,
                     "closest_hit": 0, "any_hit": 0, **raster_shading(raster)})
    device_busy("rasterizer-dragon-540p", raster, frame_ms, peak, step=animate)
    de, step = dragon_engine(w2, h2)
    plain = Rasterizer(w2, h2, de.scene, de.camera, raster_config, dev, kernels=PLAIN)
    plain_frames = []
    for i in range(n2):
        step(i)
        plain_frames.append(torch.from_numpy(plain.render_frame()))
    check_frames("raster-sparse", frames, plain_frames, (h2, w2, 3))
    expect_identical("raster-sparse", frames, plain_frames)
    del frames, plain_frames, e, de, raster, plain
    torch.cuda.empty_cache()

    # (c) the path tracer with TAA on theater: 11 frames, so the ring wraps
    n_taa = 11
    e = engine(w, h)
    plain = PathTracer(w, h, e.scene, e.camera, taa_config, dev, kernels=PLAIN)
    plain_frames = [torch.from_numpy(plain.render_frame()) for _ in range(n_taa)]
    del plain
    torch.cuda.empty_cache()
    e = engine(w, h)
    e.config = taa_config
    e.renderer = "pathtracer"
    if e.renderer.resolved_scheme() != "fused_split":
        fail("the TAA frame on theater must take scheme='fused_split'")
    frames, taa_launches, frame_ms, peak = drive_frames("taa", e.renderer, n_taa)
    expect_launches("the TAA frame", taa_launches, n_taa,
                    {"sp_pre": 1, "sp_post": bounces, "sp_live_list": bounces, "first_blur": 3,
                     "second_blur": 3, "final_blur": 1, "fxaa": 0})
    check_frames("taa", frames, plain_frames, (h, w, 3))
    expect_identical("taa", frames, plain_frames)
    device_busy("theater-1080p-taa", e.renderer, frame_ms, peak)
    del frames, plain_frames, e
    torch.cuda.empty_cache()

    # (d) api="simple": the scan casts, plain in both packages, no kernel
    e = engine(w, h)
    e.api = "simple"
    frames, simple_launches, frame_ms, peak = drive_frames("simple", e.renderer, n2)
    expect_launches("the simple renderer", simple_launches, n2,
                    {name: 0 for name, _ in counted})
    last = frames[-1]
    if last.shape != (h, w, 3) or not np.isfinite(last).all() or float(last.max()) <= 0.0:
        fail(f"simple renderer: frame {last.shape}, finite {np.isfinite(last).all()}, "
             f"max {float(last.max())}")
    print(f"[simple] {type(e.renderer).__name__}: output {list(last.shape)}, mean "
          f"{float(last.mean()):.4f}, finite, not black", flush=True)
    device_busy("simple-theater-1080p", e.renderer, frame_ms, peak)
    del frames, e
    torch.cuda.empty_cache()
    print(f"[paths] {json.dumps(paths)}", flush=True)
    printed_paths = set(paths)
    print(f"[phase] rasterizer, TAA and simple paths: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 10. serve: the pipelined fetch, the frame server, the checkpoint -----
    t0 = time.perf_counter()
    serve_launches = serve_phase(args, dev, engine, counted, device_busy, paths)
    print(f"[phase] serve: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 11. the mxu and clustered casts, two ranks on the card --------------
    t0 = time.perf_counter()
    slice_launches = casts_and_ranks_phase(args, dev, smi, engine, dragon_engine, tools)
    print(f"[paths] {json.dumps({k: v for k, v in paths.items() if k not in printed_paths})}",
          flush=True)
    print(f"[phase] mxu, clustered and ranks: {time.perf_counter() - t0:.1f} s", flush=True)

    loaded = sorted(m for m in sys.modules if m in ("jax", "flexlight_tpu")
                    or m.startswith(("jax.", "jaxlib", "flexlight_tpu.")))
    if loaded:
        fail(f"modules of jax or flexlight_tpu were imported: {loaded[:5]}; "
             "the port must run without them")
    for name in ("closest_hit", "any_hit"):
        launches[name] = kernel_launches[name]
    for name in sparse_names:
        launches[name] = sparse_launches[name]
    launches["interp_shade"] = sparse_launches["interp_shade"]
    launches["alive_list"] = sparse_launches["alive_list"]
    launches["shade"] = shade_launches["shade"]
    results["shade"].update(list_launches=shade_launches["sp_live_list"])
    launches["fused_frame"] = fused_launches["fused_frame"]
    for name in raster_names:
        launches[name] = raster_launches[name]
    kernels = []
    for name, _ in counted:
        # the rasterizer's launches (phase 9) beside the count of each row's own path
        raster = {f"raster_{tag}_launches": c[name] for tag, c in
                  (("theater", raster_launches), ("dragon", raster_sparse_launches))
                  if c[name]}
        # and the frame server's (phase 10 (b)), and phase 11's paths
        if serve_launches[name]:
            raster["serve_launches"] = serve_launches[name]
        for tag, c in slice_launches.items():
            if c.get(name):
                raster[f"{tag}_launches"] = c[name]
        kernels.append({"name": name, "route": "cuda", "launches": launches[name],
                        **results[name], **raster})
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the device check", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
