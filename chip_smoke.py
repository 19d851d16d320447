#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA package `tpupt_torch`.

    python3 chip_smoke.py            # everything, needs one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks on the small scenes
    python3 chip_smoke.py --profile  # everything + a torch.profiler pass of 1 spp
    python3 chip_smoke.py --variants DIR   # everything + other builds of a
        # kernel source timed beside the shipped one: DIR/<source>__<name>.cu,
        # <source> a key of SOURCES, each with the shipped source's C interface

It builds every CUDA kernel from the sources in this checkout (one nvcc per
source, all started together), holds each against its plain PyTorch version
on the card, and drives the main path through the user-facing entry points
(parse_file -> flatten -> Renderer -> render) on generated museums at
1024x1024: the small one (63,558 triangles), whose BVH tables are single-level
and go through kernel `traverse_wide`; the same museum with
`Accelerator "kdtree"` and with `Accelerator "rbsp"` (3 directions), which
go through kernel `traverse_kdbsp`; and the 1,032,454-triangle one, whose
tables are two-level and go through kernel `traverse_treelets`, and a second
time through the re-queue driver (`Renderer(..., isect=intersect_requeue)`),
which runs kernels `bin_rays` and `walk_pairs` and, for rays whose treelet
list overflowed, `traverse_treelets`.
The launch counts show that each render went through its kernels, and each
render is compared with one made by the kernels' plain versions (on a
64x64 crop in the middle of the image: the plain walkers take a second or
more a traversal). K1, K2 and K3 are also held against their plain versions
on batches of 98 % dead rays, of dead rays only, of one ray and of 131,073
rays; at the main shape every kernel prints the wrapper call and the
kernel alone (CUDA events around the launch), and K3 is timed as the
re-queue driver's fallback launch too, with its bound; K4 and K5 are held
against their plain versions inside the driver's own pass loop (K4's lists
and overflow counts; each ray's packed best hit, the winners' payloads and
the counters), and K4 also on the dead-heavy, all-dead, one-ray and
131,073-ray batches, all to the bit. Then the `gradients` phase takes
`Renderer.value_and_grad` of bench.py's loss, sum(film.rgb), with respect to
`mat_kd`, `mat_ks`, `mat_roughness` and `light_L` on both museums at
1024x1024 (K1 and K3, 1 sample each), with the launch counts set to 0
just before and read just after, each beside the same renderer's forward
sample and against the same step through the plain version on the middle
crop, and two `parallel.mesh.train_step_fn` steps on the small museum.
The `appearance` phase renders `tools/testscenes.py` `textured_museum` (the
small museum with an image-mapped floor from a 2048x2048 PFM, a
checkerboard wall, marble / wrinkled statues, an environment-mapped
infinite light of 2048x1024 and a goniometric light) at 1024x1024 through
K1, against the plain version on the crop, takes `value_and_grad` with
respect to `mat_kd`, `light_L`, `tex_atlas` and `env_map` (the film is
linear in the two emitter tables jointly) and two training steps toward
its image with the environment map halved.
The `materials` phase renders `tools/testscenes.py` `materials_museum`
(the small museum's statues in Disney, mix, Fourier, subsurface,
kdsubsurface and plastic, a tuft of hair curves, the sobol sampler) at
1024x1024 through K1, which each vertex now launches four times (closest
hit, NEE shadow, the subsurface probe and the exit's shadow ray), beside
the untextured museum in the same run and against the plain version on the
crop; takes `value_and_grad` with respect to the bench's four tables; and
holds the five new samplers' values on the card against the CPU's, bit for
bit, on a grid of 64x64 pixels, 8 samples and 64 dimensions.
The `kernels` phase also holds K1's motion instance (the leaf step lerps
each triangle to the ray's shutter time through the prim rows' vertex
deltas) bit for bit against the plain walker at the rays' times, closest
and any hit, with counters, on 262,144 rays of `tools/testscenes.py`
`motion_museum` at random times (camera rays of its animated camera and the
secondary rays from their hits), on the same scene's two-level upload (a
motion scene goes through K1 over the rows the treelets are cut from) and
on the dead-heavy, all-dead, one-ray and 131,073-ray batches, and times it
alone beside the static instance on the same 131,072 secondary rays.
The `motion` phase renders `motion_museum` (the small museum, its statues
moving over the shutter, one of them turning, its camera animated) at
1024x1024 through K1's motion instance beside the static museum in the
same phase, against the plain walker on the crop, with a 1-spp
`value_and_grad` and its linearity; renders the static museum through the
realistic camera (`testscenes.realistic_museum`: a six-row lens of the
package's own with an aperture stop) against the plain walker on the crop,
with the share of camera rays vignetted; and runs `tools/sweep.py` over
`acc=bvh,kdtree` at 256x256, 1 spp, on the card.
The `kernels` phase also builds `tools/testscenes.py` `fog_museum` (the
small museum in a room fog, a 128^3 grid plume behind a null-material
interface box, a tinted glass statue) and holds both entry points of K6,
the grid-medium tracking kernel (`tr_grid`, `sample_distance_grid`),
against their plain loops, bit for bit (`interacted`, t and the
transmittance), on 262,144 lanes started in the plume and on the
dead-heavy, all-dead, one-lane and 131,073-lane batches; and K6's backward
(`tr_grid_backward`, the adjoint of ratio tracking) against its plain
version for a seeded cotangent on the same lanes and batches and on two
more, the plume made dense enough for factors of exactly 0 and half its
texels emptied (the tie of max(x, 0)): the per-lane gradients to the bit,
the atlas gradient (summed by atomics) within a stated tolerance.
The `media` phase renders `spectral_museum` (60-bin spectral transport,
saturated rows under a blackbody light) through K1 and `fog_museum`
(volpath) through K1 and K6 at 1024x1024, beside the static museum in the
same phase, each against the plain versions on the crop; holds K6 against
its plain loops and times it on every call of the fog museum's middle
batch, its backward on each tr_grid call of that batch; and takes a 1-spp
`value_and_grad` of each (the film linear in light_L), the fog museum's
with respect to every float medium table too (K6's backward launched once a
tr_grid call of pass 2), against the plain versions on the crop.
The `integrators` phase renders the small museum through K1 at 1024x1024
and depth 5 under the direct-lighting ("one"), Whitted, ambient-occlusion
and BDPT integrators (1 spp each, BDPT's t == 1 strategies into the film's
splats), with MLT (`MLTRenderer`: one batch of bootstrap paths a depth, one
mutation a pixel) and with SPPM (`SPPMRenderer`: one iteration of one
photon a pixel), each with the launch counts set to 0 just before and read
just after and held to the calls its loops make; before them, every K1
call of one BDPT batch, one MLT mutation step and one SPPM photon chunk is
held bit for bit against the plain walker. Each of the first four also
takes a 1-spp `value_and_grad` at 256x256 (BDPT's loss on its splats too):
finite gradients, the film linear in light_L (AO's reads no table: its
gradients 0).
The `mesh` phase drives `parallel/mesh.py` on this one card: two ranks
spawned as processes of their own over gloo (two NCCL ranks cannot share a
card) render the small museum at 1024x1024 through `ShardedRenderer`, each
its own four of the sample's eight batches (48 K1 launches a rank), to a
film equal to the main path's render to the bit on every pixel of at most
two samples (the card's atomics sum three or four in no fixed order, as
in two renders of one process); BDPT at 256x256 over them against one
process at the same batch (splats within a stated tolerance: summed in
another order) and one training step over them against one process's; a
one-rank job over NCCL renders the museum again through its all-reduce. Meanwhile `tools/bsdftest.py` runs its
eight materials on the card against the CPU. A failing rank fails the
run. The two ranks' ms per spp are two ranks sharing one card, not a
scaling figure. To keep the script's time since the mesh phase came, the
appearance, materials, motion and media phases take their value_and_grad
at 512x512, the training steps run at 512x512 (the `gradients` phase's
value_and_grad stays at 1024x1024), the direct-lighting render takes one
light a vertex, and the samplers are compared on 8 sample indices.
There is no fallback: without a CUDA device, without the `tpupt_torch`
package beside it, with a kernel that does not build, launch or agree, or
with any failed check, it exits with a code other than 0 and prints no
result line.

Output: one JSON object per phase (`env`, `kernels`, `main_path`,
`gradients`, `appearance`, `materials`, `motion`, `media`, `integrators`,
`mesh`),
then the card's name and power
limit, the `{"kernels": [...]}` line, and last `{"ok": true, "device":
{...}}`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpupt_torch.accel import kdbsp
from tpupt_torch.accel import traverse as trav
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.cameras.realistic import realistic_rays
from tpupt_torch.core import rng as rng_mod
from tpupt_torch.core.sampling import cosine_sample_hemisphere
from tpupt_torch.core.vecmath import offset_ray_origin
from tpupt_torch.integrators.path import Renderer, shading_point
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.native import get_lib as get_native_lib
from tpupt_torch.media import media as mmod
from tpupt_torch.ops import media_tracking as mtk
from tpupt_torch.ops import traverse_kdbsp as tk
from tpupt_torch.ops import traverse_requeue as tr
from tpupt_torch.ops import traverse_treelets as tt
from tpupt_torch.ops import traverse_wide as tw
from tpupt_torch.parallel import mesh as mesh_mod
from tpupt_torch.parallel.mesh import train_step_fn
from tpupt_torch.scene.device import (build_scene_bvh, from_numpy, upload,
                                      with_alt_accel)
from tpupt_torch.scene.flatten import (MAT_KDSUBSURFACE, MAT_SUBSURFACE,
                                       flatten, with_resolution)
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.textures.textures import ALL_TYPES
from tpupt_torch.tools import bsdftest, genscene, testscenes
from tpupt_torch.tools import sweep as sweep_tool
from tpupt_torch.utils.build import (BUILD_DIR, CSRC_DIR, NVCC_FLAGS,
                                     compile_shared, find_nvcc)

ULP_LIMIT = 4            # t / b1 / b2 of kernel vs plain version, in ulps
MAIN_RES = 1024
MUSEUM_1M = dict(grid=8, seg=128, rings=64)      # 1,032,454 triangles
MUSEUM_65K = dict(grid=4, seg=64, rings=32)      # 63,558 triangles
MUSEUM_1K = dict(grid=2, seg=16, rings=8)        # 1,028 triangles
# 1 sample a render of the main path and the appearance and materials
# phases: with 2, the script took more than 750 s on a slow host
SPP_1M = 1
SPP_65K = 1
# the plain walkers render this crop of the image, the kernels too for the
# comparison: 64x64 pixels in the middle, one batch a sample
PLAIN_CROP = (0.46875, 0.53125, 0.46875, 0.53125)
# the gradients phase: value_and_grad of bench.py's loss, sum(film.rgb), with
# respect to the four tables it differentiates, 1 sample on the small museum
# and 1 on the 1M one; the film is linear in light_L, so
# sum(light_L * dloss/dlight_L) equals the loss to LINEARITY_RTOL; the
# gradients through the kernels against those through their plain versions
# on PLAIN_CROP, per table |g_kernel - g_plain| <= GRAD_VS_PLAIN * max |g_plain|
# (the hits are equal to the bit; the tables' gathers add their cotangents
# with atomics, in no fixed order); value_and_grad's film against render's,
# mean relative difference (3e-11 and 2e-10 on the card: the film's
# index_add sums with atomics too)
GRAD_PARAMS = ("mat_kd", "mat_ks", "mat_roughness", "light_L")
SPP_GRAD_65K, SPP_GRAD_1M = 1, 1
LINEARITY_RTOL = 1e-4
GRAD_VS_PLAIN = 1e-5
FILM_VS_RENDER_REL = 1e-6
# two SGD steps of train_step_fn toward the small museum rendered with
# every diffuse albedo halved, at TRAIN_RES (MAIN_RES before the mesh phase
# came: 14.6 s of steps on an H100 at 700 W)
TRAIN_STEPS, TRAIN_LR, TRAIN_RES = 2, 0.5, 512
# the later phases' value_and_grad (appearance, materials, motion, media)
# runs at GRAD_RES (MAIN_RES before the mesh phase came: the script took
# up to 1,132.6 s on an H100 at 700 W, hosts differing 1.4x, and the
# materials museum's fwd+bwd alone 39.4 s); the gradients phase keeps
# MAIN_RES
GRAD_RES = 512
# the appearance phase: tools/testscenes.py textured_museum at MUSEUM_65K's
# size (a 2048x2048 floor texture, a 2048x1024 environment map with a sun
# disc, a 256x128 goniometric map), SPP_APPEAR samples through K1;
# value_and_grad of bench_loss with respect to APPEAR_PARAMS (the film is
# linear in light_L and env_map jointly: sum(light_L * g) + sum(env_map * g)
# equals the loss to LINEARITY_RTOL), and two training steps of the same
# tables toward the image rendered with env_map halved
APPEAR_MAPS = dict(tex_res=2048, env_res=(2048, 1024), gonio_res=(256, 128))
APPEAR_PARAMS = ("mat_kd", "light_L", "tex_atlas", "env_map")
SPP_APPEAR = 1   # see SPP_65K
APPEAR_TRAIN_LR = 0.05
# the materials phase: tools/testscenes.py materials_museum at MUSEUM_65K's
# size with MATERIALS_HAIRS hair curves, SPP_MATERIALS samples through K1,
# which a vertex launches 4 times (closest hit, NEE shadow, the subsurface
# probe and exit shadow ray); value_and_grad of bench_loss with respect to
# GRAD_PARAMS over SPP_MATERIALS samples, sum(light_L * g) within
# MATERIALS_LINEARITY_RTOL of the loss; the new samplers' values on the
# card against the CPU's, bit for bit, on SAMPLER_GRID (pixels a side,
# sample indices, dimensions)
MATERIALS_HAIRS = 256
SPP_MATERIALS = 1   # see SPP_65K
MATERIALS_LINEARITY_RTOL = 1e-5
NEW_SAMPLERS = ("sobol", "02sequence", "lowdiscrepancy", "maxmindist",
                "stratified")
# (16 sample indices before the mesh phase came: 13.7 s of checks)
SAMPLER_GRID = (64, 8, 64)
# the motion phase: tools/testscenes.py motion_museum at MUSEUM_65K's size,
# SPP_MOTION samples through K1's motion instance (a vertex launches it
# twice: 96 launches a spp), one fwd+bwd sample of value_and_grad with
# respect to GRAD_PARAMS (sum(light_L * g) within LINEARITY_RTOL of the
# loss); realistic_museum (the small museum through the test lens, its
# aperture stop REALISTIC_APERTURE_MM wide), SPP_REALISTIC samples through
# K1's static instance; tools/sweep.py over SWEEP_SET at SWEEP_RES, 1 spp
SPP_MOTION = 1
SPP_REALISTIC = 1
REALISTIC_APERTURE_MM = 10.0
SWEEP_SET, SWEEP_RES = "acc=bvh,kdtree", 256
# bytes the motion instance loads beside the static one's: a triangle's
# 48-byte delta row (three float4) and a live ray's time; 18 float32
# operations a triangle test more (three vertices lerped: 9 mul, 9 add)
DELTA_ROW_BYTES, TIME_BYTES, OPS_PER_LERP = 48, 4, 18
# the media phase: tools/testscenes.py spectral_museum (60-bin transport)
# and fog_museum (volpath; a FOG_GRID_RES^3 grid plume) at MUSEUM_65K's
# size, SPP_MEDIA samples each through K1 (and K6), against the plain
# versions on PLAIN_CROP; one fwd+bwd sample each: the spectral museum with
# respect to GRAD_PARAMS, the fog museum to MEDIA_PARAMS (every float
# medium table with them: a grid medium's transmittance through K6's
# backward), the fog museum's also against the plain versions on the crop
SPP_MEDIA = 1
FOG_GRID_RES = 128
MEDIA_PARAMS = ("mat_kd", "light_L", "med_sigma_a", "med_sigma_s", "med_g",
                "med_majorant", "med_density", "med_w2m")
# K6 against its plain version: interacted equal on every lane, t and the
# transmittance within K6_ULP_LIMIT ulps (0: to the bit)
K6_ULP_LIMIT = 0
# instructions of K6's source, counted by hand: a step of a lane's loop
# (three PCG hashes, the uniform, a log, the update and test of t) and a
# density lookup with its decision (the point, the world-to-medium product,
# eight clamped texel reads, the trilinear weights; delta tracking adds a
# second uniform)
OPS_PER_TRACK_STEP = 61
K6_OPS_PER_LOOKUP = {"tr_grid": 247, "sample_distance_grid": 287}
# bytes a live lane reads (medium id, live byte, origin, direction, t_c,
# key), a texel, and what a lane writes (the transmittance; interacted + t)
LANE_IN_BYTES, TEXEL_BYTES = 37, 4
K6_OUT_BYTES = {"tr_grid": 4, "sample_distance_grid": 5}
K6_REPLACES = {
    "tr_grid": "tpupt/media/media.py:330 (tr_lane's ratio-tracking loop, "
               "XLA; no Pallas kernel)",
    "sample_distance_grid": "tpupt/media/media.py:379 (sample_distance_"
                            "lane's delta-tracking loop, XLA; no Pallas "
                            "kernel)",
    "tr_grid_backward": "tpupt/media/media.py:326-337 (jax.grad of tr_lane's "
                        "ratio-tracking loop, XLA; no Pallas kernel)"}
# K6's backward against its plain version (tr_grid_backward_plain): the
# per-lane outputs to the bit; the density atlas's gradient, summed by
# atomics in no fixed order (a texel takes the terms of every step of every
# lane that reads it), within K6_ATLAS_REL of its largest absolute value.
# Its operations, counted by hand in the source: the forward walk's (a step
# and a lookup as `tr_grid`'s, two more a step for the sum of draws) and a
# step of the walk back (the lookup again with its eight corners' indices,
# the adjoint of the product, the trilinear weights, the world-to-medium
# rows and the point; eight atomic adds); what a lane writes (20 floats)
# and reads beside the forward's inputs (its cotangent)
K6_ATLAS_REL = 1e-5
K6_BWD_OPS_PER_STEP = OPS_PER_TRACK_STEP + 2
K6_BWD_OPS_PER_LOOKUP = K6_OPS_PER_LOOKUP["tr_grid"] + 344
K6_BWD_OUT_BYTES, K6_BWD_IN_BYTES = 80, 4
# the edge batches of K6's backward beyond the forward's: the plume's
# density K6_ZERO_FACTOR_SCALE times itself under the same majorant (steps
# whose factor is exactly 0), and the lower half of the plume's texels
# emptied (the tie of max(x, 0) at x == 0)
K6_ZERO_FACTOR_SCALE = 4.0
# the integrators phase: the small museum at MAIN_RES and its depth (5)
# through K1 under the direct-lighting ("one" light a vertex: Whitted runs
# the "all" strategy; "all" before the mesh phase came), Whitted,
# ambient-occlusion
# (16 samples: tpupt's cap) and BDPT integrators, 1 spp each; MLT with one
# renderer batch of bootstrap paths a depth and MLT_MUTATIONS mutations a
# pixel; SPPM, SPPM_ITERATIONS iterations of one photon a pixel. Through a
# checking `isect`, every K1 call of one BDPT batch, one MLT mutation step
# and one SPPM photon chunk is held bit for bit against the plain walker
MLT_MUTATIONS = 1
SPPM_ITERATIONS = 1
INTEGRATORS = ("directlighting", "whitted", "ambientocclusion", "bdpt")
# and value_and_grad of each of INTEGRATORS at INTEGRATOR_GRAD_RES (1 spp,
# the loss sum(film.rgb) + sum(film.splat), with respect to GRAD_PARAMS):
# the film linear in light_L (AO's reads no table: every gradient 0)
INTEGRATOR_GRAD_RES = 256
# the mesh phase: the small museum at MAIN_RES through a one-rank NCCL
# ShardedRenderer (its film against the main path's render of the same
# museum), and through two ranks spawned over gloo on this one card (the
# same film, each rank launching half a sample's K1 calls); films equal to
# the bit on every pixel of at most two samples and within MESH_ORDER_RTOL
# on the few of three or four, which the card's atomics sum in no fixed
# order (59 pixels of 1,048,576 differ between two renders of one process);
# BDPT at MESH_RES over the two ranks against one process at the same batch
# (the same, and the splats within MESH_SPLAT_REL of the largest: summed in
# another order), and one training step over them
# against one process's (loss within MESH_LOSS_RTOL, each table's step
# (p - p_new) / lr within MESH_STEP_REL of its largest plus a float32 ulp of
# the parameter over lr); bsdftest's eight materials on the card against
# the CPU (rho within BSDF_RHO_RTOL, the same verdict)
MESH_RES = 256
MESH_ORDER_RTOL = 1e-6
MESH_SPLAT_REL = 1e-5
MESH_LOSS_RTOL = 1e-5
MESH_STEP_REL = 1e-5
MESH_TRAIN_LR = 0.5
MESH_TIMEOUT_S = 300.0
BSDF_SAMPLES = 100_000
BSDF_RHO_RTOL = 1e-5
# kd-tree, restricted BSP with 3 / 7 / 13 directions, one tree with a
# direction per node and one with kd nodes mixed in: (name, nbDirections)
KD_TREES = [("kdtree", None), ("rbsp", 3), ("rbsp", 7), ("rbsp", 13),
            ("bspcluster", 3), ("bsppaperkd", None)]
KD_VS_BVH_MEAN_REL = 1e-3   # mean image of a kd / RBSP render against the BVH's
N_CHECK_RAYS = 262144
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside tensor cores
L2_FLUSH_BYTES = 256 * 1024 * 1024   # five times the card's 50 MB L2
# bytes a kernel loads of a row it visits: 14 of a node row's 16 float4, 4 of
# a triangle row's 8, 7 of a quadric row's 8; one int2 per treelet entered
NODE_ROW_BYTES, TRI_ROW_BYTES, QUADRIC_ROW_BYTES, TREELET_REF_BYTES = 224, 64, 112, 8
# a kd / BSP node is one 32-byte row: an interior step reads it whole, a leaf
# step only its second half (leaf flag, first prim row, prim count)
KD_NODE_ROW_BYTES, KD_LEAF_ROW_BYTES = 32, 16
# per ray: tmax always (4 B), origin and direction when it is live (24 B);
# t, b1, b2, gid, row id and three counters written (32 B)
RAY_LIVE_BYTES, RAY_BYTES = 24, 4 + 32
# float32 operations of one interior-node step (8 x [6 sub, 6 mul, 12 min/max,
# 1 mul, 4 compares, 1 max] + 19 compare-exchanges of 5 ops) and of one
# triangle test (9 sub, 6 shear mul-sub pairs, 3 edge functions of 3 ops,
# t_scaled 5, det 2, 3 z mul, 1 div, 3 mul, ~10 compares)
OPS_PER_NODE = 8 * 30 + 19 * 5
OPS_PER_PRIM = 65
# one kd / BSP interior step: two 3-term projections (10), the plane distance
# (1 sub, 1 abs, 1 compare, 1 div), the side test (3 compares) and the child
# choice (5 compares)
OPS_PER_KD_NODE = 22

# lanes of a dead-heavy check batch that are dead: the re-queue fallback's
# shape (about 98 % of its rays have tmax 0)
DEAD_SHARE = 0.98
# the busy wait queued ahead of each launch timed alone (about 1 ms), so that
# the launch waits on the card and not on the host
SLEEP_CYCLES = 2_000_000

# the kernel sources, one nvcc run each (and one more with -fmad=true)
SOURCES = {"traverse_wide": tw, "traverse_treelets": tt,
           "traverse_kdbsp": tk, "traverse_requeue": tr,
           "media_tracking": mtk}

# every traversal kernel of the main path: wrapper module, wrapper, plain
# version, the tables it reads (in the order of the plain version's
# `touched` masks)
KERNELS = {
    "traverse_wide": dict(
        mod=tw, call=tw.intersect_wide_cuda, plain=trav.intersect_wide,
        tables=("wide_nodes", "prim_rows"), node_row_bytes=NODE_ROW_BYTES,
        ops_per_node=OPS_PER_NODE,
        replaces="tpupt/ops/traverse_pallas.py:314"),
    "traverse_treelets": dict(
        mod=tt, call=tt.intersect_treelets_cuda, plain=trav.intersect_two_level,
        tables=("top_nodes", "tl_nodes", "tl_prims", "tl_offsets"),
        node_row_bytes=NODE_ROW_BYTES, ops_per_node=OPS_PER_NODE,
        replaces="tpupt/ops/traverse_stream.py:51"),
    "traverse_kdbsp": dict(
        mod=tk, call=tk.intersect_kdbsp_cuda, plain=kdbsp.intersect_kdbsp,
        tables=("alt_nodes", "alt_prim_rows"),
        node_row_bytes=KD_NODE_ROW_BYTES, ops_per_node=OPS_PER_KD_NODE,
        replaces="tpupt/ops/traverse_kdbsp.py:143"),
}


# the two kernels of the re-queue traversal (one source, one library), and
# how often each kernel launches in one call of its driver: K4 once, K5 once
# a pass, K3 once for the rays whose list overflowed (tmax 0 on the others)
REQUEUE_KERNELS = {"bin_rays": "tpupt/ops/traverse_requeue.py:65",
                   "walk_pairs": "tpupt/ops/traverse_requeue.py:176"}
REQUEUE_PER_CALL = {"bin_rays": 1, "walk_pairs": 2, "traverse_treelets": 1}
# list capacities checked: the default, and 2, at which lists overflow and
# the fallback through K3 takes over
REQUEUE_R_LISTS = (tr.R_LIST, 2)
# exact-t ties (a hit on an edge two triangles share, found in another order)
# may pick the other prim; at most this share of the hits
REQUEUE_TIE_SHARE = 1e-3
REQUEUE_VS_K3_MEAN_REL = 1e-6   # mean image of the re-queue render against K3's
# one top-tree step of bin_rays: 8 slab tests of 30 operations, no sort; it
# writes an 8-byte (treelet, entry t) record per list slot and one count a ray
OPS_PER_BIN_NODE = 8 * 30
LIST_RECORD_BYTES = 8
# walk_pairs moves, per live pair, its key and ray (8 B); per ray with a pair
# in the pass, its start t, origin and direction read and its 64-bit word and
# three counters written (4 + 24 + 8 + 12 B); per ray whose winner is of this
# pass, the winner's (gid, row, b1, b2) written (16 B)
PAIR_BYTES = 8
RAY_PASS_BYTES = 4 + 24 + 8 + 12
WINNER_BYTES = 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.time()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also says when it ended, in seconds
    since the script started (`t_s`)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.time() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two float32 tensors in units in the last place."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def time_ms(fn, reps: int) -> float:
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


class TimedLib:
    """A kernel library each of whose launcher calls is queued behind a busy
    wait of the card (about 1 ms, so that the launch waits on the card and
    not on the host) and bracketed by two CUDA events recorded on the
    current stream just before and after it."""

    def __init__(self, lib):
        self.lib, self.events = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def timed(*args):
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*args)
            end.record()
            self.events.append((start, end))
            return rc
        return timed


def kernel_alone_ms(run, lib, reps: int = 10) -> float:
    """Device time of the kernel launches inside `run(lib)` (wrapper calls
    given the library `lib`), without the wrappers' allocations and the
    PyTorch work around them: the sum over the launches of one call of the
    time between events just before and after each launch (`TimedLib`),
    averaged over `reps` calls after one warm-up call."""
    run(lib)
    torch.cuda.synchronize()
    timed = TimedLib(lib)
    for _ in range(reps):
        run(timed)
    torch.cuda.synchronize()
    if not timed.events or len(timed.events) % reps:
        fail(f"{len(timed.events)} launches timed alone over {reps} calls")
    return sum(s.elapsed_time(e) for s, e in timed.events) / reps


def variant_timing(run, shipped_lib, variants, check, check_run=None) -> dict:
    """Other builds of a kernel source (`variants`: name -> library) beside
    the shipped one: each variant's `check_run(lib)` output (default
    `run(lib)`) is held against the plain version by `check(name, output)`,
    then every build's wrapper call (`call_ms`) and kernel alone
    (`kernel_alone_ms`) are timed in turns: every build in order, then in
    reverse order; two figures a build."""
    libs = [("shipped", shipped_lib)] + list(variants.items())
    for name, lib in libs[1:]:
        check(name, (check_run or run)(lib))
    out = {"call_ms": {n: [] for n, _ in libs},
           "kernel_alone_ms": {n: [] for n, _ in libs}}
    for name, lib in libs + libs[::-1]:
        out["call_ms"][name].append(time_ms(lambda: run(lib), 10))
        out["kernel_alone_ms"][name].append(kernel_alone_ms(run, lib))
    return out


def time_cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """As time_ms, but each call finds the L2 cache holding `flush` (a buffer
    larger than the cache, rewritten before every call) instead of the
    tables the call before it read."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def compare_hits(tag, kernel_out, plain_out, with_stats=True):
    """Mismatch counts and worst ulp distance of a kernel result against the
    plain version's; fails the run on any miss."""
    (hk, sk), (hp, sp) = kernel_out, plain_out
    valid = hp.valid
    res = dict(
        valid_mismatch=int((hk.valid != hp.valid).sum()),
        prim_mismatch=int((hk.prim != hp.prim).sum()),
        hits=int(valid.sum()),
    )
    if with_stats:
        res["counter_mismatch"] = int(
            (sk.node_visits != sp.node_visits).sum()
            + (sk.leaf_visits != sp.leaf_visits).sum()
            + (sk.prim_tests != sp.prim_tests).sum())
    both = valid & hk.valid
    worst = 0
    max_abs = 0.0
    if bool(both.any()):
        for name in ("t", "b1", "b2"):
            a, b = getattr(hk, name)[both], getattr(hp, name)[both]
            worst = max(worst, int(ulp_diff(a, b).max()))
            max_abs = max(max_abs, float((a - b).abs().max()))
        max_abs = max(max_abs, float(
            (hk.p_obj[both] - hp.p_obj[both]).abs().max()))
    res["max_ulp"] = worst
    res["max_abs_err"] = max_abs
    bad = (res["valid_mismatch"] or res["prim_mismatch"]
           or res.get("counter_mismatch", 0) or worst > ULP_LIMIT)
    if bad:
        fail(f"kernel disagrees with its plain version on {tag}: {res}")
    return res


def build_kernels(variant_dir=None):
    """Every kernel source twice (as shipped, and with contraction of a*b+c
    allowed to record what the bit-exact build gives up; the latter is used
    for timing only), and each `variant_dir/<source>__<name>.cu`, one nvcc
    run each, all started together. Returns (seconds, ptxas figures, fmad
    libraries, {source: {variant: (library, ptxas figures)}})."""
    t0 = time.time()
    variants = {}
    if variant_dir:
        for f in sorted(os.listdir(variant_dir)):
            kind, _, rest = f.partition("__")
            if f.endswith(".cu") and kind in SOURCES and rest:
                variants.setdefault(kind, {})[rest[:-3]] = os.path.join(
                    variant_dir, f)
    with ThreadPoolExecutor(max_workers=2 * len(SOURCES) + sum(
            len(v) for v in variants.values())) as pool:
        shipped = {k: pool.submit(m.build, ["-Xptxas", "-v"])
                   for k, m in SOURCES.items()}
        fmad = {k: pool.submit(
            m.build, ["-fmad=true"],
            os.path.join(BUILD_DIR, f"libtpupt_{k}_fmad.so"))
            for k, m in SOURCES.items()}
        var = {(k, name): pool.submit(
            compile_shared, [find_nvcc()] + NVCC_FLAGS
            + ["-Xptxas", "-v", "-I", CSRC_DIR], src,
            os.path.join(BUILD_DIR, f"libvariant_{k}__{name}.so"))
            for k, v in variants.items() for name, src in v.items()}
        logs = {k: f.result()[1] for k, f in shipped.items()}
        fmad_libs = {k: SOURCES[k].load(f.result()[0])
                     for k, f in fmad.items()}
        var_libs = {}
        for (k, name), f in var.items():
            log = f.result()
            var_libs.setdefault(k, {})[name] = (
                SOURCES[k].load(os.path.join(
                    BUILD_DIR, f"libvariant_{k}__{name}.so")),
                ptxas_lines(log))
    for m in SOURCES.values():
        m.get_lib()
    ptxas = {k: ptxas_lines(log) for k, log in logs.items()}
    return time.time() - t0, ptxas, fmad_libs, var_libs


def ptxas_lines(log: str) -> dict:
    """What `-Xptxas -v` says of every kernel instance (registers, stack
    frame, spills, static shared memory), by mangled entry name. Dynamic
    shared memory (K4's lists: 2 * 128 * (r_list | 1) ints a block) is not
    in it."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
            out[entry] = []
        elif entry and ("registers" in ln or "spill" in ln):
            out[entry].append(ln.strip().split(":", 1)[-1].strip())
    return out


def launch_counts() -> dict:
    """Launches of every kernel since the counts were last set to 0 (K1's
    motion instance apart from its static ones)."""
    return {"traverse_wide": tw.launches,
            "traverse_wide_motion": tw.launches_motion,
            "traverse_treelets": tt.launches,
            "traverse_kdbsp": tk.launches, **tr.launches, **mtk.launches}


def zero_launches() -> None:
    tw.launches = tw.launches_motion = tt.launches = tk.launches = 0
    for counts in (tr.launches, mtk.launches):
        for k in counts:
            counts[k] = 0


def check_stack_depths() -> None:
    tw.check_stack_depth()
    tk.check_stack_depth()
    tr.check_stack_depth()


def check_cases(kind, cases, checks):
    """Kernel `kind` against its plain version on each case, closest and any
    hit, with and without counters; fails the run on any miss."""
    call, plain_fn = KERNELS[kind]["call"], KERNELS[kind]["plain"]
    for name, ds, st, o, d, tmax in cases:
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            t0 = time.time()
            plain = plain_fn(ds, st, o, d, tmax, any_hit=any_hit)
            torch.cuda.synchronize()
            checks[f"{kind}/{name}/{mode}/plain_ms"] = (time.time() - t0) * 1e3
            for with_stats in (True, False):
                tag = f"{kind}/{name}/{mode}/{'stats' if with_stats else 'nostats'}"
                out = call(ds, st, o, d, tmax, any_hit=any_hit,
                           with_stats=with_stats)
                torch.cuda.synchronize()
                res = compare_hits(tag, out, plain, with_stats)
                res["kernel_ms"] = time_ms(
                    lambda: call(ds, st, o, d, tmax, any_hit=any_hit,
                                 with_stats=with_stats), 5)
                checks[tag] = res


def edge_cases(name, ds, st, o, d, tmax, seed):
    """Batches of the shapes a kernel must also get right: 98 % of the
    lanes dead (the re-queue fallback's shape), every lane dead, one ray,
    and 131,073 rays (one past a multiple of every block size)."""
    gen = np.random.default_rng(seed)
    dead = torch.from_numpy(gen.random(o.shape[0]) < DEAD_SHARE).to(o.device)
    i = int(torch.nonzero(tmax > 0)[0])
    cut = 131073
    return [
        (f"{name}/dead98", ds, st, o, d,
         torch.where(dead, 0.0, tmax).contiguous()),
        (f"{name}/all_dead", ds, st, o, d, torch.zeros_like(tmax)),
        (f"{name}/n1", ds, st, o[i:i + 1].contiguous(),
         d[i:i + 1].contiguous(), tmax[i:i + 1].contiguous()),
        (f"{name}/n{cut}", ds, st, o[:cut].contiguous(), d[:cut].contiguous(),
         tmax[:cut].contiguous())]


def warm_up(renderer):
    """One batch of sample 0 outside any timed or counted run: every batch
    of a render has its shape, so it warms what a whole sample would."""
    with torch.no_grad():
        renderer._step(renderer.new_film(), 0, 0)
    torch.cuda.synchronize()


def drive(renderer, per_call: dict, spp, calls_per_vertex: int = 2,
          vertices: int = None):
    """Render `spp` samples through the entry point with the launch counts
    set to 0 just before and read just after; `per_call` says how often
    each kernel launches in one traversal call (every other kernel must not
    launch at all), `calls_per_vertex` how many traversal calls a path
    vertex makes, `vertices` how many loop iterations a batch runs (default
    max_depth + 1). Returns (film, ms per spp, launches of every kernel)."""
    depth = renderer.scene.integrator.max_depth
    calls = (calls_per_vertex * (vertices or depth + 1) * renderer.n_batches
             * spp)
    warm_up(renderer)
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.time()
    film = renderer.render(spp=spp)
    torch.cuda.synchronize()
    ms_per_spp = (time.time() - t0) * 1e3 / spp
    counts = launch_counts()
    check_stack_depths()
    for k, c in counts.items():
        want = round(calls * per_call.get(k, 0))
        if c != want:
            fail(f"render through {sorted(per_call)} launched {k} {c} times, "
                 f"expected {want}")
    return film, ms_per_spp, counts


def check_image(renderer, film, tag):
    img = renderer.image(film)
    if img.shape != (MAIN_RES, MAIN_RES, 3):
        fail(f"{tag}: image shape {img.shape}")
    finite_share = float(np.isfinite(img).all(-1).mean())
    mean_lum = float((img @ np.array([0.212671, 0.715160, 0.072169])).mean())
    if finite_share != 1.0 or not mean_lum > 0.0:
        fail(f"{tag}: finite share {finite_share}, mean luminance {mean_lum}")
    return finite_share, mean_lum


def plain_traversal(kind):
    """Kernel `kind`'s plain version behind the `isect` interface."""
    plain_fn = KERNELS[kind]["plain"]

    def plain_isect(ds_, st_, o_, d_, tmax_, any_hit=False, with_stats=True,
                    **kw):
        return plain_fn(ds_, st_, o_, d_, tmax_, any_hit=any_hit, **kw)
    return plain_isect


def against_plain_render(scene, tables, kind, dev, isect=None,
                         plain_isect=None, crop=PLAIN_CROP):
    """1 spp of the `crop` window through the kernel against 1 spp of it
    through the kernel's plain version, on the same tables. `isect` /
    `plain_isect` replace the renderer's own traversal and kernel `kind`'s
    plain version (for the re-queue driver and its plain mode)."""
    if plain_isect is None:
        plain_isect = plain_traversal(kind)
    scene = dataclasses.replace(
        scene, film=dataclasses.replace(scene.film, crop=crop))
    renderer = Renderer(scene, device=dev, tables=tables, isect=isect)
    before = launch_counts()[kind]
    img_k = renderer.image(renderer.render(spp=1))
    if launch_counts()[kind] == before:
        fail(f"the cropped render did not go through {kind}")
    t0 = time.time()
    plain_renderer = Renderer(scene, device=dev, tables=tables, isect=plain_isect)
    img_p = plain_renderer.image(plain_renderer.render(spp=1))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    rel = float(np.abs(img_k.mean((0, 1)) - img_p.mean((0, 1))).max()
                / max(float(img_p.mean()), 1e-12))
    if not rel <= 1e-4:
        fail(f"{kind} render differs from its plain-version render: rel {rel}")
    if not float(img_p.mean()) > 0.0:
        fail(f"{kind}: the cropped plain-version render is black")
    return {"plain_render_s": round(seconds, 1), "plain_render_crop": crop,
            "plain_vs_kernel_mean_rel": rel,
            "plain_vs_kernel_max_pixel_abs": float(np.abs(img_k - img_p).max())}


def kd_params(ndirs):
    ps = ParamSet()
    if ndirs:
        ps.add("integer nbDirections", [ndirs])
    return ps


def with_accelerator(scene, accel, ndirs=None):
    """The flattened scene as if its file said `Accelerator "<accel>"`."""
    return dataclasses.replace(scene, accelerator_name=accel,
                               accelerator_params=kd_params(ndirs))


def mean_rel(img_a, img_b) -> float:
    """Largest channel difference of the two mean images over the mean."""
    return float(np.abs(img_a.mean((0, 1)) - img_b.mean((0, 1))).max()
                 / max(float(img_b.mean()), 1e-12))


def thesis_row(renderer, film, ms_per_spp, spp) -> dict:
    """The thesis's comparison of one accelerator on one scene: the tree and
    what a camera ray costs in it (all bounces and shadow rays of its path,
    from the film's AOVs)."""
    st, ds = renderer.st, renderer.ds
    aov = renderer.aovs(film)
    row = dict(renderer.accel_stats)
    if row["kind"] in ("bvh", "bvhold"):
        row.update(n_wide_nodes=st.n_wide_nodes, max_leaf=st.max_leaf)
        tables = (ds.wide_nodes, ds.prim_rows)
    else:
        tables = [getattr(ds, f) for f in ds._fields if f.startswith("alt_")]
    row.update(
        triangles=st.n_tris, spp=spp, ms_per_spp=ms_per_spp,
        table_bytes_on_device=sum(t.numel() * t.element_size() for t in tables),
        node_visits_per_camera_ray=float(aov["node_visits"].mean()),
        leaf_visits_per_camera_ray=float(aov["leaf_visits"].mean()),
        prim_tests_per_camera_ray=float(aov["prim_tests"].mean()),
        path_length=float(aov["path_length"].mean()))
    return row


def main(argv) -> int:
    quick = "--quick" in argv
    with_profile = "--profile" in argv
    variant_dir = (argv[argv.index("--variants") + 1]
                   if "--variants" in argv else None)
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA device")
    dev = torch.device("cuda:0")

    # ------------------------------ env ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    kernel_build_s, ptxas, fmad_libs, variants = build_kernels(variant_dir)
    var_libs = {k: {n: lib for n, (lib, _) in v.items()}
                for k, v in variants.items()}
    t0 = time.time()
    get_native_lib()
    native_build_s = time.time() - t0
    emit({"phase": "env", "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernel_build_s": round(kernel_build_s, 2),
          "native_build_s": round(native_build_s, 2),
          "nvcc_flags": NVCC_FLAGS,
          "ptxas_every_instance": ptxas,
          "variants": {k: {n: p for n, (_, p) in v.items()}
                       for k, v in variants.items()}})

    # ----------------------------- kernels ------------------------------
    def upload_text(txt, **kw):
        sc = flatten(parse_string(txt))
        return upload(sc, light_strategy="spatial", device=dev, **kw)

    def rays_to(o, d):
        return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))

    def museum_scene(tmp, **size):
        path = genscene.museum(tmp, **size)
        return flatten(parse_file(path), os.path.dirname(path))

    inf_rays = torch.full((N_CHECK_RAYS,), float("inf"), device=dev)
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        o, d = rays_to(*testscenes.aimed_rays(
            N_CHECK_RAYS, 19, [-3, -3, -3], [3, 3, 3], 7.0))
        wide_cases, treelet_cases = [], []
        ds, st = upload_text(testscenes.random_triangles_pbrt(60, 0))
        wide_cases.append(("random_triangles", ds, st, o, d, inf_rays))
        ds, st = upload_text(testscenes.quadric_kinds_pbrt())
        if st.n_spheres != 7:
            fail("quadric scene lost its quadrics")
        wide_cases.append(("quadric_kinds", ds, st, o, d, inf_rays))
        # every quadric kind among 300 triangles, cut into small treelets
        ds, st = upload_text(testscenes.quadric_kinds_pbrt(n_tris=300),
                             two_level=True, treelet_budget=(4, 128))
        if st.n_spheres != 7 or st.n_treelets < 8:
            fail(f"two-level quadric scene: {st.n_spheres} quadrics, "
                 f"{st.n_treelets} treelets")
        treelet_cases.append(("quadric_kinds_300", ds, st, o, d, inf_rays))

        # museum, 63,558 triangles (native sweep-SAH build): camera rays plus
        # cosine-scattered secondary rays from their hits; its own
        # single-level tables, and two-level tables at the default capacities
        sc65 = museum_scene(tmp, **MUSEUM_65K)
        sc65_small = with_resolution(sc65, 512, 256)
        t0 = time.time()
        bvh65 = build_scene_bvh(sc65)
        tables65 = upload(sc65, bvh=bvh65, light_strategy="spatial", device=dev)
        sah_65k_s = time.time() - t0
        if tables65[1].two_level:
            fail("the small museum should take single-level tables")
        o2, d2, tm2 = mixed_rays(sc65_small, *tables65, dev)
        wide_cases.append(("museum_65k", *tables65, o2, d2, tm2))
        ds, st = upload(sc65, bvh=bvh65, light_strategy="spatial", device=dev,
                        two_level=True)
        treelet_cases.append(("museum_65k", ds, st, o2, d2, tm2))

        # kd / RBSP / BSP trees over the two small scenes and a small museum
        # (camera + secondary rays, dead lanes among them)
        sc1k = museum_scene(tmp, **MUSEUM_1K)
        tables1k = upload(sc1k, light_strategy="spatial", device=dev)
        kd_scenes = [
            ("random_triangles", testscenes.random_triangles_pbrt(60, 0), None),
            ("quadric_kinds", testscenes.quadric_kinds_pbrt(), None),
            ("museum_1k", sc1k, tables1k)]
        kd_cases, kd_trees = [], {}
        t0 = time.time()
        for label, sc, tables in kd_scenes:
            if tables is None:
                sc = flatten(parse_string(sc))
                tables = upload(sc, light_strategy="spatial", device=dev)
                rays = (o, d, inf_rays)
            else:
                rays = mixed_rays(with_resolution(sc, 512, 256), *tables, dev)
            for accel, ndirs in KD_TREES:
                nodes, dirs, _, stats = kdbsp.build_alt_accel(
                    sc, accel, kd_params(ndirs))
                name = f"{accel}{ndirs or ''}/{label}"
                kd_cases.append((name, *with_alt_accel(*tables, nodes, dirs),
                                 *rays))
                kd_trees[name] = {k: stats[k] for k in (
                    "n_nodes", "n_leaves", "max_leaf", "tree_depth")}
        kd_small_builds_s = time.time() - t0
        kd_cases += [c for base in kd_cases
                     if base[0] in ("kdtree/museum_1k", "rbsp3/museum_1k")
                     for c in edge_cases(*base, seed=37)]

        # K1 also on the dead-heavy, all-dead, one-ray and 131,073-ray
        # batches, with quadrics and on the museum's mixed rays
        check_cases("traverse_wide", wide_cases + [
            c for base in wide_cases if base[0] in ("quadric_kinds",
                                                    "museum_65k")
            for c in edge_cases(*base, seed=43)], checks)
        # K1's motion instance: the motion museum (the small museum's
        # triangles moving over the shutter) at random shutter times, on
        # its single-level tables and on its two-level upload (a motion
        # scene goes through K1 over the rows the treelets are cut from),
        # and on the edge batches; then timed beside the static instance
        mdir = os.path.join(tmp, "motion")
        t0 = time.time()
        sc_motion = flatten(parse_file(testscenes.motion_museum(
            mdir, **MUSEUM_65K)), mdir)
        tables_m = upload(sc_motion, light_strategy="spatial", device=dev)
        motion_upload_s = time.time() - t0
        if (not tables_m[1].has_motion or not tables_m[1].cam_animated
                or tables_m[1].two_level):
            fail(f"the motion museum's tables are not what it asks for: "
                 f"{tables_m[1]}")
        rays_m = motion_rays(sc_motion, *tables_m, dev, 47)
        ds2l, st2l = upload(sc_motion, light_strategy="spatial", device=dev,
                            two_level=True)
        half_m = tuple(x[N_CHECK_RAYS // 2:].contiguous() for x in rays_m)
        motion_cases = [("motion_museum", *tables_m, *rays_m),
                        ("motion_museum_two_level", ds2l, st2l, *half_m)]
        check_motion_cases(motion_cases + motion_edge_cases(
            *motion_cases[0], seed=53), checks)
        del ds2l, st2l, motion_cases
        motion_shape = motion_shape_timing(tables_m, half_m, "motion_museum")
        del tables_m, rays_m, half_m
        # K6 on 262,144 lanes of the fog museum (its grid plume at full
        # size) and the edge batches; the scene and its tables go on to the
        # media phase
        fdir = os.path.join(tmp, "fog")
        t0 = time.time()
        fog_path = testscenes.fog_museum(fdir, grid_res=FOG_GRID_RES,
                                         **MUSEUM_65K)
        t_fog_write = time.time() - t0
        t0 = time.time()
        sc_fog = flatten(parse_file(fog_path), fdir)
        t_fog_flatten = time.time() - t0
        t0 = time.time()
        tables_fog = upload(sc_fog,
                            light_strategy=sc_fog.integrator.light_strategy,
                            device=dev)
        torch.cuda.synchronize()
        fog_host_s = {"write_scene": round(t_fog_write, 2),
                      "parse_flatten": round(t_fog_flatten, 2),
                      "bvh_upload": round(time.time() - t0, 2)}
        if (not tables_fog[1].any_grid_media
                or not tables_fog[1].has_med_interfaces
                or tables_fog[1].n_media != 3 or tables_fog[1].two_level):
            fail(f"the fog museum's tables are not what it asks for: "
                 f"{tables_fog[1]}")
        t0 = time.time()
        lanes_fog = fog_lanes(sc_fog, *tables_fog, dev, 61)
        check_k6(lanes_fog, checks, fmad_libs["media_tracking"])
        half_fog = (lanes_fog[0],) + tuple(
            x[N_CHECK_RAYS // 2:].contiguous() for x in lanes_fog[1:])
        k6_shape = {kind: k6_timing(kind, half_fog) for kind in mtk.FORWARD}
        check_k6_backward(lanes_fog, sc_fog, checks)
        k6_checks_s = time.time() - t0
        del lanes_fog, half_fog
        treelet_edges = [c for base in treelet_cases
                         for c in edge_cases(*base, seed=41)]
        check_cases("traverse_treelets", treelet_cases + treelet_edges,
                    checks)
        t0 = time.time()
        check_requeue(treelet_cases, checks)
        check_bin_rays(treelet_edges, checks)
        requeue_checks_s = time.time() - t0
        t0 = time.time()
        check_cases("traverse_kdbsp", kd_cases, checks)
        kd_checks_s = time.time() - t0
        check_stack_depths()
        for tag in ("traverse_wide/quadric_kinds/closest/stats",
                    "traverse_treelets/quadric_kinds_300/closest/stats",
                    "traverse_kdbsp/kdtree/quadric_kinds/closest/stats",
                    "traverse_kdbsp/bspcluster3/museum_1k/closest/stats",
                    "traverse_requeue/quadric_kinds_300/r16/closest",
                    "traverse_requeue/museum_65k/r2/closest",
                    "traverse_wide_motion/motion_museum/closest/stats",
                    "traverse_wide_motion/motion_museum_two_level/any/stats"):
            if checks[tag]["hits"] < 1000:
                fail(f"{tag}: hardly hit, the check is vacuous")
        emit({"phase": "kernels", "rays": N_CHECK_RAYS, "ulp_limit": ULP_LIMIT,
              "sah_build_upload_65k_s": round(sah_65k_s, 2),
              "kd_trees_checked": kd_trees,
              "kd_small_builds_s": round(kd_small_builds_s, 2),
              "kd_checks_s": round(kd_checks_s, 1),
              "requeue_checks_s": round(requeue_checks_s, 1),
              "motion_museum_write_flatten_upload_s": round(motion_upload_s, 2),
              "fog_museum_host_s": fog_host_s,
              "k6_checks_s": round(k6_checks_s, 1),
              "media_tracking_on_secondary_lanes": k6_shape,
              "traverse_wide_motion_at_main_shape": motion_shape,
              "launches_during_checks": launch_counts(),
              "checks": checks})
        if quick:
            emit({"quick": True, "seconds": round(time.time() - t_start, 1)})
            return 0

        # ---------------------------- main path -------------------------
        t0 = time.time()
        scene_path = genscene.museum(tmp, **MUSEUM_1M)
        t_gen = time.time() - t0
        t0 = time.time()
        desc = parse_file(scene_path)
        t_parse = time.time() - t0
        t0 = time.time()
        scene = flatten(desc, os.path.dirname(scene_path))
        t_flatten = time.time() - t0
    for sc in (scene, sc65):
        if (sc.film.xres, sc.film.yres) != (MAIN_RES, MAIN_RES):
            fail(f"museum film is {sc.film.xres}x{sc.film.yres}")

    # single-level tables -> traverse_wide
    r65 = Renderer(sc65, device=dev, tables=tables65, collect_stats=True)
    film65, ms65, counts65 = drive(r65, {"traverse_wide": 1}, SPP_65K)
    fin65, lum65 = check_image(r65, film65, "museum_65k")
    plain65 = against_plain_render(sc65, tables65, "traverse_wide", dev)
    thesis = [thesis_row(r65, film65, ms65, SPP_65K)]

    # the same museum with `Accelerator "kdtree"` and `"rbsp"` (3 directions)
    # -> traverse_kdbsp, through the normal entry point: Renderer uploads,
    # builds the tree with the native builders and picks K2
    img65 = r65.image(film65)
    alt = {}
    for accel, ndirs in (("kdtree", None), ("rbsp", 3)):
        name = f"{accel}{ndirs or ''}"
        sc_alt = with_accelerator(sc65, accel, ndirs)
        t0 = time.time()
        r_alt = Renderer(sc_alt, device=dev, collect_stats=True)
        torch.cuda.synchronize()
        setup_s = time.time() - t0
        if r_alt.accel_stats["kind"] != accel or r_alt.st.alt_tree_depth < 2:
            fail(f"the {name} render has no such tree: {r_alt.accel_stats}")
        film_alt, ms_alt, counts_alt = drive(r_alt, {"traverse_kdbsp": 1}, SPP_65K)
        fin_alt, lum_alt = check_image(r_alt, film_alt, f"museum_65k_{name}")
        rel_bvh = mean_rel(r_alt.image(film_alt), img65)
        if not rel_bvh <= KD_VS_BVH_MEAN_REL:
            fail(f"{name} render differs from the BVH render: rel {rel_bvh}")
        thesis.append(thesis_row(r_alt, film_alt, ms_alt, SPP_65K))
        alt[name] = {
            "renderer": r_alt, "scene": sc_alt, "launches": counts_alt,
            "line": {
                "triangles": r_alt.st.n_tris, "accelerator": name,
                "tree": r_alt.accel_stats,
                "upload_and_tree_build_s": round(setup_s, 2),
                "spp": SPP_65K, "batches": r_alt.n_batches,
                "ms_per_spp": ms_alt,
                "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_alt * 1e-3),
                "launches": counts_alt, "finite_pixel_share": fin_alt,
                "mean_luminance": lum_alt, "mean_rel_to_bvh_render": rel_bvh,
                "mean_rel_bound": KD_VS_BVH_MEAN_REL}}
        del film_alt
    rkd = alt["kdtree"]["renderer"]
    alt["kdtree"]["line"].update(against_plain_render(
        alt["kdtree"]["scene"], (rkd.ds, rkd.st), "traverse_kdbsp", dev))

    # K2 at the main path's shape: the secondary rays of the middle camera
    # batch of this museum through the kd-tree, with K1 on the same rays
    # beside it
    rays_kd = main_shape_rays(rkd, sc65, tables65, dev)
    shape_kd = {
        "rays": rkd.batch, "live_rays": int((rays_kd[2] > 0).sum()),
        "traverse_kdbsp": main_shape_timing(
            "traverse_kdbsp", (rkd.ds, rkd.st), rays_kd, fmad_libs,
            "museum_65k_kdtree", var_libs.get("traverse_kdbsp")),
        "traverse_wide": main_shape_timing(
            "traverse_wide", tables65, rays_kd, fmad_libs, "museum_65k",
            var_libs.get("traverse_wide"))}
    same = (shape_kd["traverse_kdbsp"].pop("prims"),
            shape_kd["traverse_wide"].pop("prims"))
    shape_kd["closest_prim_differs_between_kdtree_and_bvh"] = int(
        (same[0] != same[1]).sum())
    # and K2 on the same rays through the 3-direction RBSP tree, held against
    # the plain walker at this size too
    rr = alt["rbsp3"]["renderer"]
    shape_kd["traverse_kdbsp_through_rbsp3"] = main_shape_timing(
        "traverse_kdbsp", (rr.ds, rr.st), rays_kd, fmad_libs,
        "museum_65k_rbsp3", var_libs.get("traverse_kdbsp"))
    same_rbsp = shape_kd["traverse_kdbsp_through_rbsp3"].pop("prims")
    shape_kd["closest_prim_differs_between_rbsp3_and_bvh"] = int(
        (same_rbsp != same[1]).sum())
    check_stack_depths()
    lines_alt = {f"museum_65k_{k}": v["line"] for k, v in alt.items()}
    counts_kd = alt["kdtree"]["launches"]
    del alt, rr, rkd

    # two-level tables -> traverse_treelets
    t0 = time.time()
    bvh = build_scene_bvh(scene)
    t_bvh = time.time() - t0
    t0 = time.time()
    tables = upload(scene, bvh=bvh,
                    light_strategy=scene.integrator.light_strategy, device=dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    ds, st = tables
    if not st.two_level:
        fail("the 1,032,454-triangle museum should take two-level tables")
    table_bytes = sum(t.numel() * t.element_size() for t in ds)
    renderer = Renderer(scene, device=dev, tables=tables, collect_stats=True)
    film, ms_per_spp, counts = drive(renderer, {"traverse_treelets": 1}, SPP_1M)
    finite_share, mean_lum = check_image(renderer, film, "museum_1m")
    aov = renderer.aovs(film)
    plain1m = against_plain_render(scene, tables, "traverse_treelets", dev)

    # the same tables through the re-queue driver -> bin_rays + walk_pairs,
    # and traverse_treelets for the rays whose list overflowed
    img1m = renderer.image(film)
    r_rq = Renderer(scene, device=dev, tables=tables,
                    isect=tr.intersect_requeue, collect_stats=True)
    film_rq, ms_rq, counts_rq = drive(r_rq, REQUEUE_PER_CALL, SPP_1M)
    fin_rq, lum_rq = check_image(r_rq, film_rq, "museum_1m_requeue")
    rel_rq = mean_rel(r_rq.image(film_rq), img1m)
    if not rel_rq <= REQUEUE_VS_K3_MEAN_REL:
        fail(f"re-queue render differs from the K3 render: rel {rel_rq}")
    aov_rq = r_rq.aovs(film_rq)
    calls_rq = 2 * (scene.integrator.max_depth + 1) * r_rq.n_batches * SPP_1M
    requeue_line = {
        "isect": "ops.traverse_requeue.intersect_requeue", "spp": SPP_1M,
        "traversal_calls": calls_rq, "ms_per_spp": ms_rq,
        "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_rq * 1e-3),
        "launches": counts_rq,
        "launches_per_spp": {k: v // SPP_1M for k, v in counts_rq.items()},
        "finite_pixel_share": fin_rq, "mean_luminance": lum_rq,
        "mean_rel_to_traverse_treelets_render": rel_rq,
        "mean_rel_bound": REQUEUE_VS_K3_MEAN_REL,
        "max_pixel_abs_to_traverse_treelets_render": float(
            np.abs(r_rq.image(film_rq) - img1m).max()),
        "mean_node_visits": float(aov_rq["node_visits"].mean()),
        "mean_prim_tests": float(aov_rq["prim_tests"].mean()),
        **against_plain_render(
            scene, tables, "bin_rays", dev, isect=tr.intersect_requeue,
            plain_isect=functools.partial(tr._requeue, trav.bin_rays,
                                          trav.walk_pairs,
                                          trav.intersect_two_level))}
    del film_rq, r_rq
    main_launches = {"traverse_wide": counts65["traverse_wide"],
                     "traverse_treelets": counts["traverse_treelets"],
                     "traverse_kdbsp": counts_kd["traverse_kdbsp"],
                     "bin_rays": counts_rq["bin_rays"],
                     "walk_pairs": counts_rq["walk_pairs"]}

    # ---- each kernel at the main path's shape: one 131,072-ray batch of the
    # 1M museum, the same rays for both (single-level tables built for it)
    t0 = time.time()
    tables_1l = upload(scene, bvh=bvh,
                       light_strategy=scene.integrator.light_strategy,
                       device=dev, two_level=False)
    t_upload_1l = time.time() - t0
    rays = main_shape_rays(renderer, scene, tables_1l, dev)
    shape = {"rays": renderer.batch, "live_rays": int((rays[2] > 0).sum()),
             "traverse_wide": main_shape_timing(
                 "traverse_wide", tables_1l, rays, fmad_libs, "museum_1m",
                 var_libs.get("traverse_wide")),
             "traverse_treelets": main_shape_timing(
                 "traverse_treelets", tables, rays, fmad_libs, "museum_1m",
                 var_libs.get("traverse_treelets"))}
    same = (shape["traverse_wide"].pop("prims"), shape["traverse_treelets"].pop("prims"))
    shape["closest_prim_differs_between_levels"] = int((same[0] != same[1]).sum())
    # the single-level kernel on the very tree the treelets were cut from
    # (the two-level upload keeps it): what the second level itself costs
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    cut = torch.where(rays[2] > 0, half, 0.0).contiguous()
    shape["traverse_wide_on_the_treelets_tree_ms"] = {
        "closest": time_ms(lambda: tw.intersect_wide_cuda(
            ds, st, rays[0], rays[1], rays[2]), 10),
        "any": time_ms(lambda: tw.intersect_wide_cuda(
            ds, st, rays[0], rays[1], cut, any_hit=True), 10)}
    # K4 + K5 and the whole re-queue driver on the same rays, over the
    # two-level tables; the driver against K3's hits on them
    k3_hits = {"closest": tt.intersect_treelets_cuda(ds, st, *rays),
               "any": tt.intersect_treelets_cuda(ds, st, rays[0], rays[1], cut,
                                                 any_hit=True)}
    shape["traverse_requeue"] = requeue_shape_timing(
        tables, rays, fmad_libs["traverse_requeue"], "museum_1m", k3_hits,
        var_libs)
    del k3_hits
    check_stack_depths()
    if with_profile:
        emit({"phase": "profile",
              **profile_one_spp(lambda: renderer.render(spp=1))})
    emit({"phase": "main_path",
          "museum_65k": {
              "triangles": tables65[1].n_tris, "two_level": False,
              "wide_nodes": tables65[1].n_wide_nodes, "spp": SPP_65K,
              "ms_per_spp": ms65,
              "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms65 * 1e-3),
              "launches": counts65, "finite_pixel_share": fin65,
              "mean_luminance": lum65, **plain65},
          **lines_alt,
          "thesis_table": thesis,
          "museum_1m": {
              **MUSEUM_1M, "triangles": st.n_tris, "two_level": True,
              "wide_nodes": st.n_wide_nodes, "top_nodes": int(ds.top_nodes.shape[0]),
              "treelets": st.n_treelets, "treelet_capacity": [st.tl_tn, st.tl_tp],
              "bvh_nodes": st.n_nodes, "max_leaf": st.max_leaf,
              "table_bytes_on_device": table_bytes,
              "host_s": {"generate": round(t_gen, 2), "parse": round(t_parse, 2),
                         "flatten": round(t_flatten, 2), "bvh_lbvh": round(t_bvh, 2),
                         "collapse_treelets_pack_upload": round(t_upload, 2),
                         "single_level_tables_for_comparison": round(t_upload_1l, 2)},
              "resolution": [MAIN_RES, MAIN_RES],
              "max_depth": scene.integrator.max_depth,
              "spp": SPP_1M, "batches": renderer.n_batches,
              "batch_rays": renderer.batch, "ms_per_spp": ms_per_spp,
              "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_per_spp * 1e-3),
              "launches": counts, "finite_pixel_share": finite_share,
              "mean_luminance": mean_lum,
              "mean_node_visits": float(aov["node_visits"].mean()),
              "mean_prim_tests": float(aov["prim_tests"].mean()),
              "mean_path_length": float(aov["path_length"].mean()), **plain1m},
          "museum_1m_requeue": requeue_line,
          "kernels_at_main_shape": shape,
          "kernels_at_main_shape_museum_65k": shape_kd})

    # ---- gradients: value_and_grad through K1 (small museum) and K3 (1M
    # museum), each against its plain version on the crop; two training
    # steps on the small museum
    grads65 = fwd_bwd(sc65, tables65, "traverse_wide", SPP_GRAD_65K, dev)
    grads1m = fwd_bwd(scene, tables, "traverse_treelets", SPP_GRAD_1M, dev,
                      with_profile)
    emit({"phase": "gradients", "params": GRAD_PARAMS,
          "loss": "sum(film.rgb)", "museum_65k": grads65,
          "museum_1m": grads1m,
          "train": train_steps(*at_resolution_scene(sc65, tables65, TRAIN_RES),
                               dev)})

    # ---- appearance: the textured, environment-lit museum through K1
    look = appearance(dev, with_profile, (sc65, tables65))
    emit({"phase": "appearance", **look})

    # ---- materials: pbrt-v3's other materials and the new samplers
    mats = materials(dev, with_profile, (sc65, tables65))
    emit({"phase": "materials", **mats})

    # ---- motion: the moving museum through K1's motion instance, the
    # realistic camera, the sweep
    mot = motion(dev, (sc65, tables65))
    emit({"phase": "motion", **mot})

    # ---- media: spectral transport and the fog museum through K1 and K6
    med = media(dev, (sc65, tables65), (sc_fog, tables_fog, fog_host_s),
                with_profile)
    emit({"phase": "media", **med})

    # ---- integrators: direct lighting, Whitted, AO, BDPT, MLT and SPPM on
    # the small museum through K1
    integ = integrators(dev, (sc65, tables65))
    emit({"phase": "integrators", **integ})

    # ---- mesh: parallel/mesh.py on this card, two ranks over gloo and one
    # over NCCL; bsdftest on the card
    msh = mesh(dev, (sc65, tables65), film65)
    emit({"phase": "mesh", **msh})

    kernels = []
    # K1 at the shape where the main path launches it: the 63,558-triangle
    # museum's secondary rays (its 1M-museum figures beside them)
    shapes = {"traverse_wide": shape_kd, "traverse_treelets": shape,
              "traverse_kdbsp": shape_kd}
    for kind, spec in KERNELS.items():
        sh = shapes[kind][kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": f"tpupt_torch/csrc/{kind}.cu",
            "replaces": spec["replaces"],
            "launches": main_launches[kind],
            "max_abs_err": max(
                [c["max_abs_err"] for tag, c in checks.items()
                 if tag.startswith(kind + "/") and isinstance(c, dict)]
                + [sh["closest"]["max_abs_err"], sh["any"]["max_abs_err"]]
                + ([shape_kd["traverse_kdbsp_through_rbsp3"][m]["max_abs_err"]
                    for m in ("closest", "any")]
                   if kind == "traverse_kdbsp" else [])),
            "ms": sh["closest"]["kernel_ms"],
            "plain_ms": sh["closest"]["plain_ms"],
            "bound_ms": sh["closest"]["bound_ms"],
            "bound_by": sh["closest"]["bound_by"],
            "library_ms": None,
            "any_hit_ms": sh["any"]["kernel_ms"],
            "any_hit_bound_ms": sh["any"]["bound_ms"],
            "kernel_alone_ms": sh["closest"]["kernel_alone_ms"],
            "any_hit_kernel_alone_ms": sh["any"]["kernel_alone_ms"],
            "rays_per_launch": shapes[kind]["rays"],
            "tolerance": f"valid/prim/counters exact, t/b1/b2 <= {ULP_LIMIT} ulp",
        })
        for g in (grads65, grads1m):
            if g["kernel"] == kind:
                kernels[-1]["fwd_bwd_launches"] = g["launches"][kind]
        kernels[-1]["appearance_launches"] = look["launches"][kind]
        kernels[-1]["appearance_fwd_bwd_launches"] = (
            look["gradients"]["launches"][kind])
        kernels[-1]["materials_launches"] = mats["launches"][kind]
        kernels[-1]["materials_fwd_bwd_launches"] = (
            mats["gradients"]["launches"][kind])
        if kind == "traverse_wide":
            sm, fm = med["spectral_museum"], med["fog_museum"]
            kernels[-1]["media_launches"] = {
                "spectral_museum": sm["launches"][kind],
                "fog_museum": fm["launches"][kind]}
            kernels[-1]["media_fwd_bwd_launches"] = {
                "spectral_museum": sm["gradients"]["launches"][kind],
                "fog_museum": fm["gradients"]["launches"][kind]}
            kernels[-1]["integrators_launches"] = {
                k: v["launches"][kind] for k, v in integ.items()
                if isinstance(v, dict) and "launches" in v}
            ms_ = motion_shape
            kernels[-1]["motion_launches"] = mot["launches"][
                "traverse_wide_motion"]
            kernels[-1]["motion_fwd_bwd_launches"] = mot["gradients"][
                "launches"]["traverse_wide_motion"]
            kernels[-1]["motion_instance"] = {
                "replaces": "tpupt/integrators/path.py:330 (the JAX "
                            "package's XLA wide walker for motion scenes, "
                            "tpupt/accel/traverse.py:314)",
                "launches": mot["launches"]["traverse_wide_motion"],
                "ms": ms_["closest"]["kernel_ms"],
                "kernel_alone_ms": ms_["closest"]["kernel_alone_ms"],
                "any_hit_ms": ms_["any"]["kernel_ms"],
                "any_hit_kernel_alone_ms": ms_["any"]["kernel_alone_ms"],
                "static_instance_alone_ms":
                    ms_["closest"]["static_instance_alone_ms"],
                "any_hit_static_instance_alone_ms":
                    ms_["any"]["static_instance_alone_ms"],
                "plain_ms": ms_["closest"]["plain_ms"],
                "bound_ms": ms_["closest"]["bound_ms"],
                "bound_by": ms_["closest"]["bound_by"],
                "any_hit_bound_ms": ms_["any"]["bound_ms"],
                "max_abs_err": max(
                    [c["max_abs_err"] for tag, c in checks.items()
                     if tag.startswith("traverse_wide_motion/")
                     and isinstance(c, dict)]
                    + [ms_["closest"]["max_abs_err"],
                       ms_["any"]["max_abs_err"]]),
                "rays_per_launch": ms_["rays"]}
            w1m = shape["traverse_wide"]
            kernels[-1]["at_museum_1m"] = {
                "ms": w1m["closest"]["kernel_ms"],
                "any_hit_ms": w1m["any"]["kernel_ms"],
                "kernel_alone_ms": w1m["closest"]["kernel_alone_ms"],
                "any_hit_kernel_alone_ms": w1m["any"]["kernel_alone_ms"],
                "bound_ms": w1m["closest"]["bound_ms"],
                "any_hit_bound_ms": w1m["any"]["bound_ms"],
                "plain_ms": w1m["closest"]["plain_ms"],
                "main_path_launches": counts["traverse_wide"],
                "rays_per_launch": shape["rays"]}
        if kind == "traverse_treelets":
            for mode in ("closest", "any"):
                fb = shape["traverse_requeue"][mode]["traverse_treelets_fallback"]
                kernels[-1][f"fallback_{mode}"] = {
                    "ms": fb["kernel_ms"],
                    "kernel_alone_ms": fb["kernel_alone_ms"],
                    "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
                    "live_rays": fb["live_rays"]}
    rq = shape["traverse_requeue"]
    for kind, replaces in REQUEUE_KERNELS.items():
        sh = rq["closest"][kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": "tpupt_torch/csrc/traverse_requeue.cu",
            "replaces": replaces, "launches": main_launches[kind],
            "max_abs_err": max(
                [c["max_abs_err"].get(kind, 0.0) for tag, c in checks.items()
                 if tag.startswith("traverse_requeue/")]
                + [sh["max_abs_err"], rq["any"][kind]["max_abs_err"]]),
            "ms": sh["kernel_ms"], "plain_ms": sh["plain_ms"],
            "bound_ms": sh["bound_ms"], "bound_by": sh["bound_by"],
            "library_ms": None,
            "any_hit_ms": rq["any"][kind]["kernel_ms"],
            "any_hit_bound_ms": rq["any"][kind]["bound_ms"],
            "kernel_alone_ms": sh["kernel_alone_ms"],
            "any_hit_kernel_alone_ms": rq["any"][kind]["kernel_alone_ms"],
            **({"dead_pair_bytes": sh["dead_pair_bytes"]
                + rq["any"][kind]["dead_pair_bytes"]}
               if kind == "walk_pairs" else {}),
            "rays_per_launch": shape["rays"],
            "appearance_launches": look["launches"][kind],
            "appearance_fwd_bwd_launches": look["gradients"]["launches"][kind],
            "materials_launches": mats["launches"][kind],
            "materials_fwd_bwd_launches": mats["gradients"]["launches"][kind],
            "per": ("one launch" if kind == "bin_rays"
                    else "one driver call: pass 0 + pass 1, two launches"),
            "tolerance": "every output equal to the bit"})
    fm = med["fog_museum"]
    for kind in mtk.FORWARD:
        at = fm["k6_at_main_shape"][kind]
        mean = at["mean_per_call"]
        sec = k6_shape[kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": "tpupt_torch/csrc/media_tracking.cu",
            "replaces": K6_REPLACES[kind], "launches": fm["launches"][kind],
            "max_abs_err": max(
                [c["max_abs_err"] for tag, c in checks.items()
                 if tag.startswith(kind + "/") and "fmad" not in tag]
                + [at["max_abs_err"]]),
            "ms": mean["kernel_alone_ms"], "plain_ms": mean["plain_ms"],
            "bound_ms": mean["bound_ms"],
            "bound_by": at["bound_by_calls"].most_common(1)[0][0],
            "library_ms": None,
            "per": "mean over the calls of the fog museum's middle batch "
                   "of sample 0 (ms: the kernel alone)",
            "call_ms": mean["kernel_ms"], "calls_timed": at["calls"],
            "lanes_per_launch": at["lanes"], "live_lanes": mean["live"],
            "fwd_bwd_launches": fm["gradients"]["launches"][kind],
            "on_all_live_secondary_lanes": {
                k: sec[k] for k in ("kernel_ms", "kernel_alone_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "live_lanes")},
            "tolerance": f"interacted equal on every lane, t / transmittance "
                         f"<= {K6_ULP_LIMIT} ulp"})
    at = fm["k6_at_main_shape"]["tr_grid_backward"]
    mean = at["mean_per_call"]
    kernels.append({
        "name": "tr_grid_backward", "route": "cuda",
        "source": "tpupt_torch/csrc/media_tracking.cu",
        "replaces": K6_REPLACES["tr_grid_backward"],
        "launches": fm["gradients"]["launches"]["tr_grid_backward"],
        "max_abs_err": max(
            [c["max_abs_err"] for tag, c in checks.items()
             if tag.startswith("tr_grid_backward/")] + [at["max_abs_err"]]),
        "ms": mean["kernel_alone_ms"], "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": at["bound_by_calls"].most_common(1)[0][0],
        "library_ms": None,
        "per": "mean over the tr_grid calls of the fog museum's middle batch "
               "of sample 0, a seeded cotangent each (ms: the kernel alone; "
               "launches: the fog museum's fwd+bwd sample)",
        "call_ms": mean["kernel_ms"], "calls_timed": at["calls"],
        "lanes_per_launch": at["lanes"], "live_lanes": mean["live"],
        "atlas_max_rel_err": max(
            [c["atlas_rel_err"] for tag, c in checks.items()
             if tag.startswith("tr_grid_backward/")]
            + [at["atlas_rel_err"]]),
        "crop_launches": fm["gradients"]["crop_launches"][
            "tr_grid_backward"],
        "tolerance": f"per-lane outputs equal to the bit; the atlas (atomics "
                     f"in no fixed order) within {K6_ATLAS_REL} of its "
                     f"largest"})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(card_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


def appearance(dev, with_profile, untextured) -> dict:
    """The appearance phase: tools/testscenes.py `textured_museum` at
    MUSEUM_65K's size through the entry points (parse_file -> flatten ->
    upload -> Renderer), rendered at MAIN_RES, SPP_APPEAR samples, through
    K1 with the launch counts set to 0 just before and read just after, held
    against the plain-version render on PLAIN_CROP; `value_and_grad` of
    `bench_loss` with respect to APPEAR_PARAMS over SPP_APPEAR samples (the
    emitters' linearity, finite gradients, K1's launches); two training
    steps toward the image with env_map halved. `with_profile` adds one
    textured sample's device launches and busy share beside one sample of
    `untextured` = (scene, tables), the plain museum, and beside one
    textured sample that computes every texture type (the port computes
    only the types the scene's materials name, `SceneStatics.tex_types`)."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = testscenes.textured_museum(tmp, **APPEAR_MAPS, **MUSEUM_65K)
        t_gen = time.time() - t0
        t0 = time.time()
        scene = flatten(parse_file(path), tmp)
        t_flatten = time.time() - t0
    t0 = time.time()
    tables = upload(scene, light_strategy=scene.integrator.light_strategy,
                    device=dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    ds, st = tables
    want_w, want_h = APPEAR_MAPS["env_res"]
    if (st.two_level or not st.has_textures or not st.has_light_imgs
            or (st.env_w, st.env_h) != (want_w, want_h)):
        fail(f"the textured museum's tables are not what it asks for: {st}")
    r = Renderer(scene, device=dev, tables=tables)
    film, ms, counts = drive(r, {"traverse_wide": 1}, SPP_APPEAR)
    fin, lum = check_image(r, film, "textured_museum")
    img = r.image(film)
    del film
    plain = against_plain_render(scene, tables, "traverse_wide", dev)

    # value_and_grad with respect to the appearance tables
    grad_line = emitter_grads(grad_renderer(scene, tables, dev),
                              {k: getattr(ds, k) for k in APPEAR_PARAMS},
                              SPP_APPEAR, ("light_L", "env_map"),
                              LINEARITY_RTOL, "appearance")

    # TRAIN_STEPS training steps toward the image with env_map halved, at
    # TRAIN_RES
    sc_t, (ds_t, st_t) = at_resolution_scene(scene, tables, TRAIN_RES)
    target_r = Renderer(sc_t, device=dev, tables=(
        ds_t._replace(env_map=ds_t.env_map * 0.5), st_t))
    target = target_r.image(target_r.render(spp=1))
    del target_r
    step, params0 = train_step_fn(sc_t, None, target, device=dev,
                                  tables=(ds_t, st_t))
    tparams = {k: params0[k] for k in APPEAR_PARAMS}
    losses, t_ms = [], []
    torch.cuda.synchronize()
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        loss, tparams = step(tparams, 0, APPEAR_TRAIN_LR)
        losses.append(float(loss))
        t_ms.append((time.time() - t0) * 1e3)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"appearance training did not lower the loss: {losses}")
    profiled = {}
    if with_profile:
        r_plain = Renderer(untextured[0], device=dev, tables=untextured[1])
        r_all = Renderer(scene, device=dev, tables=(ds, st._replace(
            tex_types=(ALL_TYPES, ALL_TYPES))))
        profiled = {"profile_textured_spp": profile_one_spp(
                        lambda: r.render(spp=1)),
                    "profile_untextured_spp": profile_one_spp(
                        lambda: r_plain.render(spp=1)),
                    "profile_textured_every_type_spp": profile_one_spp(
                        lambda: r_all.render(spp=1))}
    return {
        "scene": "tools/testscenes.py textured_museum", **MUSEUM_65K,
        **APPEAR_MAPS, "triangles": st.n_tris, "two_level": st.two_level,
        "tex_types": [sorted(t) for t in st.tex_types],
        "texture_rows": int(ds.tex_type.shape[0]),
        "atlas_texels": int(ds.tex_atlas.shape[0]),
        "lights": int(st.n_lights), "env_light_id": st.env_light_id,
        "host_s": {"generate_and_write_maps": round(t_gen, 2),
                   "parse_flatten_load_maps": round(t_flatten, 2),
                   "bvh_upload_distribution2d": round(t_upload, 2)},
        "resolution": [MAIN_RES, MAIN_RES],
        "max_depth": scene.integrator.max_depth, "spp": SPP_APPEAR,
        "batches": r.n_batches, "ms_per_spp": ms,
        "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms * 1e-3),
        "launches": counts, "finite_pixel_share": fin, "mean_luminance": lum,
        "image_mean_rgb": [float(x) for x in img.reshape(-1, 3).mean(0)],
        **plain, "gradients": grad_line,
        "train": {"params": APPEAR_PARAMS, "lr": APPEAR_TRAIN_LR,
                  "target": "env_map * 0.5", "resolution": [TRAIN_RES] * 2,
                  "loss_each_step": losses,
                  "ms_each_step": t_ms},
        **profiled}


def emitter_grads(r, params, spp, emitters, rtol, tag,
                  calls_per_vertex: int = 2,
                  kind: str = "traverse_wide", per_batch: dict = None) -> dict:
    """`value_and_grad` of `bench_loss` with respect to `params` over `spp`
    samples (one call a sample) with the launch counts set to 0 just before
    and read just after. Fails unless every gradient is finite and nonzero,
    sum over the `emitters` tables of table * gradient equals the loss to
    `rtol` (the film is linear in them jointly), and `kind` (K1's static
    or motion instance) launched `calls_per_vertex` times a vertex of every
    batch and nothing else did; `per_batch` (kernel -> launches a batch of a
    sample) replaces that expectation where the loop is not path_li's."""
    torch.cuda.reset_peak_memory_stats()
    bytes_before = torch.cuda.memory_allocated()
    zero_launches()
    step_ms, values, linearity = [], [], []
    for s in range(spp):
        t0 = time.time()
        value, grads, _ = r.value_and_grad(bench_loss, params, s)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        v = float(value)
        for k, g in grads.items():
            if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
                fail(f"{tag} gradients: d loss / d {k} is not finite or 0")
        lin = float(sum((grads[k] * params[k]).sum() for k in emitters))
        if not abs(lin - v) <= rtol * abs(v):
            fail(f"{tag} gradients: sum of {emitters} * g = {lin}, loss {v}")
        values.append(v)
        linearity.append(lin)
    counts = launch_counts()
    if per_batch is None:
        per_batch = {kind: calls_per_vertex
                     * (r.scene.integrator.max_depth + 1)}
    for k, c in counts.items():
        if c != per_batch.get(k, 0) * r.n_batches * spp:
            fail(f"{tag} value_and_grad launched {k} {c} times")
    ms = sum(step_ms) / spp
    return {
        "params": tuple(params), "spp": spp,
        "fwd_bwd_ms_per_spp": ms, "fwd_bwd_ms_each_spp": step_ms,
        "resolution": [r.cfg.xres, r.cfg.yres],
        "fwd_bwd_camera_rays_per_s": r.cfg.xres * r.cfg.yres / (ms * 1e-3),
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_bytes_before": bytes_before, "launches": counts,
        "loss": values, "emitters": emitters,
        "emitters_times_grad": linearity, "linearity_rtol": rtol,
        "grad_abs_max": {k: float(g.abs().max()) for k, g in grads.items()}}


def materials(dev, with_profile, untextured) -> dict:
    """The materials phase: tools/testscenes.py `materials_museum` at
    MUSEUM_65K's size through the entry points (parse_file -> flatten ->
    upload -> Renderer), SPP_MATERIALS samples at MAIN_RES through K1 with
    the launch counts set to 0 just before and read just after (four
    traversal calls a vertex: the subsurface probe and exit shadow ray go
    through K1 too), beside `untextured` = (scene, tables), the plain
    museum, rendered by the same settings in this run; held against the
    plain-version render on PLAIN_CROP; `value_and_grad` of `bench_loss`
    with respect to GRAD_PARAMS over SPP_MATERIALS samples (finite
    gradients, linearity in light_L, K1's launches); the new samplers on
    the card against the CPU. `with_profile` adds one sample's device
    launches and busy share beside one of the plain museum."""
    from tpupt_torch.materials import bssrdf_table, fourier
    from tpupt_torch.samplers.samplers import WavefrontSampler

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = testscenes.materials_museum(tmp, n_hairs=MATERIALS_HAIRS,
                                           **MUSEUM_65K)
        t_gen = time.time() - t0
        bssrdf_table.compute_beam_diffusion_table.cache_clear()
        t0 = time.time()
        scene = flatten(parse_file(path), tmp)
        t_flatten = time.time() - t0
        t0 = time.time()
        fourier.read_bsdf_file(os.path.join(tmp, "statue.bsdf"))
        t_fourier = time.time() - t0
    # the beam-diffusion tables flatten built (one per subsurface eta),
    # built again alone to time them
    m = scene.materials
    etas = sorted({float(e) for e, t in zip(m.eta[:, 0], m.type)
                   if t in (MAT_SUBSURFACE, MAT_KDSUBSURFACE)})
    bssrdf_table.compute_beam_diffusion_table.cache_clear()
    t0 = time.time()
    for eta in etas:
        bssrdf_table.compute_beam_diffusion_table(eta)
    t_tables = time.time() - t0
    t0 = time.time()
    tables = upload(scene, light_strategy=scene.integrator.light_strategy,
                    device=dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    ds, st = tables
    want = {"disney", "hair", "mix", "sss", "fourier"}
    if (st.two_level or st.mat_features != want or not st.has_bssrdf_table
            or st.fourier is None or scene.sampler.name != "sobol"):
        fail(f"the materials museum's tables are not what it asks for: {st}")
    r = Renderer(scene, device=dev, tables=tables)
    film, ms, counts = drive(r, {"traverse_wide": 1}, SPP_MATERIALS,
                             calls_per_vertex=4)
    fin, lum = check_image(r, film, "materials_museum")
    img = r.image(film)
    del film
    r_plain = Renderer(untextured[0], device=dev, tables=untextured[1])
    _, ms_plain, _ = drive(r_plain, {"traverse_wide": 1}, 1)
    plain = against_plain_render(scene, tables, "traverse_wide", dev)

    # value_and_grad with respect to the bench's tables
    grad_line = emitter_grads(grad_renderer(scene, tables, dev),
                              {k: getattr(ds, k) for k in GRAD_PARAMS},
                              SPP_MATERIALS, ("light_L",),
                              MATERIALS_LINEARITY_RTOL, "materials",
                              calls_per_vertex=4)

    # the new samplers: every value on the grid, card against CPU
    res, n_s, n_d = SAMPLER_GRID
    px, py, si = torch.meshgrid(torch.arange(res), torch.arange(res),
                                torch.arange(n_s), indexing="ij")
    lanes = [x.reshape(-1).to(torch.int32) for x in (px, py, si)]
    t0 = time.time()
    sampler_values = 0
    for name in NEW_SAMPLERS:
        for spp in (16, 5):
            sm = WavefrontSampler(name, res, res, spp, seed=3)
            on_card = [x.to(dev) for x in lanes]
            outs = [(sm.dim(*on_card, d), sm.dim(*lanes, d))
                    for d in range(n_d)]
            outs += list(zip(sm.camera_jitter(*on_card),
                             sm.camera_jitter(*lanes)))
            for k, (a, b) in enumerate(outs):
                a = a.cpu().contiguous()
                if not torch.equal(a.view(torch.int32),
                                   b.contiguous().view(torch.int32)):
                    fail(f"sampler {name} (spp {spp}): output {k} on the card "
                         "differs from the CPU's")
                sampler_values += a.numel()
    t_samplers = time.time() - t0
    profiled = {}
    if with_profile:
        profiled = {"profile_materials_spp": profile_one_spp(
                        lambda: r.render(spp=1)),
                    "profile_untextured_spp": profile_one_spp(
                        lambda: r_plain.render(spp=1))}
    return {
        "scene": "tools/testscenes.py materials_museum", **MUSEUM_65K,
        "hairs": MATERIALS_HAIRS, "triangles": st.n_tris,
        "two_level": st.two_level, "mat_features": sorted(st.mat_features),
        "mix_features": sorted(st.mix_features),
        "material_rows": int(ds.mat_type.shape[0]),
        "fourier": st.fourier, "sampler": scene.sampler.name,
        "host_s": {"write_scene_ply_and_bsdf": round(t_gen, 2),
                   "parse_flatten_with_tables_and_bsdf": round(t_flatten, 2),
                   "beam_diffusion_tables_alone": round(t_tables, 2),
                   "subsurface_etas": etas,
                   "fourier_load_alone": round(t_fourier, 4),
                   "bvh_upload_sss_pack": round(t_upload, 2)},
        "resolution": [MAIN_RES, MAIN_RES],
        "max_depth": scene.integrator.max_depth, "spp": SPP_MATERIALS,
        "batches": r.n_batches, "ms_per_spp": ms,
        "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms * 1e-3),
        "untextured_museum_ms_per_spp": ms_plain,
        "untextured_museum_camera_rays_per_s":
            MAIN_RES * MAIN_RES / (ms_plain * 1e-3),
        "launches": counts,
        "launches_per_spp": {"expected_closest_and_nee_shadow":
                             2 * (scene.integrator.max_depth + 1) * r.n_batches,
                             "expected_subsurface_probe_and_shadow":
                             2 * (scene.integrator.max_depth + 1) * r.n_batches,
                             "traverse_wide":
                             counts["traverse_wide"] // SPP_MATERIALS},
        "finite_pixel_share": fin, "mean_luminance": lum,
        "image_mean_rgb": [float(x) for x in img.reshape(-1, 3).mean(0)],
        **plain, "gradients": grad_line,
        "samplers": {"names": NEW_SAMPLERS, "grid": SAMPLER_GRID,
                     "values_compared_bit_for_bit": sampler_values,
                     "seconds": round(t_samplers, 2)},
        **profiled}


def motion_rays(scene, ds, st, dev, seed):
    """2 x 131,072 rays of a motion scene at random shutter times: camera
    rays of its animated camera through random film positions, and the
    secondary rays scattered from their hits (found by K1's motion instance)
    at the same times. Returns (o, d, tmax, time), dead lanes at tmax 0."""
    n = N_CHECK_RAYS // 2
    gen = np.random.default_rng(seed)
    p_raster = torch.from_numpy(
        (gen.random((n, 2)) * MAIN_RES).astype(np.float32)).to(dev)
    tm = torch.from_numpy(gen.random(n, dtype=np.float32)).to(dev)
    cam = scene.camera
    o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                         p_raster, torch.zeros_like(p_raster),
                         cam.lens_radius, cam.focal_distance,
                         cam_q=ds.cam_q, cam_tr=ds.cam_tr, time=tm)
    o, d = o.contiguous(), d.contiguous()
    tmax = torch.full((n,), float("inf"), device=dev)
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, tmax, time=tm)
    o2, d2, tmax2 = secondary_rays(ds, st, hit, o, d, seed + 1)
    return (torch.cat([o, o2]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tmax, tmax2]).contiguous(),
            torch.cat([tm, tm]).contiguous())


def motion_edge_cases(name, ds, st, o, d, tmax, tm, seed):
    """`edge_cases` of a motion batch, each with its rays' times."""
    out = []
    for case in edge_cases(name, ds, st, o, d, tmax, seed):
        n = case[3].shape[0]
        if n == 1:
            i = int(torch.nonzero(tmax > 0)[0])
            t_ = tm[i:i + 1]
        else:
            t_ = tm[:n]
        out.append((*case, t_.contiguous()))
    return out


def check_motion_cases(cases, checks):
    """K1's motion instance against the plain walker at the rays' times on
    each case (name, ds, st, o, d, tmax, time), closest and any hit, with
    and without counters; fails the run on any miss, or if a call did not
    launch the motion instance alone."""
    for name, ds, st, o, d, tmax, tm in cases:
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            t0 = time.time()
            plain = trav.intersect_wide(ds, st, o, d, tmax, any_hit=any_hit,
                                        time=tm)
            torch.cuda.synchronize()
            checks[f"traverse_wide_motion/{name}/{mode}/plain_ms"] = (
                time.time() - t0) * 1e3
            for with_stats in (True, False):
                tag = (f"traverse_wide_motion/{name}/{mode}/"
                       f"{'stats' if with_stats else 'nostats'}")
                before = (tw.launches, tw.launches_motion)
                out = tw.intersect_wide_cuda(ds, st, o, d, tmax,
                                             any_hit=any_hit,
                                             with_stats=with_stats, time=tm)
                torch.cuda.synchronize()
                if (tw.launches, tw.launches_motion) != (before[0],
                                                         before[1] + 1):
                    fail(f"{tag}: the call did not launch the motion "
                         "instance alone")
                res = compare_hits(tag, out, plain, with_stats)
                res["kernel_ms"] = time_ms(
                    lambda: tw.intersect_wide_cuda(
                        ds, st, o, d, tmax, any_hit=any_hit,
                        with_stats=with_stats, time=tm), 5)
                checks[tag] = res


def motion_shape_timing(tables, rays, tag) -> dict:
    """K1's motion instance on `rays` = (o, d, tmax, time) (closest hit) and
    on the same rays cut to half the scene's diagonal (any hit): held
    against the plain walker; the wrapper call and the kernel alone, the
    static instance on the same rays and tables beside it (which reads no
    delta and no time, so it tests the triangles at shutter open), and the
    bound: `table_bound` of the walk plus a DELTA_ROW_BYTES delta row for
    each distinct triangle row read and TIME_BYTES for each live ray, and
    OPS_PER_LERP operations a prim test (the scene has triangles only).
    The static instance at the rays' own times walks other geometry (it
    tests the triangles where they stand at shutter open); the cost of the
    lerp itself is the motion instance with every ray at time 0, which must
    find exactly what the static one finds, timed in turns beside it."""
    ds, st = tables
    if st.n_spheres:
        fail("the motion timing counts every prim test as a triangle's")
    static_st = st._replace(has_motion=False)
    o2, d2, tmax2, tm = rays
    n = o2.shape[0]
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    lib = tw.get_lib()
    out = {"rays": n}
    for mode, any_hit, tmax in (
            ("closest", False, tmax2),
            ("any", True, torch.where(tmax2 > 0, half, 0.0).contiguous())):
        kernel = tw.intersect_wide_cuda(ds, st, o2, d2, tmax,
                                        any_hit=any_hit, time=tm)
        torch.cuda.synchronize()
        masks = touched_masks("traverse_wide", ds, o2.device)
        t0 = time.time()
        plain = trav.intersect_wide(ds, st, o2, d2, tmax, any_hit=any_hit,
                                    touched=masks, time=tm)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        res = compare_hits(f"traverse_wide_motion/{tag}/{mode}", kernel, plain)
        live = int((tmax > 0).sum())

        def run(lib_, st_=st, tmax=tmax, any_hit=any_hit):
            return tw.intersect_wide_cuda(ds, st_, o2, d2, tmax,
                                          any_hit=any_hit, lib=lib_, time=tm)

        static = functools.partial(run, st_=static_st)
        # at time 0 every vertex lerps to itself (v + 0 * dv = v), so the
        # motion instance must find what the static one finds, bit for bit,
        # counters included: the same walk, plus the delta loads and lerps
        zeros = torch.zeros_like(tm)
        at0 = tw.intersect_wide_cuda(ds, st, o2, d2, tmax, any_hit=any_hit,
                                     time=zeros)
        same = compare_hits(f"traverse_wide_motion/{tag}/{mode}/time0",
                            at0, static(None))
        if same["max_ulp"]:
            fail(f"{tag}/{mode}: the motion instance at time 0 differs from "
                 f"the static instance: {same}")

        def run0(lib_, tmax=tmax, any_hit=any_hit):
            return tw.intersect_wide_cuda(ds, st, o2, d2, tmax,
                                          any_hit=any_hit, lib=lib_,
                                          time=zeros)

        turns = {"static": [], "motion_at_time_0": []}
        for name, fn in (("static", static), ("motion_at_time_0", run0),
                         ("motion_at_time_0", run0), ("static", static)):
            turns[name].append(kernel_alone_ms(fn, lib))
        bound = table_bound("traverse_wide", ds, masks, kernel[1], live, n)
        is_tri = ds.prim_rows.view(torch.int32)[:, 17] == 1
        delta_rows = int((masks[1] & is_tri).sum())
        bytes_moved = (bound["bytes_moved_at_least"]
                       + DELTA_ROW_BYTES * delta_rows + TIME_BYTES * live)
        ops = bound["float_ops"] + OPS_PER_LERP * bound["prim_tests"]
        by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        by_ops = ops / FP32_OPS_PER_S * 1e3
        res.update(
            kernel_ms=time_ms(lambda: run(None), 10),
            kernel_alone_ms=kernel_alone_ms(run, lib),
            static_instance_ms=time_ms(lambda: static(None), 10),
            static_instance_alone_ms=kernel_alone_ms(static, lib),
            time0_equals_static_instance=same,
            alone_ms_in_turns_static_vs_motion_at_time_0=turns,
            plain_ms=plain_ms, live_rays=live,
            node_visits=bound["node_visits"], prim_tests=bound["prim_tests"],
            distinct_rows_read=bound["distinct_rows_read"],
            delta_rows_read=delta_rows,
            static_bound_ms=bound["bound_ms"],
            bytes_moved_at_least=bytes_moved, float_ops=ops,
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        out[mode] = res
    return out


def vignetted_share(r, sample_idx: int = 0) -> float:
    """The share of one sample's camera rays that the realistic camera's
    lens stack stops (its exit-pupil boxes in use)."""
    cam, sampler = r.scene.camera, r.sampler
    dead = total = 0
    for b in range(r.n_batches):
        px_b, py_b = r._px_b[b], r._py_b[b]
        jx, jy = sampler.camera_jitter(px_b, py_b, sample_idx)
        p_raster = torch.stack([px_b.to(torch.float32) + jx,
                                py_b.to(torch.float32) + jy], -1)
        u = torch.stack([sampler.dim(px_b, py_b, sample_idx, 2),
                         sampler.dim(px_b, py_b, sample_idx, 3)], -1)
        _, _, alive, _ = realistic_rays(
            cam.lens_data, cam.lens_z, r.ds.cam_to_world, p_raster, u,
            r.cfg.xres, r.cfg.yres, cam.film_diag, pupil=r.pupil)
        valid = r._valid_b[b]
        dead += int((valid & ~alive).sum())
        total += int(valid.sum())
    return dead / max(total, 1)


def motion(dev, static_museum) -> dict:
    """The motion phase: tools/testscenes.py `motion_museum` at MUSEUM_65K's
    size through the entry points, SPP_MOTION samples at MAIN_RES through
    K1's motion instance with the launch counts set to 0 just before and
    read just after (no static K1 launch), beside `static_museum` = (scene,
    tables) rendered in this phase, held against the plain walker on
    PLAIN_CROP, and one fwd+bwd sample of `value_and_grad` (the film linear
    in light_L); `realistic_museum` through K1's static instance, with the
    share of camera rays vignetted, against the plain walker on the crop;
    and tools/sweep.py over SWEEP_SET at SWEEP_RES, 1 spp, on the card, its
    records read back."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = testscenes.motion_museum(tmp, **MUSEUM_65K)
        t_gen = time.time() - t0
        t0 = time.time()
        scene = flatten(parse_file(path), tmp)
        t_flatten = time.time() - t0
        rdir = os.path.join(tmp, "realistic")
        real_path = testscenes.realistic_museum(
            rdir, aperture_mm=REALISTIC_APERTURE_MM, **MUSEUM_65K)
        sc_real = flatten(parse_file(real_path), rdir)

        # the sweep: the plain museum with its accelerator as $acc
        sweep_path = os.path.join(tmp, "sweep_museum.pbrt")
        text = open(os.path.join(tmp, "museum.pbrt")).read()
        with open(sweep_path, "w") as f:
            f.write(text.replace("WorldBegin", "Accelerator $acc\nWorldBegin"))
        out_dir = os.path.join(tmp, "sweep_out")
        zero_launches()
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = sweep_tool.main([sweep_path, "--set", SWEEP_SET,
                                  "--resolution", f"{SWEEP_RES}x{SWEEP_RES}",
                                  "--spp", "1", "--outdir", out_dir])
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
        sweep_counts = launch_counts()
        if rc != 0:
            fail(f"tools/sweep.py exited with {rc}")
        records = json.load(open(os.path.join(out_dir, "sweep.json")))
        files = sorted(os.listdir(out_dir))
        for rec in records:
            want = [f"{rec['tag']}.png"] + [f"{rec['tag']}.{k}.txt" for k in (
                "node_visits", "leaf_visits", "prim_tests", "path_length")]
            if not set(want) <= set(files) or not rec["mean_node_visits"] > 0:
                fail(f"the sweep's record or files of {rec['tag']} are "
                     f"missing: {rec}, {files}")
        calls = 2 * (scene.integrator.max_depth + 1)
        if ([r["tag"] for r in records] != ["acc-bvh", "acc-kdtree"]
                or sweep_counts["traverse_wide"] != calls
                or sweep_counts["traverse_kdbsp"] != calls):
            fail(f"the sweep did not render its configs through K1 and K2: "
                 f"{records}, {sweep_counts}")
    t0 = time.time()
    tables = upload(scene, light_strategy=scene.integrator.light_strategy,
                    device=dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    ds, st = tables
    if not (st.has_motion and st.cam_animated) or st.two_level:
        fail(f"the motion museum's tables are not what it asks for: {st}")
    r = Renderer(scene, device=dev, tables=tables)
    film, ms, counts = drive(r, {"traverse_wide_motion": 1}, SPP_MOTION)
    fin, lum = check_image(r, film, "motion_museum")
    img = r.image(film)
    del film
    r_static = Renderer(static_museum[0], device=dev, tables=static_museum[1])
    _, ms_static, _ = drive(r_static, {"traverse_wide": 1}, 1)
    del r_static
    plain = against_plain_render(scene, tables, "traverse_wide_motion", dev,
                                 plain_isect=plain_traversal("traverse_wide"),
                                 crop=PLAIN_CROP)
    grad_line = emitter_grads(grad_renderer(scene, tables, dev),
                              {k: getattr(ds, k) for k in GRAD_PARAMS}, 1,
                              ("light_L",), LINEARITY_RTOL, "motion",
                              kind="traverse_wide_motion")
    expected = 2 * (scene.integrator.max_depth + 1) * r.n_batches * SPP_MOTION
    batches = r.n_batches
    del r

    # the realistic camera through K1's static instance
    t0 = time.time()
    tables_r = upload(sc_real, light_strategy=sc_real.integrator.light_strategy,
                      device=dev)
    rr = Renderer(sc_real, device=dev, tables=tables_r)
    torch.cuda.synchronize()
    t_real_setup = time.time() - t0
    if rr.pupil is None or tables_r[1].has_motion:
        fail("the realistic museum has no lens stack")
    film_r, ms_r, counts_r = drive(rr, {"traverse_wide": 1}, SPP_REALISTIC)
    fin_r, lum_r = check_image(rr, film_r, "realistic_museum")
    del film_r
    vig = vignetted_share(rr)
    plain_r = against_plain_render(sc_real, tables_r, "traverse_wide", dev,
                                   crop=PLAIN_CROP)
    lens = sc_real.camera.lens_data
    return {
        "scene": "tools/testscenes.py motion_museum", **MUSEUM_65K,
        "triangles": st.n_tris, "two_level": st.two_level,
        "has_motion": st.has_motion, "cam_animated": st.cam_animated,
        "host_s": {"write_scenes": round(t_gen, 2),
                   "parse_flatten": round(t_flatten, 2),
                   "bvh_upload_deltas": round(t_upload, 2)},
        "resolution": [MAIN_RES, MAIN_RES],
        "max_depth": scene.integrator.max_depth, "spp": SPP_MOTION,
        "ms_per_spp": ms,
        "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms * 1e-3),
        "static_museum_ms_per_spp": ms_static,
        "batches": batches, "launches": counts,
        "launches_expected": {"traverse_wide_motion": expected,
                              "traverse_wide": 0},
        "finite_pixel_share": fin, "mean_luminance": lum,
        "image_mean_rgb": [float(x) for x in img.reshape(-1, 3).mean(0)],
        **plain, "gradients": grad_line,
        "realistic": {
            "scene": "tools/testscenes.py realistic_museum",
            "lens_rows_mm": testscenes.TEST_LENS_ROWS,
            "aperture_stop_mm": REALISTIC_APERTURE_MM,
            "rear_gap_after_focus_m": float(lens[-1, 1]),
            "setup_s_upload_and_exit_pupil": round(t_real_setup, 2),
            "spp": SPP_REALISTIC, "ms_per_spp": ms_r,
            "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_r * 1e-3),
            "launches": counts_r, "vignetted_camera_ray_share": vig,
            "finite_pixel_share": fin_r, "mean_luminance": lum_r,
            **plain_r},
        "sweep": {"set": SWEEP_SET, "resolution": SWEEP_RES, "spp": 1,
                  "seconds": round(sweep_s, 2), "launches": sweep_counts,
                  "records": records}}


def bench_loss(film):
    """bench.py's loss: the sum of the film's weighted radiance."""
    return film.rgb.sum()


def fwd_bwd(scene, tables, kind, spp, dev, with_profile=False) -> dict:
    """`Renderer.value_and_grad` of `bench_loss` over `spp` samples (one
    call a sample) at the main path's width, through kernel `kind`, with the
    launch counts set to 0 just before and read just after; beside it the
    same renderer's forward sample and the same step over PLAIN_CROP through
    the kernel and through its plain version. Fails unless every gradient is
    finite and every table's nonzero, the film is linear in light_L, the
    kernel launched exactly as often as in the forward samples, and kernel
    and plain version give the same gradients. `with_profile` adds
    `profile_one_spp` of one more fwd+bwd sample."""
    renderer = Renderer(scene, device=dev, tables=tables)
    params = {k: getattr(renderer.ds, k) for k in GRAD_PARAMS}
    warm_up(renderer)
    torch.cuda.synchronize()
    t0 = time.time()
    film_fwd = renderer.render(spp=1)
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    bytes_before = torch.cuda.memory_allocated()
    zero_launches()
    step_ms, values, linearity = [], [], []
    for s in range(spp):
        t0 = time.time()
        value, grads, film = renderer.value_and_grad(bench_loss, params, s)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t0) * 1e3)
        v = float(value)
        for k, g in grads.items():
            if not bool(torch.isfinite(g).all()) or not float(g.abs().max()) > 0:
                fail(f"{kind} gradients: d loss / d {k} is not finite or is 0")
        lin = float((grads["light_L"] * params["light_L"]).sum())
        if not abs(lin - v) <= LINEARITY_RTOL * abs(v):
            fail(f"{kind} gradients: sum(light_L * dloss/dlight_L) = {lin}, "
                 f"loss {v}")
        values.append(v)
        linearity.append(lin)
        if s == 0:
            film_rel = float((film.rgb - film_fwd.rgb).abs().mean()
                             / film_fwd.rgb.abs().mean().clamp_min(1e-30))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    depth = scene.integrator.max_depth
    want = 2 * (depth + 1) * renderer.n_batches * spp
    for k, c in counts.items():
        if c != (want if k == kind else 0):
            fail(f"value_and_grad through {kind} launched {k} {c} times, "
                 f"expected {want if k == kind else 0}")
    if not film_rel <= FILM_VS_RENDER_REL:
        fail(f"{kind}: value_and_grad's film differs from render's: {film_rel}")
    ms = sum(step_ms) / spp
    del film, film_fwd, grads
    profiled = ({"profile": profile_one_spp(lambda: renderer.value_and_grad(
        bench_loss, params))} if with_profile else {})
    return {**profiled, "kernel": kind, "triangles": renderer.st.n_tris,
            "resolution": [scene.film.xres, scene.film.yres],
            "max_depth": depth, "spp": spp, "batches": renderer.n_batches,
            "fwd_bwd_ms_per_spp": ms, "fwd_bwd_ms_each_spp": step_ms,
            "fwd_bwd_camera_rays_per_s":
                scene.film.xres * scene.film.yres / (ms * 1e-3),
            "fwd_ms_per_spp": fwd_ms, "fwd_bwd_over_fwd": ms / fwd_ms,
            "peak_allocated_bytes": peak,
            "allocated_bytes_before": bytes_before,
            "launches": counts, "launches_per_spp": counts[kind] // spp,
            "loss": values, "sum_light_L_times_grad": linearity,
            "linearity_rtol": LINEARITY_RTOL,
            "film_mean_rel_to_render": film_rel,
            **grads_against_plain(scene, tables, kind, dev)}


def grads_against_plain(scene, tables, kind, dev) -> dict:
    """value_and_grad of `bench_loss` over PLAIN_CROP through kernel `kind`
    and through its plain version, on the same tables: per table the largest
    difference over the largest gradient."""
    scene = dataclasses.replace(
        scene, film=dataclasses.replace(scene.film, crop=PLAIN_CROP))
    out = {}
    for name, isect in (("kernel", None), ("plain", plain_traversal(kind))):
        r = Renderer(scene, device=dev, tables=tables, isect=isect)
        params = {k: getattr(r.ds, k) for k in GRAD_PARAMS}
        before = launch_counts()[kind]
        t0 = time.time()
        out[name] = r.value_and_grad(bench_loss, params)
        torch.cuda.synchronize()
        out[name + "_s"] = time.time() - t0
        ran = launch_counts()[kind] != before
        if ran != (name == "kernel"):
            fail(f"the cropped value_and_grad through the {name} of {kind} "
                 f"launched {kind}: {ran}")
    (vk, gk, _), (vp, gp, _) = out["kernel"], out["plain"]
    rel = {k: float((gk[k] - gp[k]).abs().max()
                    / gp[k].abs().max().clamp_min(1e-30)) for k in gp}
    if not max(rel.values()) <= GRAD_VS_PLAIN:
        fail(f"{kind}: gradients through the kernel differ from those through "
             f"its plain version: {rel}")
    return {"crop": PLAIN_CROP, "crop_loss_kernel": float(vk),
            "crop_loss_plain": float(vp),
            "crop_grad_max_rel_kernel_vs_plain": rel,
            "crop_grad_rel_bound": GRAD_VS_PLAIN,
            "crop_plain_fwd_bwd_s": round(out["plain_s"], 1)}


def train_steps(scene, tables, dev) -> dict:
    """TRAIN_STEPS steps of `train_step_fn` with respect to GRAD_PARAMS
    toward the scene rendered (1 spp) with every diffuse albedo halved; fails
    unless every loss is finite and the last is below the first."""
    ds, st = tables
    target_r = Renderer(scene, device=dev,
                        tables=(ds._replace(mat_kd=ds.mat_kd * 0.5), st))
    target = target_r.image(target_r.render(spp=1))
    del target_r
    step, params0 = train_step_fn(scene, None, target, device=dev,
                                  tables=tables)
    params = {k: params0[k] for k in GRAD_PARAMS}
    losses, ms = [], []
    torch.cuda.synchronize()
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        loss, params = step(params, 0, TRAIN_LR)
        losses.append(float(loss))
        ms.append((time.time() - t0) * 1e3)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"training did not lower the loss: {losses}")
    return {"triangles": st.n_tris, "resolution": [scene.film.xres,
                                                   scene.film.yres],
            "params": GRAD_PARAMS, "lr": TRAIN_LR, "target": "mat_kd * 0.5",
            "loss_each_step": losses, "ms_each_step": ms,
            "mat_kd_after": params["mat_kd"].cpu().tolist()}


def device_rows(prof):
    """(kernel name, device ms, launches) of a torch.profiler run, longest
    first. Kernel rows only: the profiler also credits each kernel's time to
    the operator that launched it, and summing both would count it twice."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        on_device = str(getattr(e, "device_type", "")).upper().endswith("CUDA")
        if dev_us > 0 and on_device:
            rows.append((e.key, dev_us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def profile_call(fn):
    """Device time by kernel name over one call of `fn` (after one warm-up
    call), from torch.profiler: how much of a re-queue driver call its
    kernels take and how much the PyTorch work between them. "not measured"
    where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        return "not measured"
    ours = [r for r in rows if any(k in r[0] for k in (
        "bin_rays_kernel", "walk_pairs_kernel", "traverse_treelets_kernel"))]
    sorts = [r for r in rows if "sort" in r[0].lower()]
    return {"device_ms": sum(r[1] for r in rows),
            "device_launches": sum(r[2] for r in rows),
            "hand_written_kernels_ms": sum(r[1] for r in ours),
            "sort_kernels_ms": sum(r[1] for r in sorts),
            "sort_kernel_launches": sum(r[2] for r in sorts),
            "by_kernel": [{"name": r[0][:70], "ms": r[1], "launches": r[2]}
                          for r in rows[:12]]}


def profile_one_spp(run):
    """Device time by kernel name over `run()`, one sample of the 1M museum
    (a forward one or a fwd+bwd one), from torch.profiler: what share the
    traversal kernel has, and how much of the wall time the device is busy
    at all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    rows = device_rows(prof)
    if not rows:
        fail("torch.profiler recorded no device time")
    dev_ms = sum(r[1] for r in rows)
    walk = [r for r in rows if "traverse_" in r[0] and "_kernel" in r[0]]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms if wall_ms else None,
            "device_kernel_launches": sum(r[2] for r in rows),
            "traversal_kernel_ms": sum(r[1] for r in walk),
            "traversal_kernel_launches": sum(r[2] for r in walk),
            "top_kernels": [{"name": r[0][:80], "ms": round(r[1], 3),
                             "launches": r[2]} for r in rows[:10]]}


def secondary_rays(ds, st, hit, o, d, seed):
    """Cosine-scattered rays from the hits of (o, d): what a diffuse bounce
    hands the next traversal. Lanes that missed come back dead (tmax 0)."""
    n = o.shape[0]
    gen = np.random.default_rng(seed)
    u = torch.from_numpy(gen.random((2, n), dtype=np.float32)).to(o.device)
    sp = shading_point(ds, st, hit, o, d)
    t_f, b_f, n_f = bx.make_frame(sp.ns)
    wi = bx.to_world(t_f, b_f, n_f, cosine_sample_hemisphere(u[0], u[1]))
    o2 = offset_ray_origin(sp.p, sp.ng, wi)
    tmax = torch.where(hit.valid, float("inf"), 0.0).to(torch.float32)
    return o2.contiguous(), wi.contiguous(), tmax


def camera_rays(scene, ds, dev, xres, yres, seed):
    gen = np.random.default_rng(seed)
    py, px = np.meshgrid(np.arange(yres), np.arange(xres), indexing="ij")
    jit = gen.random((2, xres * yres), dtype=np.float32)
    p_raster = np.stack([px.ravel() + jit[0], py.ravel() + jit[1]], -1)
    p_raster = torch.from_numpy(p_raster.astype(np.float32)).to(dev)
    cam = scene.camera
    o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                         p_raster, torch.zeros_like(p_raster),
                         cam.lens_radius, cam.focal_distance)
    return o.contiguous(), d.contiguous()


def mixed_rays(scene, ds, st, dev):
    """131,072 camera rays of the scene's camera (at the scene's resolution)
    plus the 131,072 secondary rays scattered from their hits."""
    o, d = camera_rays(scene, ds, dev, scene.film.xres, scene.film.yres, 23)
    tmax = torch.full((o.shape[0],), float("inf"), device=dev)
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, tmax)
    o2, d2, tmax2 = secondary_rays(ds, st, hit, o, d, 29)
    return (torch.cat([o, o2]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tmax, tmax2]).contiguous())


def main_shape_rays(renderer, scene, tables_1l, dev):
    """One batch of the main path's size on the main path's scene: the
    secondary rays of the camera batch in the middle of the image, where the
    statues stand. Returns (o, d, tmax) with dead lanes at tmax 0."""
    ds, st = tables_1l
    # a batch's pixels are 32x32 tiles; take its raster positions
    mid = renderer.n_batches // 2
    px = renderer._px_b[mid].to(torch.float32) + 0.5
    py = renderer._py_b[mid].to(torch.float32) + 0.5
    p_raster = torch.stack([px, py], -1)
    cam = scene.camera
    o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                         p_raster, torch.zeros_like(p_raster),
                         cam.lens_radius, cam.focal_distance)
    o, d = o.contiguous(), d.contiguous()
    inf = torch.full((renderer.batch,), float("inf"), device=dev)
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, inf)
    return secondary_rays(ds, st, hit, o, d, 31)


def table_bound(kind, ds, masks, stats, live, n_out):
    """The least time of a traversal kernel's work on the card: the larger
    of (a) the bytes it must move at least once over the card's memory rate:
    every table row some ray read (the plain version's `touched` masks),
    counted once at the bytes the kernel loads of it, the origin and
    direction of each of the `live` rays, and tmax read and the record
    written for each of `n_out` rays; and (b) the float32 operations of the
    rays' node steps and prim tests (`stats`) over the card's float32
    rate."""
    spec = KERNELS[kind]
    prim_table = getattr(ds, spec["tables"][-2] if kind == "traverse_treelets"
                         else spec["tables"][1])
    is_tri = prim_table.view(torch.int32)[:, 17] == 1
    nodes = int(stats.node_visits.sum())
    tests = int(stats.prim_tests.sum())
    if kind == "traverse_treelets":
        rows = {"nodes": int(masks[0].sum()) + int(masks[1].sum()),
                "treelets": int(masks[3].sum())}
        prim_mask = masks[2]
    elif kind == "traverse_kdbsp":
        # the plain walker marks interior and leaf rows alike; the row's own
        # leaf flag tells them apart
        is_leaf = ds.alt_nodes.view(torch.int32)[:, 4] != 0
        rows = {"nodes": int((masks[0] & ~is_leaf).sum()),
                "leaves": int((masks[0] & is_leaf).sum()), "treelets": 0}
        prim_mask = masks[1]
    else:
        rows = {"nodes": int(masks[0].sum()), "treelets": 0}
        prim_mask = masks[1]
    rows["triangles"] = int((prim_mask & is_tri).sum())
    rows["quadrics"] = int((prim_mask & ~is_tri).sum())
    bytes_moved = (spec["node_row_bytes"] * rows["nodes"]
                   + KD_LEAF_ROW_BYTES * rows.get("leaves", 0)
                   + TRI_ROW_BYTES * rows["triangles"]
                   + QUADRIC_ROW_BYTES * rows["quadrics"]
                   + TREELET_REF_BYTES * rows["treelets"]
                   + RAY_LIVE_BYTES * live + RAY_BYTES * n_out)
    ops = spec["ops_per_node"] * nodes + OPS_PER_PRIM * tests
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(node_visits=nodes, leaf_visits=int(stats.leaf_visits.sum()),
                prim_tests=tests, distinct_rows_read=rows,
                bytes_moved_at_least=bytes_moved,
                bytes_if_every_visit_missed_cache=(
                    spec["node_row_bytes"] * nodes + TRI_ROW_BYTES * tests
                    + (KD_LEAF_ROW_BYTES * int(stats.leaf_visits.sum())
                       if kind == "traverse_kdbsp" else 0)),
                float_ops=ops, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def touched_masks(kind, ds, dev):
    return [torch.zeros(getattr(ds, t).shape[0], dtype=torch.bool, device=dev)
            for t in KERNELS[kind]["tables"]]


def main_shape_timing(kind, tables, rays, fmad_libs, tag, variants=None):
    """Kernel `kind`, its plain version and its bound on `rays` (closest
    hit) and on the same rays cut to half the scene's diagonal (any hit):
    the wrapper call as the main path makes it and the kernel alone, and
    each build of `variants` (name -> library) beside the shipped one.
    bound_ms: `table_bound` of this batch."""
    ds, st = tables
    spec = KERNELS[kind]
    call, plain_fn = spec["call"], spec["plain"]
    o2, d2, tmax2 = rays
    n = o2.shape[0]
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=o2.device)
    out = {}
    for mode, any_hit, tmax in (
            ("closest", False, tmax2),
            ("any", True, torch.where(tmax2 > 0, half, 0.0).contiguous())):
        kernel = call(ds, st, o2, d2, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        masks = touched_masks(kind, ds, o2.device)
        t0 = time.time()
        plain = plain_fn(ds, st, o2, d2, tmax, any_hit=any_hit, touched=masks)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        res = compare_hits(f"{kind}/{tag}/{mode}", kernel, plain)
        live = int((tmax > 0).sum())
        lib_fmad = fmad_libs[kind]

        def run(lib, tmax=tmax, any_hit=any_hit):
            return call(ds, st, o2, d2, tmax, any_hit=any_hit, lib=lib)

        res.update(
            kernel_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit), 10),
            kernel_alone_ms=kernel_alone_ms(run, spec["mod"].get_lib()),
            kernel_cold_l2_ms=time_cold_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit), 10, flush),
            kernel_nostats_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit, with_stats=False), 10),
            kernel_fmad_true_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit, lib=lib_fmad), 10),
            plain_ms=plain_ms,
            **table_bound(kind, ds, masks, kernel[1], live, n))
        if variants:
            res["variants"] = variant_timing(
                run, spec["mod"].get_lib(), variants,
                lambda name, got, mode=mode, plain=plain: compare_hits(
                    f"{kind}/{tag}/{mode}/variant {name}", got, plain))
        fm = call(ds, st, o2, d2, tmax, any_hit=any_hit, lib=lib_fmad)
        res["fmad_true_prim_mismatch"] = int((fm[0].prim != plain[0].prim).sum())
        res["fmad_true_counter_mismatch"] = int(
            (fm[1].node_visits != plain[1].node_visits).sum())
        out[mode] = res
        if mode == "closest":
            out["prims"] = kernel[0].prim
    return out


def fallback_timing(tables, o, d, tmax, any_hit, variants=None):
    """K3 as the re-queue driver calls it for the rays whose treelet list
    overflowed: every ray of the batch, tmax 0 on all others, no counters.
    The kernel is held against the plain walker on those rays; the wrapper
    call and the kernel alone are timed, and each build of `variants` beside
    the shipped one. bound_ms is `table_bound` of the live rays only: the
    rows they read, their rays read and their records written."""
    ds, st = tables
    masks = touched_masks("traverse_treelets", ds, o.device)
    plain = trav.intersect_two_level(ds, st, o, d, tmax, any_hit=any_hit,
                                     touched=masks)
    tag = f"traverse_treelets/fallback/{'any' if any_hit else 'closest'}"

    def run(lib):
        return tt.intersect_treelets_cuda(ds, st, o, d, tmax, any_hit=any_hit,
                                          with_stats=False, lib=lib)

    res = compare_hits(tag, run(None), plain, with_stats=False)
    live = int((tmax > 0).sum())
    res.update(
        rays=o.shape[0], live_rays=live,
        kernel_ms=time_ms(lambda: run(None), 10),
        kernel_alone_ms=kernel_alone_ms(run, tt.get_lib()),
        **table_bound("traverse_treelets", ds, masks, plain[1], live, live))
    if variants:
        res["variants"] = variant_timing(
            run, tt.get_lib(), variants, lambda name, got: compare_hits(
                f"{tag}/variant {name}", got, plain, with_stats=False))
    return res


def as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def check_bits(tag, names, kernel, plain) -> float:
    """Kernel K4 / K5 against its plain version: every output equal to the
    bit; fails the run otherwise. Returns the largest |kernel - plain| over
    the outputs (0.0 where all bits agree)."""
    bad = [nm for nm, a, b in zip(names, kernel, plain)
           if a.shape != b.shape or not torch.equal(as_bits(a), as_bits(b))]
    if bad:
        fail(f"{tag}: kernel and plain version differ in {bad}")
    return max((float(torch.where(as_bits(a) == as_bits(b), 0.0,
                                  (a.double() - b.double()).abs()).max())
                for a, b in zip(kernel, plain) if a.numel()), default=0.0)


def by_entry_t(lists):
    """(tid, tnear, ovf) with each list put through a stable sort by entry
    t."""
    tid, tnear, ovf = lists
    tnear, order = torch.sort(tnear, dim=1, stable=True)
    return tid.gather(1, order), tnear, ovf


def clone_best(best):
    return trav.RayBest(*[x.clone() for x in best])


def checked_requeue(ds, st, o, d, tmax, r_list, any_hit, tag, touched=None):
    """One closest / any hit call of the re-queue driver's own pass loop
    (`tr._requeue`, what `intersect_requeue` runs) with checking wrappers in
    place of K4 and K5: each launches its kernel, runs the plain version on
    the same inputs (K5 on a copy of the rays' best hits), holds the two bit
    for bit (K5: every ray's word, the payloads and the counters; also
    without counters, which must then stay untouched) and hands the
    kernel's result on. `touched` = {"top": [...], "treelets": [...]} takes
    the plain versions' row marks. Returns (the driver's (Hit, stats), K4's
    lists, one dict a pass with K5's inputs, the rays' best hits before and
    after it and its live pairs, the plain versions' ms, the largest
    |kernel - plain| of each kernel, the tmax its K3 fallback was called
    with)."""
    lists, passes = [], []
    plain_ms = {"bin_rays": 0.0, "walk_pairs": []}
    err = {"bin_rays": 0.0, "walk_pairs": 0.0}

    def plain_timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.time() - t0) * 1e3

    def bin_fn(ds, st, o, d, tmax, r_list):
        out = tr.bin_rays_cuda(ds, st, o, d, tmax, r_list)
        plain, plain_ms["bin_rays"] = plain_timed(lambda: trav.bin_rays(
            ds, st, o, d, tmax, r_list, touched=touched and touched["top"]))
        err["bin_rays"] = max(err["bin_rays"], check_bits(
            f"{tag}/bin_rays", ("tid", "tnear", "ovf"), out, plain))
        lists.append(out)
        return out

    def walk(ds, st, o, d, key, ray, work, t_in, best, slot_base, any_hit,
             with_stats):
        before, work0 = clone_best(best), work.clone()
        bare = tr.walk_pairs_cuda(ds, st, o, d, key, ray, work0.clone(), t_in,
                                  clone_best(best), slot_base,
                                  any_hit=any_hit, with_stats=False)
        tr.walk_pairs_cuda(ds, st, o, d, key, ray, work, t_in, best,
                           slot_base, any_hit=any_hit, with_stats=with_stats)
        plain, ms = plain_timed(lambda: trav.walk_pairs(
            ds, st, o, d, key, ray, work0.clone(), t_in, clone_best(before),
            slot_base, any_hit=any_hit, with_stats=with_stats,
            touched=touched and touched["treelets"]))
        plain_ms["walk_pairs"].append(ms)
        ptag = f"{tag}/walk_pairs/pass{len(passes)}"
        err["walk_pairs"] = max(
            err["walk_pairs"],
            check_bits(ptag, trav.RayBest._fields, best, plain),
            check_bits(ptag + "/nostats", trav.RayBest._fields,
                       bare, plain[:2] + before[2:]))
        live = key < trav.pair_sentinel(st)
        n_pairs, n_walked = int(live.sum()), int(work0[0])
        if n_walked < n_pairs or not bool(live[:n_pairs].all()):
            fail(f"{ptag}: the kernel walks {n_walked} slots, not the "
                 f"{n_pairs} live pairs")
        rays = torch.unique(ray[live])
        winners = ((best.word & trav.NO_SLOT) >= slot_base) & (
            (best.word & trav.NO_SLOT) < slot_base + key.shape[0])
        passes.append(dict(key=key, ray=ray, work=work0, t_in=t_in,
                           slot_base=slot_base, before=before,
                           after=clone_best(best), live_pairs=n_pairs,
                           walked_slots=n_walked,
                           rays_with_pairs=int(rays.numel()),
                           winners=int(winners.sum())))
        return best

    fallback_tmax = []

    def fallback(ds, st, o, d, tmax, any_hit):
        fallback_tmax.append(tmax)
        return tt.intersect_treelets_cuda(ds, st, o, d, tmax, any_hit=any_hit,
                                          with_stats=False)

    out = tr._requeue(bin_fn, walk, fallback, ds, st, o, d, tmax,
                      any_hit=any_hit, r_list=r_list)

    direct = tr.intersect_requeue(ds, st, o, d, tmax, any_hit=any_hit,
                                  r_list=r_list)
    check_bits(f"{tag}/intersect_requeue", trav.Hit._fields
               + trav.TraversalStats._fields, [*direct[0], *direct[1]],
               [*out[0], *out[1]])
    return out, lists[0], passes, plain_ms, err, fallback_tmax[0]


def check_live_count_cap(ds, st, o, d, p, any_hit, tag):
    """K5 handed only the live pairs of pass 0 `p`, into a payload of
    exactly their slots, given a live count 4,096 past them, against K5
    given the count itself: it must walk the pairs there are and read and
    write nothing past them. Fails the run on any miss."""
    n = p["live_pairs"]
    key, ray = p["key"][:n].contiguous(), p["ray"][:n].contiguous()

    def run(count):
        best = clone_best(p["before"])._replace(payload=torch.zeros(
            (n, 4), dtype=torch.int32, device=key.device))
        work = torch.tensor([count, 0], dtype=torch.int32, device=key.device)
        return tr.walk_pairs_cuda(ds, st, o, d, key, ray, work, p["t_in"],
                                  best, 0, any_hit=any_hit)
    return check_bits(f"{tag}/walk_pairs/live_count_past_the_pairs",
                      trav.RayBest._fields, run(n + 4096), run(n))


def walk_pass(ds, st, o, d, p, any_hit, lib=None, with_stats=True,
              best=None):
    """K5 once more on pass `p` of `checked_requeue` (a fresh copy of its
    work counter), on `best` (default: a copy of the rays' best hits before
    the pass)."""
    return tr.walk_pairs_cuda(
        ds, st, o, d, p["key"], p["ray"], p["work"].clone(), p["t_in"],
        clone_best(p["before"]) if best is None else best, p["slot_base"],
        any_hit=any_hit, with_stats=with_stats, lib=lib)


def compare_requeue(tag, out, ref, any_hit, n_tris):
    """The re-queue driver's (Hit, stats) against the two-level walker's
    (or K3's, which equals it to the bit): valid equal everywhere; closest
    hit: t equal to the bit on every hit, and p_obj and the b1 / b2 of
    triangle hits where the prim is the same (a quadric hit leaves b1 / b2
    at whatever an earlier triangle hit of the same walk wrote, and the
    walks differ); another prim at exactly the same t is an exact-t tie
    (counted), allowed on at most REQUEUE_TIE_SHARE of the hits; any hit: t
    0 on every hit; `truncated` zero. Fails the run otherwise."""
    (hk, sk), (hp, _) = out, ref
    both = hk.valid & hp.valid
    res = dict(valid_mismatch=int((hk.valid != hp.valid).sum()),
               hits=int(hp.valid.sum()), truncated=int(sk.truncated.sum()))
    bad = res["valid_mismatch"] or res["truncated"]
    if any_hit:
        res["nonzero_t_on_hits"] = int((hk.t[hk.valid] != 0).sum())
        bad = bad or res["nonzero_t_on_hits"]
    else:
        same = both & (hk.prim == hp.prim)
        tri = same & (hp.prim < n_tris)
        res["record_mismatch"] = sum(
            int((as_bits(getattr(hk, f)) != as_bits(getattr(hp, f)))[m].sum())
            for f, m in (("t", both), ("b1", tri), ("b2", tri))) + int(
            (as_bits(hk.p_obj) != as_bits(hp.p_obj)).any(-1)[same].sum())
        res["exact_t_ties"] = int((both & (hk.prim != hp.prim)).sum())
        bad = (bad or res["record_mismatch"]
               or res["exact_t_ties"] > REQUEUE_TIE_SHARE * res["hits"])
    if bad:
        fail(f"re-queue driver disagrees with the two-level walker on {tag}: "
             f"{res}")
    return res


def check_requeue(cases, checks):
    """K4 and K5 against their plain versions, and the whole driver against
    the two-level walker, on each case, closest and any hit, at each list
    capacity of REQUEUE_R_LISTS (at capacity 16 also K5 given a live count
    past its pairs, `check_live_count_cap`); fails the run on any miss."""
    for name, ds, st, o, d, tmax in cases:
        for r_list in REQUEUE_R_LISTS:
            for any_hit in (False, True):
                mode = "any" if any_hit else "closest"
                tag = f"traverse_requeue/{name}/r{r_list}/{mode}"
                out, lists, passes, plain_ms, err, _ = checked_requeue(
                    ds, st, o, d, tmax, r_list, any_hit, tag)
                ref = trav.intersect_two_level(ds, st, o, d, tmax,
                                               any_hit=any_hit)
                res = compare_requeue(tag, out, ref, any_hit, st.n_tris)
                if r_list == tr.R_LIST:
                    err["walk_pairs"] = max(err["walk_pairs"],
                                            check_live_count_cap(
                                                ds, st, o, d, passes[0],
                                                any_hit, tag))
                res.update(
                    max_abs_err=err,
                    overflowed_rays=int((lists[2] > 0).sum()),
                    live_pairs=[p["live_pairs"] for p in passes],
                    plain_ms=plain_ms,
                    bin_rays_ms=time_ms(lambda: tr.bin_rays_cuda(
                        ds, st, o, d, tmax, r_list), 5),
                    walk_pairs_ms=[time_ms(
                        lambda p=p, b=clone_best(p["before"]): walk_pass(
                            ds, st, o, d, p, any_hit, best=b), 5)
                        for p in passes],
                    driver_ms=time_ms(lambda: tr.intersect_requeue(
                        ds, st, o, d, tmax, any_hit=any_hit,
                        r_list=r_list), 5))
                if r_list < tr.R_LIST and not res["overflowed_rays"]:
                    fail(f"{tag}: no list overflowed, the fallback never ran")
                checks[tag] = res


def check_bin_rays(cases, checks):
    """K4 alone against its plain version on each case at each list
    capacity of REQUEUE_R_LISTS, to the bit; fails the run on any miss."""
    for name, ds, st, o, d, tmax in cases:
        for r_list in REQUEUE_R_LISTS:
            tag = f"traverse_requeue/{name}/r{r_list}/bin_rays"
            checks[tag] = {"max_abs_err": {"bin_rays": check_bits(
                tag, ("tid", "tnear", "ovf"),
                tr.bin_rays_cuda(ds, st, o, d, tmax, r_list),
                trav.bin_rays(ds, st, o, d, tmax, r_list))}}


def requeue_shape_timing(tables, rays, fmad_lib, tag, k3_hits, var_libs):
    """K4, K5 (both passes of one driver call) and the whole driver on
    `rays` (closest hit) and on the same rays cut to half the scene's
    diagonal (any hit), against their plain versions and, for the driver,
    against K3's hits on the same rays (`k3_hits`, by mode); and K3 as
    the driver's fallback (`fallback_timing`). `var_libs` holds other builds
    of the sources (source -> name -> library), each timed beside the
    shipped one: of `traverse_requeue` as K4 and K5 here, of
    `traverse_treelets` as the fallback.

    bound_ms is built as in main_shape_timing: for K4 the distinct top rows
    the plain version reads (224 of each 256-byte row: six bounds and a
    meta a child), tmax of every ray and the origin and direction of the
    live ones read, and every ray's whole list row (empty records too) and
    overflow count written, against its top-tree steps; for K5 the distinct
    treelet node rows, prim rows and offsets the plain version reads over
    both passes, and in each pass the live pairs' keys and rays, each ray
    with a pair (its start t, origin and direction read, its word and
    counters written) and each winner's payload, against the node steps
    and prim tests of both passes. The
    kernel walks only the live pairs (`work` on the card):
    `dead_pair_bytes` counts what it moves for the dead pair slots of the
    sorted key array, 0 where it walks exactly the live pairs (checked)."""
    ds, st = tables
    o2, d2, tmax2 = rays
    n, dev = o2.shape[0], o2.device
    is_tri = ds.tl_prims.view(torch.int32)[:, 17] == 1
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    out = {}
    for mode, any_hit, tmax in (
            ("closest", False, tmax2),
            ("any", True, torch.where(tmax2 > 0, half, 0.0).contiguous())):
        touched = {
            "top": [torch.zeros(ds.top_nodes.shape[0], dtype=torch.bool,
                                device=dev),
                    torch.zeros(1, dtype=torch.int64, device=dev)],
            "treelets": [torch.zeros(t.shape[0], dtype=torch.bool, device=dev)
                         for t in (ds.tl_nodes, ds.tl_prims, ds.tl_offsets)]}
        drv, lists, passes, plain_ms, err, fb_tmax = checked_requeue(
            ds, st, o2, d2, tmax, tr.R_LIST, any_hit, f"{tag}/{mode}", touched)
        res = {"driver_vs_traverse_treelets": compare_requeue(
            f"{tag}/{mode}", drv, k3_hits[mode], any_hit, st.n_tris)}
        live = int((tmax > 0).sum())
        top_rows, steps = int(touched["top"][0].sum()), int(touched["top"][1])
        bin_bytes = (NODE_ROW_BYTES * top_rows + RAY_LIVE_BYTES * live + 4 * n
                     + (LIST_RECORD_BYTES * tr.R_LIST + 4) * n)
        bin_ops = OPS_PER_BIN_NODE * steps
        node_mask, prim_mask, tl_mask = touched["treelets"]
        walk_stats = [(p["after"][2:], p["before"][2:]) for p in passes]
        nodes = sum(int((a[0] - b[0]).sum()) for a, b in walk_stats)
        tests = sum(int((a[2] - b[2]).sum()) for a, b in walk_stats)
        walk_bytes = (NODE_ROW_BYTES * int(node_mask.sum())
                      + TRI_ROW_BYTES * int((prim_mask & is_tri).sum())
                      + QUADRIC_ROW_BYTES * int((prim_mask & ~is_tri).sum())
                      + TREELET_REF_BYTES * int(tl_mask.sum())
                      + sum(PAIR_BYTES * p["live_pairs"]
                            + RAY_PASS_BYTES * p["rays_with_pairs"]
                            + WINNER_BYTES * p["winners"] for p in passes))
        # the key, ray and rays' bytes of the pair slots the kernel walks
        # beyond the live ones
        dead_pair_bytes = sum(PAIR_BYTES * (p["walked_slots"] - p["live_pairs"])
                              for p in passes)
        walk_ops = OPS_PER_NODE * nodes + OPS_PER_PRIM * tests

        def bound(nbytes, ops):
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = ops / FP32_OPS_PER_S * 1e3
            return dict(bytes_moved_at_least=nbytes, float_ops=ops,
                        bound_ms=max(by_bytes, by_ops),
                        bound_by="bytes" if by_bytes >= by_ops else "operations")

        scratch = [clone_best(p["before"]) for p in passes]

        def walk(p, best, **kw):
            return walk_pass(ds, st, o2, d2, p, any_hit, best=best, **kw)

        def bin_run(lib, tmax=tmax):
            return tr.bin_rays_cuda(ds, st, o2, d2, tmax, lib=lib)

        res["bin_rays"] = dict(
            kernel_ms=time_ms(lambda: tr.bin_rays_cuda(ds, st, o2, d2, tmax), 10),
            kernel_alone_ms=kernel_alone_ms(bin_run, tr.get_lib()),
            kernel_cold_l2_ms=time_cold_ms(
                lambda: tr.bin_rays_cuda(ds, st, o2, d2, tmax), 10, flush),
            kernel_fmad_true_ms=time_ms(lambda: tr.bin_rays_cuda(
                ds, st, o2, d2, tmax, lib=fmad_lib), 10),
            plain_ms=plain_ms["bin_rays"], top_node_steps=steps,
            distinct_top_rows=top_rows,
            overflowed_share=float((lists[2] > 0).sum()) / max(live, 1),
            max_abs_err=err["bin_rays"], **bound(bin_bytes, bin_ops))
        # timed on a scratch copy of each pass's start state, which the
        # repeated launches lower again and again: the walks, and so the
        # time, do not depend on it (they start from t_in)
        per_pass = [time_ms(lambda p=p, b=b: walk(p, b), 10)
                    for p, b in zip(passes, scratch)]
        res["walk_pairs"] = dict(
            kernel_ms=sum(per_pass), kernel_ms_per_pass=per_pass,
            kernel_alone_ms=kernel_alone_ms(
                lambda lib: [walk(p, b, lib=lib)
                             for p, b in zip(passes, scratch)], tr.get_lib()),
            kernel_cold_l2_ms=sum(time_cold_ms(lambda p=p, b=b: walk(p, b),
                                               10, flush)
                                  for p, b in zip(passes, scratch)),
            kernel_nostats_ms=sum(time_ms(
                lambda p=p, b=b: walk(p, b, with_stats=False), 10)
                for p, b in zip(passes, scratch)),
            kernel_fmad_true_ms=sum(time_ms(
                lambda p=p, b=b: walk(p, b, lib=fmad_lib), 10)
                for p, b in zip(passes, scratch)),
            plain_ms=sum(plain_ms["walk_pairs"]),
            plain_ms_per_pass=plain_ms["walk_pairs"],
            pair_slots_per_pass=[p["key"].shape[0] for p in passes],
            live_pairs_per_pass=[p["live_pairs"] for p in passes],
            rays_with_pairs_per_pass=[p["rays_with_pairs"] for p in passes],
            winners_per_pass=[p["winners"] for p in passes],
            node_visits=nodes, prim_tests=tests,
            distinct_rows_read={"nodes": int(node_mask.sum()),
                                "triangles": int((prim_mask & is_tri).sum()),
                                "quadrics": int((prim_mask & ~is_tri).sum()),
                                "treelets": int(tl_mask.sum())},
            dead_pair_bytes=dead_pair_bytes,
            max_abs_err=err["walk_pairs"], **bound(walk_bytes, walk_ops))
        variants = var_libs.get("traverse_requeue")
        if variants:
            # a build that writes its lists in walk order (the one before) is
            # held after the stable sort by entry t the plain version ends
            # with, which leaves lists in (entry t, walk order) as they are
            res["bin_rays"]["variants"] = variant_timing(
                bin_run, tr.get_lib(), variants, lambda name, got: check_bits(
                    f"{tag}/{mode}/bin_rays variant {name}",
                    ("tid", "tnear", "ovf"), by_entry_t(got), lists))
            res["walk_pairs"]["variants"] = variant_timing(
                lambda lib: [walk(p, b, lib=lib)
                             for p, b in zip(passes, scratch)],
                tr.get_lib(), variants, lambda name, got: [check_bits(
                    f"{tag}/{mode}/walk_pairs variant {name} pass {i}",
                    trav.RayBest._fields, a, p["after"])
                    for i, (a, p) in enumerate(zip(got, passes))],
                check_run=lambda lib: [walk(p, clone_best(p["before"]),
                                            lib=lib) for p in passes])
        res["traverse_treelets_fallback"] = fallback_timing(
            tables, o2, d2, fb_tmax, any_hit, var_libs.get("traverse_treelets"))
        res["driver_ms"] = time_ms(lambda: tr.intersect_requeue(
            ds, st, o2, d2, tmax, any_hit=any_hit), 10)
        res["driver_nostats_ms"] = time_ms(lambda: tr.intersect_requeue(
            ds, st, o2, d2, tmax, any_hit=any_hit, with_stats=False), 10)
        res["driver_profile"] = profile_call(lambda: tr.intersect_requeue(
            ds, st, o2, d2, tmax, any_hit=any_hit))
        out[mode] = res
    return out



# ------------------------- K6: grid-medium tracking -------------------------

def k6_live(mt, med):
    """(medium index (N,) int64, the lanes K6 computes: grid media)."""
    mi = med.clamp_min(0).long()
    return mi, mt.is_grid[mi] & (med >= 0)


def k6_call(kind, lanes, lib=None):
    """Entry point `kind` of K6 through its wrapper on `lanes` = (mt, med,
    o, d, t_c, keys): a tuple of its outputs."""
    mt, med, o, d, t_c, keys = lanes
    mi, live = k6_live(mt, med)
    if kind == "tr_grid":
        return (mtk.tr_grid(mt, mi, o, d, t_c, keys, live, lib=lib),)
    return mtk.sample_distance_grid(mt, mi, o, d, t_c, keys, live, lib=lib)


def k6_plain(kind, lanes):
    """The plain version of entry `kind` (media/media.py) on `lanes`."""
    mt, med, o, d, t_c, keys = lanes
    mi, _ = k6_live(mt, med)
    if kind == "tr_grid":
        return (mmod.tr_grid_plain(mt, mi, o, d, t_c, keys),)
    return mmod.sample_distance_grid_plain(mt, mi, o, d, t_c, keys)


def compare_k6(tag, kind, lanes, out, plain, limit=None):
    """K6's outputs against its plain version's on the live lanes (the dead
    lanes at the kernel's defaults): interacted equal on every lane, t and
    the transmittance within `limit` ulps (K6_ULP_LIMIT); fails the run
    otherwise (limit < 0: report only)."""
    limit = K6_ULP_LIMIT if limit is None else limit
    _, live = k6_live(lanes[0], lanes[1])
    res = {"lanes": int(live.shape[0]), "live": int(live.sum())}
    if kind == "tr_grid":
        k, p = out[0], plain[0]
        dead_ok = bool((k[~live] == 1.0).all())
        res["attenuated"] = int((p[live] < 1.0).sum())
        res["interacted_mismatch"] = 0
    else:
        (ki, k), (pi, p) = out, plain
        dead_ok = bool((~ki[~live]).all() and (k[~live] == 0.0).all())
        res["interacted"] = int(pi[live].sum())
        res["interacted_mismatch"] = int((ki[live] != pi[live]).sum())
    ulps = ulp_diff(k[live], p[live])
    res["max_ulp"] = int(ulps.max()) if res["live"] else 0
    res["lanes_differing"] = int((ulps > 0).sum())
    res["max_abs_err"] = (float((k[live] - p[live]).abs().max())
                          if res["live"] else 0.0)
    bad = (not dead_ok or res["interacted_mismatch"]
           or (limit >= 0 and res["max_ulp"] > limit))
    if bad:
        fail(f"K6 {kind} disagrees with its plain version on {tag}: {res}, "
             f"dead lanes at their defaults: {dead_ok}")
    return res


def fog_lanes(scene, ds, st, dev, seed):
    """262,144 lanes of the fog museum for K6's checks, each starting at a
    random point inside the grid plume's interface box: half along the
    camera's ray through that point (a camera ray that crossed into the
    plume), half in random directions (rays scattered in the plume); each
    lane's segment ends at its closest hit (the box's far face, or what
    stands inside it). The lanes in the grid medium but 10 % in the room
    fog, 5 % in the tinted medium and 5 % in vacuum. Returns (mt, med, o,
    d, t_c, keys)."""
    gen = np.random.default_rng(seed)
    mt = mmod.media_view(ds)
    plume = scene.media_order.index("plume")
    w2m = mt.w2m[plume].double().cpu().numpy()
    m2w = np.linalg.inv(w2m)
    n = N_CHECK_RAYS
    unit = gen.random((n, 3))
    o = unit @ m2w[:3, :3].T + m2w[:3, 3]
    cam = scene.camera.cam_to_world[:3, 3]
    d_cam = o - cam
    d_rand = gen.normal(size=(n, 3))
    d = np.where((np.arange(n) < n // 2)[:, None], d_cam, d_rand)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.from_numpy(o.astype(np.float32)).to(dev).contiguous()
    d = torch.from_numpy(d.astype(np.float32)).to(dev).contiguous()
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, torch.full(
        (n,), float("inf"), device=dev))
    t_c = torch.where(hit.valid, hit.t, 1e7).clamp_max(1e7).contiguous()
    u = gen.random(n)
    med = np.full(n, plume, np.int32)
    med[u < 0.2] = scene.media_order.index("room")
    med[u < 0.1] = scene.media_order.index("tint")
    med[u < 0.05] = -1
    med = torch.from_numpy(med).to(dev)
    keys = rng_mod.uniform_u32(torch.arange(n, device=dev), seed)
    return (mt, med, o, d, t_c, keys)


def fog_edge_lanes(lanes, seed):
    """The edge batches of K6: 98 % of the lanes in vacuum, every lane in a
    homogeneous medium or vacuum, one live lane, and 131,073 lanes."""
    mt, med, o, d, t_c, keys = lanes
    gen = np.random.default_rng(seed)
    dead = torch.from_numpy(gen.random(med.shape[0]) < DEAD_SHARE).to(
        med.device)
    _, live = k6_live(mt, med)
    i = int(torch.nonzero(live)[0])
    cut = 131073

    def sub(sl):
        return (mt,) + tuple(x[sl].contiguous() for x in (med, o, d, t_c,
                                                             keys))
    return [("dead98", (mt, torch.where(dead, -1, med), o, d, t_c, keys)),
            ("all_dead", (mt, torch.where(live, 0, med), o, d, t_c, keys)),
            ("n1", sub(slice(i, i + 1))), (f"n{cut}", sub(slice(0, cut)))]


def check_k6(lanes, checks, fmad_lib):
    """Both entry points of K6 against their plain versions on the fog
    museum's lanes and the edge batches; the -fmad=true build beside them on
    the full set (reported, not held: PyTorch's own kernels are built with
    contraction allowed)."""
    cases = [("fog_museum", lanes)] + fog_edge_lanes(lanes, 59)
    for kind in mtk.FORWARD:
        for name, ln in cases:
            t0 = time.time()
            plain = k6_plain(kind, ln)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            out = k6_call(kind, ln)
            torch.cuda.synchronize()
            res = compare_k6(f"{kind}/{name}", kind, ln, out, plain)
            res["plain_ms"] = plain_ms
            checks[f"{kind}/{name}"] = res
            if name == "fog_museum":
                checks[f"{kind}/{name}/fmad_true_build"] = compare_k6(
                    f"{kind}/{name}/fmad", kind, ln,
                    k6_call(kind, ln, lib=fmad_lib), plain, limit=-1)
        if checks[f"{kind}/fog_museum"]["live"] < 100000:
            fail(f"K6 {kind}: the check lanes are hardly live")


def k6_cotangent(lanes, seed):
    """A seeded cotangent (N,) of a tr_grid call's transmittance."""
    n = lanes[1].shape[0]
    g = np.random.default_rng(seed).uniform(-1.0, 1.0, n).astype(np.float32)
    return torch.from_numpy(g).to(lanes[2].device)


def k6_backward_call(lanes, g, lib=None):
    """K6's backward through its wrapper: (g_lane (N, 20), g_density)."""
    mt, med, o, d, t_c, keys = lanes
    mi, live = k6_live(mt, med)
    return mtk.tr_grid_backward(mt, mi, o, d, t_c, keys, live, g, lib=lib)


def k6_backward_plain(lanes, g):
    mt, med, o, d, t_c, keys = lanes
    mi, live = k6_live(mt, med)
    return mmod.tr_grid_backward_plain(mt, mi, o, d, t_c, keys, g, live)


def compare_k6_backward(tag, lanes, out, plain):
    """K6's backward against its plain version: the per-lane outputs to the
    bit, the atlas within K6_ATLAS_REL of its largest; fails the run
    otherwise."""
    (gl_k, ga_k), (gl_p, ga_p) = out, plain
    _, live = k6_live(lanes[0], lanes[1])
    differ = (as_bits(gl_k) != as_bits(gl_p)).any(1)
    scale = float(ga_p.abs().max())
    atlas_err = float((ga_k - ga_p).abs().max())
    res = {"lanes": int(live.shape[0]), "live": int(live.sum()),
           "lanes_differing": int(differ.sum()),
           "max_abs_err": float((gl_k - gl_p).abs().max()),
           "lane_grad_abs_max": float(gl_p.abs().max()),
           "atlas_abs_max": scale, "atlas_max_abs_err": atlas_err,
           "atlas_rel_err": atlas_err / scale if scale > 0 else 0.0,
           "texels_with_gradient": int((ga_p != 0).sum())}
    if res["lanes_differing"] or atlas_err > K6_ATLAS_REL * scale:
        fail(f"K6 tr_grid_backward disagrees with its plain version on "
             f"{tag}: {res}")
    return res


def k6_factor_census(lanes):
    """Among the live lanes' steps before t_c: those whose x (density times
    mean extinction over the majorant) is exactly 0 (the tie of max(x, 0))
    and those whose factor 1 - max(x, 0) is 0 (x >= 1)."""
    mt, med, o, d, t_c, keys = lanes
    mi, live = k6_live(mt, med)
    inv_m, sig_m = mmod.tracking_constants(mt)
    inv, sig = inv_m[mi], sig_m[mi]
    t = torch.zeros_like(t_c)
    ties = zeros = 0
    for k in range(mmod.TR_STEPS):
        u = rng_mod.uniform_float(keys, k, mmod.TR_WORD)
        t = t - torch.log(1.0 - u) * inv
        act = live & (t < t_c)
        x = mmod.grid_density_lane(mt, mi, o + t[:, None] * d) * sig * inv
        ties += int((act & (x == 0.0)).sum())
        zeros += int((act & (x >= 1.0)).sum())
    return {"steps_at_the_tie": ties, "steps_with_a_zero_factor": zeros}


def check_k6_backward(lanes, scene, checks):
    """K6's backward against its plain version on the fog museum's check
    lanes, the forward's edge batches (98 % dead, all dead, one lane,
    131,073 lanes) and two more: the plume's density K6_ZERO_FACTOR_SCALE
    times itself under the same majorant (factors of exactly 0) and the
    lower half of the plume's texels emptied (x == 0, the tie)."""
    mt = lanes[0]
    plume = scene.media_order.index("plume")
    nx, ny, nz = (int(v) for v in mt.dens_dims[plume])
    off = int(mt.dens_off[plume])
    dense, empty = mt.density.clone(), mt.density.clone()
    dense[off:off + nx * ny * nz] *= K6_ZERO_FACTOR_SCALE
    empty[off:off + nx * ny * (nz // 2)] = 0.0
    cases = [("fog_museum", lanes)] + fog_edge_lanes(lanes, 59) + [
        ("zero_factors", (mt._replace(density=dense),) + lanes[1:]),
        ("empty_texels", (mt._replace(density=empty),) + lanes[1:])]
    for i, (name, ln) in enumerate(cases):
        g = k6_cotangent(ln, 67 + i)
        t0 = time.time()
        plain = k6_backward_plain(ln, g)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        out = k6_backward_call(ln, g)
        torch.cuda.synchronize()
        res = compare_k6_backward(f"tr_grid_backward/{name}", ln, out, plain)
        res["plain_ms"] = plain_ms
        if name in ("fog_museum", "zero_factors", "empty_texels"):
            res.update(k6_factor_census(ln))
        checks[f"tr_grid_backward/{name}"] = res
    got = checks["tr_grid_backward/zero_factors"]["steps_with_a_zero_factor"]
    ties = checks["tr_grid_backward/empty_texels"]["steps_at_the_tie"]
    if got < 1000 or ties < 1000:
        fail(f"K6 backward's edge batches are vacuous: {got} zero factors, "
             f"{ties} steps at the tie")


def k6_backward_bound(lanes, work, texels_written):
    """The least time of K6's backward on `lanes`: the forward's inputs of
    each live lane and its cotangent, every lane's 20 outputs and the dead
    lanes' live byte, each distinct texel read once and each texel of the
    atlas gradient written once, over the memory rate; or the forward walk's
    and the walk back's operations (K6_BWD_OPS_PER_STEP a step,
    K6_BWD_OPS_PER_LOOKUP a lookup) over the float32 rate."""
    n = lanes[1].shape[0]
    live = work["live_lanes"]
    bytes_moved = ((LANE_IN_BYTES + K6_BWD_IN_BYTES) * live + (n - live)
                   + K6_BWD_OUT_BYTES * n
                   + TEXEL_BYTES * (work["distinct_texels"] + texels_written))
    ops = (K6_BWD_OPS_PER_STEP * work["steps"]
           + K6_BWD_OPS_PER_LOOKUP * work["lookups"])
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return {**work, "texels_written": texels_written,
            "bytes_moved_at_least": bytes_moved, "ops": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def k6_backward_timing(lanes, seed):
    """K6's backward on one recorded call's lanes for a seeded cotangent:
    against its plain version, the wrapper call and the kernel alone (CUDA
    events), the plain version's call, and the bound."""
    g = k6_cotangent(lanes, seed)
    t0 = time.time()
    plain = k6_backward_plain(lanes, g)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    res = compare_k6_backward(f"tr_grid_backward/main_path/{seed}", lanes,
                              k6_backward_call(lanes, g), plain)
    lib = mtk.get_lib()
    res.update(
        kernel_ms=time_ms(lambda: k6_backward_call(lanes, g), 10),
        kernel_alone_ms=kernel_alone_ms(
            lambda lib_: k6_backward_call(lanes, g, lib=lib_), lib, reps=5),
        plain_ms=plain_ms,
        **k6_backward_bound(lanes, k6_work("tr_grid", lanes),
                            res["texels_with_gradient"]))
    return res


def k6_texels(mt, mi, p):
    """The flat atlas indices of the texels a density lookup at p reads
    (grid_density_lane's eight corners, inside the grid only)."""
    w = mt.w2m[mi]
    ph = [w[:, r, 0] * p[:, 0] + w[:, r, 1] * p[:, 1] + w[:, r, 2] * p[:, 2]
          + w[:, r, 3] for r in range(3)]
    dims = mt.dens_dims[mi].long()
    gi = [torch.floor(ph[a] * dims[:, a] - 0.5).to(torch.int64)
          for a in range(3)]
    out = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix, iy, iz = gi[0] + dx, gi[1] + dy, gi[2] + dz
                inside = ((ix >= 0) & (ix < dims[:, 0]) & (iy >= 0)
                          & (iy < dims[:, 1]) & (iz >= 0) & (iz < dims[:, 2]))
                idx = (mt.dens_off[mi].long()
                       + (iz * dims[:, 1] + iy) * dims[:, 0] + ix)
                out.append(idx[inside])
    return torch.cat(out)


def k6_work(kind, lanes):
    """What K6 has to do on `lanes`: the steps its live lanes run (to the
    step that passes t_c, or, delta tracking, the one that interacts), the
    density lookups among them, and the distinct texels those read."""
    mt, med, o, d, t_c, keys = lanes
    mi, live = k6_live(mt, med)
    inv_max_m, sig_mean_m = mmod.tracking_constants(mt)
    inv_max, sig_mean = inv_max_m[mi], sig_mean_m[mi]
    steps_n, word = ((mmod.TR_STEPS, mmod.TR_WORD) if kind == "tr_grid"
                     else (mmod.DISTANCE_STEPS, mmod.DISTANCE_WORD))
    t = torch.zeros_like(t_c)
    running = live.clone()
    steps = lookups = 0
    texels = []
    for k in range(steps_n):
        u = rng_mod.uniform_float(keys, k, word)
        t = t - torch.log(1.0 - u) * inv_max
        steps += int(running.sum())
        look = running & (t < t_c)
        lookups += int(look.sum())
        p = o + t[:, None] * d
        texels.append(k6_texels(mt, mi[look], p[look]))
        if kind == "tr_grid":
            running = look
        else:
            dens = mmod.grid_density_lane(mt, mi, p)
            real = rng_mod.uniform_float(keys, k, mmod.REAL_WORD) < (
                dens * sig_mean * inv_max)
            running = look & ~real
    return {"live_lanes": int(live.sum()), "steps": steps,
            "lookups": lookups,
            "distinct_texels": int(torch.unique(torch.cat(texels)).numel())}


def k6_bound(kind, lanes, work):
    """The least time of K6's work on `lanes`: the bytes it must move (each
    live lane's inputs, every lane's live byte and outputs, each distinct
    texel once) over the memory rate, or its operations (OPS_PER_TRACK_STEP
    a step, K6_OPS_PER_LOOKUP a density lookup and decision) over the
    float32 rate, whichever is longer."""
    n = lanes[1].shape[0]
    live = work["live_lanes"]
    bytes_moved = (LANE_IN_BYTES * live + (n - live)
                   + K6_OUT_BYTES[kind] * n
                   + TEXEL_BYTES * work["distinct_texels"])
    ops = (OPS_PER_TRACK_STEP * work["steps"]
           + K6_OPS_PER_LOOKUP[kind] * work["lookups"])
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return {**work, "bytes_moved_at_least": bytes_moved, "ops": ops,
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def k6_timing(kind, lanes, keep_plain=None):
    """Entry `kind` on `lanes`: the wrapper call and the kernel alone
    (CUDA events), the plain version's call, and the bound. `keep_plain`, a
    list, receives the plain version's output."""
    lib = mtk.get_lib()
    t0 = time.time()
    plain = k6_plain(kind, lanes)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    if keep_plain is not None:
        keep_plain.append(plain)
    return {"kernel_ms": time_ms(lambda: k6_call(kind, lanes), 10),
            "kernel_alone_ms": kernel_alone_ms(
                lambda lib_: k6_call(kind, lanes, lib=lib_), lib, reps=5),
            "plain_ms": plain_ms, **k6_bound(kind, lanes, k6_work(kind, lanes))}


@contextlib.contextmanager
def plain_tracking():
    """K6's wrappers and autograd Functions run its plain versions (the two
    loops forward, tr_grid_backward_plain backward) instead of launching it
    (for the plain-version renders and fwd+bwd; the wrappers look their
    launchers up at each call)."""
    names = ("_tr_grid", "_sample_distance_grid", "tr_grid_backward")
    saved = {k: getattr(mtk, k) for k in names}
    mtk._tr_grid = lambda mt, mi, o, d, t_c, keys, live, lib=None: (
        mmod.tr_grid_plain(mt, mi, o, d, t_c, keys))
    mtk._sample_distance_grid = (
        lambda mt, mi, o, d, t_c, keys, live, lib=None:
        mmod.sample_distance_grid_plain(mt, mi, o, d, t_c, keys))
    mtk.tr_grid_backward = (
        lambda mt, mi, o, d, t_c, keys, live, g_trg, lib=None:
        mmod.tr_grid_backward_plain(mt, mi, o, d, t_c, keys, g_trg, live))
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mtk, k, v)


def recorded_tracking(r, b):
    """Every K6 call of batch `b` of sample 0 of renderer `r`, as the lanes
    (mt, med, o, d, t_c, keys) it was handed (the main path's own shapes
    and data), by entry point."""
    calls = {k: [] for k in mtk.FORWARD}
    saved = {k: getattr(mtk, k) for k in mtk.FORWARD}

    def recorder(kind):
        def rec(mt, mi, o, d, t_c, keys, live, lib=None):
            med = torch.where(live, mi.to(torch.int32), -1)
            calls[kind].append((mt, med.contiguous(), o.detach().clone(),
                                d.detach().clone(), t_c.clone(),
                                keys.clone()))
            return saved[kind](mt, mi, o, d, t_c, keys, live, lib=lib)
        return rec
    for k in mtk.FORWARD:
        setattr(mtk, k, recorder(k))
    try:
        with torch.no_grad():
            r._step(r.new_film(), 0, b)
    finally:
        for k, v in saved.items():
            setattr(mtk, k, v)
    return calls


def k6_main_shape(r):
    """K6 on the calls of the middle batch of the fog museum's sample 0:
    each call against its plain version (every output, to K6_ULP_LIMIT),
    and per entry point the mean over its calls of the wrapper call, the
    kernel alone, the plain version and the bound; the backward on each
    tr_grid call's lanes for a seeded cotangent the same way."""
    calls = recorded_tracking(r, r.n_batches // 2)
    out = {}
    rows = [k6_backward_timing(lanes, 71 + i)
            for i, lanes in enumerate(calls["tr_grid"])]
    out["tr_grid_backward"] = {
        "calls": len(rows), "lanes": rows[0]["lanes"],
        "mean_per_call": {k: sum(row[k] for row in rows) / len(rows)
                          for k in ("kernel_ms", "kernel_alone_ms",
                                    "plain_ms", "bound_ms", "live", "steps",
                                    "lookups", "distinct_texels",
                                    "texels_written")},
        "bound_by_calls": collections.Counter(row["bound_by"]
                                              for row in rows),
        "lanes_differing": sum(row["lanes_differing"] for row in rows),
        "max_abs_err": max(row["max_abs_err"] for row in rows),
        "atlas_rel_err": max(row["atlas_rel_err"] for row in rows)}
    for kind, lanes_list in calls.items():
        if not lanes_list:
            fail(f"the fog museum's batch made no {kind} call")
        rows = []
        for i, lanes in enumerate(lanes_list):
            plain = []
            timing = k6_timing(kind, lanes, plain)
            rows.append({**compare_k6(f"{kind}/main_path/{i}", kind, lanes,
                                      k6_call(kind, lanes), plain[0]),
                         **timing})
        mean = {k: sum(row[k] for row in rows) / len(rows)
                for k in ("kernel_ms", "kernel_alone_ms", "plain_ms",
                          "bound_ms", "live", "steps", "lookups",
                          "distinct_texels")}
        out[kind] = {"calls": len(rows), "lanes": rows[0]["lanes"],
                     "mean_per_call": mean,
                     "bound_by_calls": collections.Counter(
                         row["bound_by"] for row in rows),
                     "max_ulp": max(row["max_ulp"] for row in rows),
                     "max_abs_err": max(row["max_abs_err"] for row in rows),
                     "interacted_mismatch": sum(
                         row["interacted_mismatch"] for row in rows)}
    return out


def media(dev, static_museum, fog, with_profile) -> dict:
    """The media phase: tools/testscenes.py `spectral_museum` (upload with
    spectral=True: 60-bin transport under the path integrator) and
    `fog_museum` (volpath: a homogeneous room fog, a FOG_GRID_RES^3 grid
    plume behind a null-material interface box, a tinted glass statue) at
    MUSEUM_65K's size, SPP_MEDIA samples each at MAIN_RES with the launch
    counts set to 0 just before and read just after: the spectral museum
    through K1 beside `static_museum` = (scene, tables) rendered in this
    phase, the fog museum through K1 and K6 (volpath's 10 iterations a
    batch: a closest hit and four shadow segments, one delta-tracking and
    four ratio-tracking calls each); each against the plain versions on
    PLAIN_CROP; K6 at the main path's shapes (the middle batch's calls);
    one fwd+bwd sample of each, the film linear in light_L. `fog` = (scene,
    tables, host seconds) from the kernels phase."""
    sc65, tables65 = static_museum
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = testscenes.spectral_museum(tmp, **MUSEUM_65K)
        sc_spec = flatten(parse_file(path), tmp)
    tables_s = upload(sc_spec, light_strategy=sc_spec.integrator.light_strategy,
                      device=dev, spectral=True)
    torch.cuda.synchronize()
    t_spec = time.time() - t0
    if tables_s[1].n_channels != 60 or tables_s[1].n_media:
        fail(f"the spectral museum's tables are not what it asks for: "
             f"{tables_s[1]}")
    r = Renderer(sc_spec, device=dev, tables=tables_s)
    film, ms_s, counts_s = drive(r, {"traverse_wide": 1}, SPP_MEDIA)
    fin_s, lum_s = check_image(r, film, "spectral_museum")
    img_s = r.image(film)
    del film
    r_static = Renderer(sc65, device=dev, tables=tables65)
    _, ms_static, _ = drive(r_static, {"traverse_wide": 1}, 1)
    del r_static
    plain_s = against_plain_render(sc_spec, tables_s, "traverse_wide", dev,
                                   crop=PLAIN_CROP)
    grads_s = emitter_grads(grad_renderer(sc_spec, tables_s, dev),
                            {k: getattr(tables_s[0], k)
                             for k in GRAD_PARAMS}, 1, ("light_L",),
                            LINEARITY_RTOL, "spectral")
    del r

    scene, tables, fog_host_s = fog
    ds, st = tables
    iters = scene.integrator.max_depth + 1 + 4
    per_batch = {"traverse_wide": 5 * iters, "sample_distance_grid": iters,
                 "tr_grid": 4 * iters}
    r = Renderer(scene, device=dev, tables=tables)
    film, ms_f, counts_f = drive(
        r, {k: v / (5 * iters) for k, v in per_batch.items()}, SPP_MEDIA,
        calls_per_vertex=5, vertices=iters)
    fin_f, lum_f = check_image(r, film, "fog_museum")
    img_f = r.image(film)
    del film
    main_shape = k6_main_shape(r)
    t0 = time.time()
    crop_scene = dataclasses.replace(
        scene, film=dataclasses.replace(scene.film, crop=PLAIN_CROP))
    before = launch_counts()
    rk = Renderer(crop_scene, device=dev, tables=tables)
    img_k = rk.image(rk.render(spp=1))
    ran = {k: launch_counts()[k] - before[k] for k in per_batch}
    if min(ran.values()) <= 0:
        fail(f"the fog museum's cropped render missed a kernel: {ran}")
    with plain_tracking():
        rp = Renderer(crop_scene, device=dev, tables=tables,
                      isect=plain_traversal("traverse_wide"))
        img_p = rp.image(rp.render(spp=1))
    torch.cuda.synchronize()
    rel_f = mean_rel(img_k, img_p)
    if not rel_f <= 1e-4 or not float(img_p.mean()) > 0.0:
        fail(f"the fog museum's render differs from its plain-version "
             f"render: rel {rel_f}")
    plain_f = {"plain_render_s": round(time.time() - t0, 1),
               "plain_render_crop": PLAIN_CROP,
               "plain_vs_kernel_mean_rel": rel_f,
               "plain_vs_kernel_max_pixel_abs": float(
                   np.abs(img_k - img_p).max())}
    del rk, rp
    # pass 2 of value_and_grad replays traversal from pass 1's record but
    # runs the shading chain again, K6 with it: twice a batch; K6's
    # backward once a tr_grid call of pass 2
    grads_f = emitter_grads(
        grad_renderer(scene, tables, dev),
        {k: getattr(ds, k) for k in MEDIA_PARAMS}, 1, ("light_L",),
        LINEARITY_RTOL, "fog", per_batch={
            **{k: v * (1 if k == "traverse_wide" else 2)
               for k, v in per_batch.items()},
            "tr_grid_backward": per_batch["tr_grid"]})
    grads_f.update(fog_grads_against_plain(scene, tables, dev))
    # the same fwd+bwd without the medium tables (K6's forward only), in
    # this run: what differentiating the media costs
    without = emitter_grads(
        grad_renderer(scene, tables, dev),
        {k: getattr(ds, k) for k in ("mat_kd", "light_L")}, 1, ("light_L",),
        LINEARITY_RTOL, "fog without medium tables", per_batch={
            k: v * (1 if k == "traverse_wide" else 2)
            for k, v in per_batch.items()})
    grads_f["without_medium_tables"] = {
        k: without[k] for k in ("params", "fwd_bwd_ms_per_spp",
                                "peak_allocated_bytes", "launches")}
    profiled = ({"profile_fog_spp": profile_one_spp(lambda: r.render(spp=1))}
                if with_profile else {})
    batches = r.n_batches
    del r
    return {
        "spectral_museum": {
            "scene": "tools/testscenes.py spectral_museum", **MUSEUM_65K,
            "n_channels": tables_s[1].n_channels,
            "write_flatten_upload_s": round(t_spec, 2),
            "resolution": [MAIN_RES, MAIN_RES],
            "max_depth": sc_spec.integrator.max_depth, "spp": SPP_MEDIA,
            "ms_per_spp": ms_s,
            "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_s * 1e-3),
            "static_museum_ms_per_spp": ms_static, "launches": counts_s,
            "finite_pixel_share": fin_s, "mean_luminance": lum_s,
            "image_mean_rgb": [float(x) for x in img_s.reshape(-1, 3).mean(0)],
            **plain_s, "gradients": grads_s},
        "fog_museum": {
            "scene": "tools/testscenes.py fog_museum", **MUSEUM_65K,
            "grid_res": FOG_GRID_RES, "media": scene.media_order,
            "camera_medium": st.camera_medium,
            "any_grid_media": st.any_grid_media,
            "has_med_interfaces": st.has_med_interfaces,
            "triangles": st.n_tris, "host_s": fog_host_s,
            "resolution": [MAIN_RES, MAIN_RES],
            "max_depth": scene.integrator.max_depth, "iterations": iters,
            "spp": SPP_MEDIA, "batches": batches, "ms_per_spp": ms_f,
            "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_f * 1e-3),
            "launches": counts_f,
            "launches_expected_per_batch": per_batch,
            "finite_pixel_share": fin_f, "mean_luminance": lum_f,
            "image_mean_rgb": [float(x) for x in img_f.reshape(-1, 3).mean(0)],
            **plain_f, "k6_at_main_shape": main_shape,
            "gradients": grads_f, **profiled}}


def fog_grads_against_plain(scene, tables, dev) -> dict:
    """value_and_grad of `bench_loss` over PLAIN_CROP of the fog museum with
    respect to MEDIA_PARAMS through K1 and K6 (its backward too) and
    through their plain versions, on the same tables: per table the
    largest difference over the largest gradient, held to GRAD_VS_PLAIN
    (the film's and the atlas's atomics sum in no fixed order)."""
    crop = dataclasses.replace(
        scene, film=dataclasses.replace(scene.film, crop=PLAIN_CROP))
    kinds = ("traverse_wide", "tr_grid", "sample_distance_grid",
             "tr_grid_backward")
    out = {}
    for name in ("kernel", "plain"):
        before = launch_counts()
        t0 = time.time()
        with plain_tracking() if name == "plain" else contextlib.nullcontext():
            r = Renderer(crop, device=dev, tables=tables,
                         isect=(plain_traversal("traverse_wide")
                                if name == "plain" else None))
            out[name] = r.value_and_grad(
                bench_loss, {k: getattr(r.ds, k) for k in MEDIA_PARAMS})
        torch.cuda.synchronize()
        out[name + "_s"] = time.time() - t0
        ran = {k: launch_counts()[k] - before[k] for k in kinds}
        if (min(ran.values()) > 0) != (name == "kernel") or (
                name == "plain" and max(ran.values()) > 0):
            fail(f"the fog museum's cropped value_and_grad through the "
                 f"{name} versions launched {ran}")
        out[name + "_launches"] = ran
    (vk, gk, _), (vp, gp, _) = out["kernel"], out["plain"]
    rel = {k: float((gk[k] - gp[k]).abs().max()
                    / gp[k].abs().max().clamp_min(1e-30)) for k in gp}
    if not max(rel.values()) <= GRAD_VS_PLAIN:
        fail(f"the fog museum's gradients through the kernels differ from "
             f"those through the plain versions: {rel}")
    return {"crop": PLAIN_CROP, "crop_loss_kernel": float(vk),
            "crop_loss_plain": float(vp),
            "crop_grad_max_rel_kernel_vs_plain": rel,
            "crop_grad_rel_bound": GRAD_VS_PLAIN,
            "crop_launches": out["kernel_launches"],
            "crop_plain_fwd_bwd_s": round(out["plain_s"], 1)}


def integrator_grads(static_museum, dev, name, k1_calls) -> dict:
    """value_and_grad of sum(film.rgb) + sum(film.splat) with respect to
    GRAD_PARAMS, the small museum at INTEGRATOR_GRAD_RES under integrator
    `name` (direct lighting with one light a vertex), K1 launched `k1_calls`
    times a batch (pass 1; pass 2 replays) and nothing else; every gradient
    finite, sum(light_L * g) = loss (AO: every gradient 0, its image reads
    no table)."""
    sc, t = at_resolution_scene(*static_museum, INTEGRATOR_GRAD_RES)
    extra = {"strategy": "one"} if name == "directlighting" else {}
    sc = dataclasses.replace(sc, integrator=dataclasses.replace(
        sc.integrator, name=name, **extra))
    r = Renderer(sc, device=dev, tables=t)
    params = {k: getattr(r.ds, k) for k in GRAD_PARAMS}
    (value, grads, _), sec, counts, peak = counted(
        lambda: r.value_and_grad(lambda f: f.rgb.sum() + f.splat.sum(),
                                 params), k1_calls * r.n_batches)
    v = float(value)
    lin = float((grads["light_L"] * params["light_L"]).sum())
    for k, g in grads.items():
        if not bool(torch.isfinite(g).all()):
            fail(f"{name} gradients: d loss / d {k} is not finite")
    if name == "ambientocclusion":
        if any(bool(g.any()) for g in grads.values()):
            fail("ambient occlusion's gradients are not 0")
    elif not (abs(lin - v) <= LINEARITY_RTOL * abs(v)
              and float(grads["mat_kd"].abs().max()) > 0):
        fail(f"{name} gradients: sum(light_L * g) = {lin}, loss {v}, "
             f"mat_kd's largest {float(grads['mat_kd'].abs().max())}")
    return {"resolution": [INTEGRATOR_GRAD_RES] * 2, "params": GRAD_PARAMS,
            "loss": "sum(film.rgb) + sum(film.splat)",
            "fwd_bwd_ms_per_spp": sec * 1e3, "launches": counts, **peak,
            "value": v, "sum_light_L_times_grad": lin,
            "linearity_rtol": LINEARITY_RTOL,
            "grad_abs_max": {k: float(g.abs().max())
                             for k, g in grads.items()}}


def checking_wide(tag, calls):
    """K1's wrapper, each call run beside the plain walker on the same
    inputs and held to the bit (valid, prim; t, b1, b2, p_obj of the hits;
    the counters when the caller asks for them); fails the run otherwise.
    Appends one record a call to `calls`."""
    plain = plain_traversal("traverse_wide")

    def isect(ds_, st_, o_, d_, tmax_, any_hit=False, with_stats=True, **kw):
        out = tw.intersect_wide_cuda(ds_, st_, o_, d_, tmax_, any_hit=any_hit,
                                     with_stats=with_stats, **kw)
        ref = plain(ds_, st_, o_, d_, tmax_, any_hit=any_hit, **kw)
        (hk, sk), (hp, sp) = out, ref
        hit = hp.valid & hk.valid
        names = ["valid", "prim"] + [f"{f}_of_hits" for f in
                                     ("t", "b1", "b2", "p_obj")]
        kern = [hk.valid, hk.prim] + [getattr(hk, f)[hit] for f in
                                      ("t", "b1", "b2", "p_obj")]
        pl = [hp.valid, hp.prim] + [getattr(hp, f)[hit] for f in
                                    ("t", "b1", "b2", "p_obj")]
        if with_stats:
            names += list(trav.TraversalStats._fields)
            kern += list(sk)
            pl += list(sp)
        err = check_bits(f"{tag}/call {len(calls)}", names, kern, pl)
        calls.append({"any_hit": any_hit, "rays": int(o_.shape[0]),
                      "live": int((tmax_ > 0).sum()), "max_abs_err": err})
        return out
    return isect


def counted(fn, per_call_k1: int):
    """Run `fn` with the launch counts set to 0 just before and read just
    after, timed on the host's clock around a device sync; fails the run
    unless K1 launched `per_call_k1` times and no other kernel launched.
    Returns (fn's result, seconds, launches, {peak allocated bytes, bytes
    allocated before})."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    sec = time.time() - t0
    counts = launch_counts()
    check_stack_depths()
    for k, c in counts.items():
        want = per_call_k1 if k == "traverse_wide" else 0
        if c != want:
            fail(f"integrators phase launched {k} {c} times, expected {want}")
    return out, sec, counts, {
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "allocated_bytes_before": before}


def image_stats(img, tag):
    if img.shape != (MAIN_RES, MAIN_RES, 3):
        fail(f"{tag}: image shape {img.shape}")
    finite_share = float(np.isfinite(img).all(-1).mean())
    mean_lum = float((img @ np.array([0.212671, 0.715160, 0.072169])).mean())
    if finite_share != 1.0 or not mean_lum > 0.0:
        fail(f"{tag}: finite share {finite_share}, mean luminance {mean_lum}")
    return {"finite_pixel_share": finite_share, "mean_luminance": mean_lum}


def integrators(dev, static_museum) -> dict:
    """The integrators phase: the small museum (`static_museum` = (scene,
    tables), single-level tables: K1) at MAIN_RES and depth 5 under each of
    INTEGRATORS (1 spp), MLT (one batch of bootstrap paths a depth,
    MLT_MUTATIONS mutations a pixel) and SPPM (SPPM_ITERATIONS iterations,
    one photon a pixel), each through its user entry point (`Renderer.
    render` / `image`, `MLTRenderer.render`, `SPPMRenderer.render`) with
    the launch counts set to 0 just before and read just after, its K1
    launches held to the count its loops make. Before them, every K1 call
    of one BDPT batch, one MLT mutation step and one SPPM photon chunk runs
    through `checking_wide` (bit for bit against the plain walker)."""
    from tpupt_torch.integrators.mlt import MLTRenderer
    from tpupt_torch.integrators.sppm import SPPMRenderer

    sc65, tables65 = static_museum
    depth = sc65.integrator.max_depth
    n_lights = tables65[1].n_lights
    out = {"scene": "tools/genscene.py museum", **MUSEUM_65K,
           "triangles": tables65[1].n_tris, "lights": n_lights,
           "resolution": [MAIN_RES, MAIN_RES], "max_depth": depth}
    t_phase = time.time()

    def renderer(name, **integ):
        sc = dataclasses.replace(sc65, integrator=dataclasses.replace(
            sc65.integrator, name=name, **integ))
        return Renderer(sc, device=dev, tables=tables65)

    # K1 calls a batch: a direct-lighting vertex makes a closest hit, and a
    # shadow ray and a BSDF-sampled ray for its one light (Whitted: for each
    # light); AO a closest hit and
    # 16 occlusion rays; BDPT 2D + 1 walk steps and D (s == 1) +
    # (D - 1) D / 2 (s >= 2) + D (t == 1) connections
    bdpt_calls = (2 * depth + 1) + depth + (depth - 1) * depth // 2 + depth
    calls = {"directlighting": depth * (1 + 2),
             "whitted": depth * (1 + 2 * n_lights),
             "ambientocclusion": 1 + 16, "bdpt": bdpt_calls}
    checked = {}
    for name in INTEGRATORS:
        r = renderer(name, strategy="one") if name == "directlighting" \
            else renderer(name)
        if name == "bdpt":
            # every K1 call of the middle batch, against the plain walker
            rec = []
            r._isect = checking_wide("integrators/bdpt", rec)
            with torch.no_grad():
                r._step(r.new_film(), 0, r.n_batches // 2)
            r._isect = tw.intersect_wide_cuda
            if len(rec) != bdpt_calls:
                fail(f"the checked BDPT batch made {len(rec)} K1 calls, "
                     f"expected {bdpt_calls}")
            checked["bdpt_batch"] = rec
        else:
            warm_up(r)
        film, sec, counts, peak = counted(
            lambda: r.render(spp=1), calls[name] * r.n_batches)
        img = r.image(film)
        out[name] = {"ms_per_spp": sec * 1e3, "launches": counts,
                     "k1_calls_per_batch": calls[name], **peak,
                     **image_stats(img, name),
                     **({"splat_sum": float(film.splat.sum())}
                        if name == "bdpt" else {})}
        del film, r
        out[name]["gradients"] = integrator_grads(static_museum, dev, name,
                                                  calls[name])

    # ---- MLT: one mutation step through the checking isect, then the
    # render (the bootstrap: one batch a depth)
    r = renderer("mlt")
    mr = MLTRenderer(r, n_bootstrap=r.batch * (depth + 1))
    rec = []
    with torch.no_grad():
        gen = np.random.default_rng(1)
        u = torch.from_numpy(gen.random((mr.n, mr.n_dims),
                                        np.float32)).to(dev)
        dep = torch.from_numpy(gen.integers(0, depth + 1, mr.n)
                               .astype(np.int32)).to(dev)
        L0, pr0 = mr.eval_path(u, dep)
        r._isect = checking_wide("integrators/mlt_step", rec)
        mr.step(u, dep, L0, pr0, torch.zeros((MAIN_RES * MAIN_RES, 3),
                                             device=dev), 12345)
        r._isect = tw.intersect_wide_cuda
    if len(rec) != bdpt_calls:
        fail(f"the checked MLT step made {len(rec)} K1 calls, expected "
             f"{bdpt_calls}")
    checked["mlt_step"] = rec
    n_steps = max(MLT_MUTATIONS * MAIN_RES * MAIN_RES // mr.n, 1)
    evals = (depth + 1) * (mr.n_bootstrap // mr.n) + 1 + n_steps
    img, sec, counts, peak = counted(
        lambda: mr.render(mutations_per_pixel=MLT_MUTATIONS),
        evals * bdpt_calls)
    out["mlt"] = {"s": sec, "bootstrap_s": mr.seconds["bootstrap"],
                  "chains_s": mr.seconds["chains"], "steps": n_steps,
                  "s_per_step": mr.seconds["chains"] / n_steps,
                  "chains": mr.n, "bootstrap_per_depth": mr.n_bootstrap,
                  "mutations_per_pixel": MLT_MUTATIONS, "b": mr.b,
                  "launches": counts, "k1_calls_per_eval": bdpt_calls,
                  "evals": evals, **peak,
                  **image_stats(img, "mlt")}
    del mr, r

    # ---- SPPM: one photon chunk through the checking isect, then the
    # render
    r = renderer("sppm")
    sr = SPPMRenderer(r)
    rec = []
    with torch.no_grad():
        vp = sr.camera_pass(0)
        radius = torch.full((sr.npix_pad,), sr.r0, device=dev)
        cell = torch.amax(radius) * 1.0001
        n_photons = sr.n_photons
        sr.n_photons = r.batch
        r._isect = checking_wide("integrators/sppm_photon_chunk", rec)
        sr.photon_pass(0, vp, radius, r.ds.world_lo - 2 * cell, cell)
        r._isect = tw.intersect_wide_cuda
        sr.n_photons = n_photons
        del vp
    if len(rec) != depth:
        fail(f"the checked SPPM photon chunk made {len(rec)} K1 calls, "
             f"expected {depth}")
    checked["sppm_photon_chunk"] = rec
    chunks = -(-sr.n_photons // r.batch)
    sppm_calls = SPPM_ITERATIONS * (2 * depth * r.n_batches + depth * chunks)
    img, sec, counts, peak = counted(
        lambda: sr.render(n_iterations=SPPM_ITERATIONS), sppm_calls)
    out["sppm"] = {"s": sec, "s_per_iteration": sec / SPPM_ITERATIONS,
                   "iterations": SPPM_ITERATIONS,
                   "photons_per_iteration": sr.n_photons,
                   "photon_chunks": chunks, "overflow": sr.overflow,
                   "launches": counts, **peak,
                   **image_stats(img, "sppm")}
    del sr, r
    out["checked_k1_calls"] = {
        k: {"calls": len(v), "any_hit_calls": sum(c["any_hit"] for c in v),
            "rays": v[0]["rays"], "live_rays": sum(c["live"] for c in v),
            "max_abs_err": max(c["max_abs_err"] for c in v)}
        for k, v in checked.items()}
    out["phase_s"] = round(time.time() - t_phase, 1)
    return out



def grad_renderer(scene, tables, dev):
    """A renderer of (scene, tables) at GRAD_RES x GRAD_RES."""
    sc, t = at_resolution_scene(scene, tables, GRAD_RES)
    return Renderer(sc, device=dev, tables=t)


def at_resolution_scene(scene, tables, res):
    """(scene, tables) at res x res pixels."""
    scene = with_resolution(scene, res, res)
    return scene, at_resolution(tables, scene)


def at_resolution(tables, scene):
    """`tables` with the raster-to-camera matrix of `scene` (the same
    scene at another resolution: nothing else of the tables depends on
    it)."""
    ds, st = tables
    r2c = torch.from_numpy(scene.camera.raster_to_camera).to(
        ds.raster_to_camera.device)
    return ds._replace(raster_to_camera=r2c), st


def film_on_cpu(film) -> dict:
    return {k: v.cpu() for k, v in film._asdict().items()}


def k1_only(counts, want, tag):
    """Fails unless K1 launched `want` times and no other kernel did."""
    for k, c in counts.items():
        if c != (want if k == "traverse_wide" else 0):
            fail(f"{tag} launched {k} {c} times, expected "
                 f"{want if k == 'traverse_wide' else 0}")


def film_batches(scene) -> int:
    n = scene.film.xres * scene.film.yres
    return -(-n // mesh_mod.sharded_batch(n, 2))


def mesh_rank(m, sc65, fields, statics, sc_bdpt, sc_train, target):
    """One of the mesh phase's two ranks (a spawned process bound to the
    same card, gloo): the small museum at MAIN_RES, BDPT at MESH_RES and
    one training step at MESH_RES, each through `parallel.mesh` with the
    launch counts set to 0 just before and read just after. Returns the
    films and the step on the CPU with this rank's seconds and launches."""
    import torch.distributed as dist

    tables = from_numpy(fields, statics, device=m.device)
    tables_small = at_resolution(tables, sc_bdpt)
    out = {}
    r = Renderer(sc65, device=m.device, tables=tables, collect_stats=True)
    sr = mesh_mod.ShardedRenderer(sc65, m, base=r)
    with torch.no_grad():
        r._step(r.new_film(), 0, sr.batches[0])
    for name, renderer in (("museum", sr), ("bdpt", None)):
        if renderer is None:
            renderer = mesh_mod.ShardedRenderer(sc_bdpt, m, base=Renderer(
                sc_bdpt, device=m.device, tables=tables_small))
        dist.barrier(group=m.group)
        zero_launches()
        t0 = time.time()
        film = renderer.render(spp=1)
        mesh_mod._sync(m.device)
        out[name] = {"film": film_on_cpu(film), "s": time.time() - t0,
                     "launches": launch_counts(),
                     "batches": renderer.batches, "batch": renderer.batch}
        check_stack_depths()
    step, p0 = train_step_fn(sc_train, m, target, tables=tables_small)
    dist.barrier(group=m.group)
    zero_launches()
    t0 = time.time()
    loss, new = step({k: p0[k] for k in GRAD_PARAMS}, 0, MESH_TRAIN_LR)
    mesh_mod._sync(m.device)
    out["train"] = {"loss": float(loss), "s": time.time() - t0,
                    "new": {k: v.cpu() for k, v in new.items()},
                    "launches": launch_counts()}
    return out


def films_equal(a: dict, b, tag, splat_rel=None) -> dict:
    """Fails unless film `a` (fields on the CPU) equals one process's film
    `b`: rgb / weight / aov to the bit on every pixel that took at most two
    samples (a sum of two is the same in either order), and within
    MESH_ORDER_RTOL of b on the others, whose three or four samples the
    card's index_add sums in no fixed order (two renders of one process
    differ there too); the splats to the bit, or within `splat_rel` of the
    largest splat."""
    few = b.weight.cpu() <= 2
    out = {"pixels_of_three_or_four_samples": int((~few).sum())}
    for k in ("rgb", "weight", "aov"):
        x, y = a[k], getattr(b, k).cpu()
        mask = few if x.dim() == 1 else few[:, None]
        if not torch.equal(torch.where(mask, x, 0.0),
                           torch.where(mask, y, 0.0)):
            fail(f"{tag}: {k} differs from one process's film on a pixel of "
                 f"at most two samples")
        err = (x - y).abs()
        if not bool((err <= MESH_ORDER_RTOL * y.abs()).all()):
            fail(f"{tag}: {k} differs from one process's film by "
                 f"{float(err.max())}")
        diff = x != y
        out[f"{k}_pixels_differing"] = int(
            (diff if diff.dim() == 1 else diff.any(-1)).sum())
        out[f"{k}_max_abs_err"] = float(err.max())
    ref = b.splat.cpu()
    err = float((a["splat"] - ref).abs().max())
    scale = float(ref.abs().max())
    if splat_rel is None and err != 0.0:
        fail(f"{tag}: splat differs by {err}")
    if splat_rel is not None and not err <= splat_rel * scale:
        fail(f"{tag}: splat differs by {err}, largest {scale}")
    return {**out, "splat_max_abs_err": err, "splat_largest": scale}


def mesh(dev, static_museum, film65) -> dict:
    """The mesh phase: `parallel/mesh.py` on this one card. Two ranks
    spawned over gloo (two NCCL ranks cannot share a card) render the small
    museum at MAIN_RES, BDPT at MESH_RES and take one training step, each
    rank launching its own half of the batches; meanwhile this process
    runs bsdftest's eight materials on the card and on the CPU and the
    one-process references. Then a one-rank NCCL job renders the museum
    through `ShardedRenderer` (all_reduce over NCCL) against `film65`, the
    main path's render. A failing rank makes `spawn` raise, which fails
    the run."""
    import torch.distributed as dist

    sc65, tables65 = static_museum
    t_phase = time.time()
    depth = sc65.integrator.max_depth
    sc_train = with_resolution(sc65, MESH_RES, MESH_RES)
    sc_bdpt = dataclasses.replace(sc_train, integrator=dataclasses.replace(
        sc_train.integrator, name="bdpt"))
    tables_small = at_resolution(tables65, sc_train)
    target_r = Renderer(sc_train, device=dev, tables=(
        tables_small[0]._replace(mat_kd=tables_small[0].mat_kd * 0.5),
        tables_small[1]))
    target = target_r.image(target_r.render(spp=1))
    del target_r
    fields = {k: v.cpu().numpy() for k, v in tables65[0]._asdict().items()
              if v is not None}
    statics = dict(tables65[1]._asdict())
    out = {"scene": "tools/genscene.py museum", **MUSEUM_65K,
           "resolution": [MAIN_RES, MAIN_RES], "small_resolution": MESH_RES}
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(mesh_mod.spawn, mesh_rank, 2, (
            sc65, fields, statics, sc_bdpt, sc_train, target), device=dev,
            backend="gloo", timeout_s=MESH_TIMEOUT_S)
        # bsdftest on the card against the CPU
        t1 = time.time()
        bsdf = {}
        for mat in bsdftest.MATERIALS:
            card = bsdftest.run(mat, BSDF_SAMPLES, 30.0, 0.2, device=dev)
            cpu = bsdftest.run(mat, BSDF_SAMPLES, 30.0, 0.2, device="cpu")
            rel = max(abs(a - b) / abs(b) for k in ("rho_sampled",
                                                   "rho_uniform")
                      for a, b in zip(card[k], cpu[k]))
            verdict = bsdftest.consistent(card)
            # uber's specular transmission is a delta lobe the uniform
            # estimate cannot see: MISMATCH in both packages
            if (not rel <= BSDF_RHO_RTOL or verdict != bsdftest.consistent(cpu)
                    or verdict != (mat != "uber")
                    or card["dof"] != cpu["dof"]):
                fail(f"bsdftest {mat} on the card: rho rel {rel}, "
                     f"{verdict} / {bsdftest.consistent(cpu)}, dof "
                     f"{card['dof']} / {cpu['dof']}")
            bsdf[mat] = {"verdict": "CONSISTENT" if verdict else "MISMATCH",
                         "rho_sampled": card["rho_sampled"],
                         "rho_uniform": card["rho_uniform"],
                         "rho_max_rel_to_cpu": rel, "chi2": card["chi2"],
                         "chi2_cpu": cpu["chi2"], "dof": card["dof"]}
        out["bsdftest"] = {"samples": BSDF_SAMPLES, "theta_deg": 30.0,
                           "roughness": 0.2, "rho_rtol": BSDF_RHO_RTOL,
                           "s": time.time() - t1, "materials": bsdf}
        # one process at the ranks' batch
        rb = Renderer(sc_bdpt, device=dev, tables=tables_small)
        rb.set_batch(mesh_mod.sharded_batch(rb.n_pixels, 2))
        film_bdpt = rb.render(spp=1)
        step1, p0 = train_step_fn(sc_train, None, target, device=dev,
                                  tables=tables_small)
        loss1, new1 = step1({k: p0[k] for k in GRAD_PARAMS}, 0,
                            MESH_TRAIN_LR)
        got = ranks.result()
    spawn_s = time.time() - t0
    for tag in ("museum", "bdpt"):
        for k, v in got[0][tag]["film"].items():
            if not torch.equal(v, got[1][tag]["film"][k]):
                fail(f"mesh {tag}: the ranks' films differ in {k}")
    per_batch = {"museum": 2 * (depth + 1),
                 "bdpt": (2 * depth + 1) + depth + (depth - 1) * depth // 2
                 + depth}
    two = {"what": "two ranks sharing one card (gloo): not a scaling figure"}
    for tag in ("museum", "bdpt"):
        for r_ in got:
            k1_only(r_[tag]["launches"],
                    per_batch[tag] * len(r_[tag]["batches"]), f"mesh {tag}")
        two[tag] = {"batch": got[0][tag]["batch"],
                    "batches_per_rank": [r_[tag]["batches"] for r_ in got],
                    "ms_per_spp_per_rank": [r_[tag]["s"] * 1e3 for r_ in got],
                    "k1_launches_per_rank": [
                        r_[tag]["launches"]["traverse_wide"] for r_ in got]}
    half = per_batch["museum"] * film_batches(sc65) // 2
    if two["museum"]["k1_launches_per_rank"] != [half, half]:
        fail(f"each rank should launch half of a sample's {2 * half} K1 "
             f"calls: {two['museum']['k1_launches_per_rank']}")
    two["museum"].update(films_equal(got[0]["museum"]["film"], film65,
                                     "mesh museum, two ranks"))
    two["bdpt"].update(films_equal(got[0]["bdpt"]["film"], film_bdpt,
                                   "mesh bdpt, two ranks", MESH_SPLAT_REL))
    two["bdpt"]["splat_rel_bound"] = MESH_SPLAT_REL
    losses = [r_["train"]["loss"] for r_ in got]
    news = [r_["train"]["new"] for r_ in got]
    if losses[0] != losses[1] or any(
            not torch.equal(news[0][k], news[1][k]) for k in GRAD_PARAMS):
        fail(f"mesh train: the ranks' steps differ: {losses}")
    loss_rel = abs(losses[0] - float(loss1)) / abs(float(loss1))
    step_err = {}
    for k in GRAD_PARAMS:
        p = p0[k].cpu()
        d_ref = (p - new1[k].cpu()) / MESH_TRAIN_LR
        d_got = (p - got[0]["train"]["new"][k]) / MESH_TRAIN_LR
        ulp = float(np.spacing(np.abs(p.numpy())).max()) / MESH_TRAIN_LR
        err = float((d_got - d_ref).abs().max())
        scale = float(d_ref.abs().max())
        if not err <= MESH_STEP_REL * scale + ulp:
            fail(f"mesh train {k}: step differs by {err}, largest {scale}")
        step_err[k] = {"max_abs_err": err, "largest": scale}
    if not (np.isfinite(losses[0]) and loss_rel <= MESH_LOSS_RTOL):
        fail(f"mesh train: loss {losses[0]} against one process's "
             f"{float(loss1)}")
    # MESH_RES^2 pixels in two batches: one forward batch a rank
    for r_ in got:
        k1_only(r_["train"]["launches"], per_batch["museum"], "mesh train")
    two["train"] = {"params": GRAD_PARAMS, "lr": MESH_TRAIN_LR,
                    "loss": losses[0], "loss_one_process": float(loss1),
                    "loss_rel": loss_rel, "step_vs_one_process": step_err,
                    "ms_per_rank": [r_["train"]["s"] * 1e3 for r_ in got],
                    "k1_launches_per_rank": [
                        r_["train"]["launches"]["traverse_wide"]
                        for r_ in got]}
    two["spawn_and_references_s"] = spawn_s
    out["two_ranks_gloo"] = two
    del got, film_bdpt, rb

    # one rank over NCCL, alone on the card
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        mesh_mod.init_distributed("file://" + os.path.join(tmp, "rdv"), 1,
                                  0, device=dev)
        # NCCL sets its communicator up at the first collective
        dist.all_reduce(torch.zeros(1, device=dev))
        mesh_mod._sync(torch.device(dev))
        init_s = time.time() - t0
        try:
            m = mesh_mod.make_mesh()
            r = Renderer(sc65, device=dev, tables=tables65,
                         collect_stats=True)
            sr = mesh_mod.ShardedRenderer(sc65, m, base=r)
            warm_up(r)
            zero_launches()
            t0 = time.time()
            film = sr.render(spp=1)
            mesh_mod._sync(torch.device(dev))
            ms = (time.time() - t0) * 1e3
            counts = launch_counts()
            backend = dist.get_backend(m.group)
        finally:
            dist.destroy_process_group()
    k1_only(counts, per_batch["museum"] * r.n_batches, "mesh one rank")
    out["one_rank_nccl"] = {
        "backend": backend, "init_s": init_s, "ms_per_spp": ms,
        "launches": counts, "batches": sr.batches,
        **films_equal(film_on_cpu(film), film65, "mesh museum, one rank")}
    out["phase_s"] = round(time.time() - t_phase, 1)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
