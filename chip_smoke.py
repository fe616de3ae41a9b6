#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the keyframe map path in
float32 and in bfloat16 (the JAX package's deployed dtype), the dense
coarse tracker tracking against the TSDF model, the SLAM loop (also at
640x480 with preset=runtime), the C image decoder, tandem_demo with its
recorder and the debug logs, sinks and 3D viewer, the sensor-depth paths
(RGB-D tracking with dvo's dense tracker, the TSDF raycast through
dr_debug_example), the training half (tandem_train, tandem_eval), the
deployable unit (tandem_export's model.pt2, served by tandem_dataset) and
the multi-card paths on the one card (view shards, data-parallel ranks,
tandem_train TRAIN.DEVICE mesh).

    python3 chip_smoke.py                    # from the root of a checkout
    python3 chip_smoke.py --profile-dir DIR  # + a torch.profiler table of
                                             #   one keyframe per dtype (and
                                             #   its device events) and of
                                             #   one track_frame at 640x480,
                                             #   traces in DIR

Phases, each printing its numbers before the last line:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels of tandem_tpu_torch/csrc/ (one nvcc
              per source, in parallel) and print ptxas's register report;
  3. kernels  each hand kernel against its plain PyTorch version on the
              card, exact (torch.equal), with both times: the edge filter
              edge_filter (csrc/edge_kth.cu: K1's selection, an exact
              radix-select threshold, mask and zeroing) at 480x640,
              120x160, 240x320, 192x256 and 61x83, B = 1 and 3, five depth
              cases, k = 0, N-1 and the 10% discard, its threshold equal
              to torch.kthvalue, with the CUDA event and profiler device
              times of the op, K1 alone, the composition it replaced (K1,
              torch.kthvalue, two wheres) and torch.kthvalue alone;
              P5 bilinear_index and P3 corner_blend in f32 and bf16 at
              the three stage shapes of abl04 640x480; the plane-sweep
              sample bilinear_sample (csrc/bilinear_sample.cu) at the same
              six points: warp_sample on the golden pack's view 0 <- 1
              sweep (and with the source camera in front of the near
              hypotheses, so part of the sweep lies behind it), and
              bilinear_sample on given positions, with its CUDA event and
              profiler device times, its bound, the old path (positions,
              pack_corners, P5, P3) and grid_sample on the same positions
              by events (and by the profiler at stage 1 bf16, the kernel's
              row in the result), and the wrapper's host cost per call; both
              modes exact also at the slam phase's 256x192 stage shapes;
              the sample's backward kernel warp_sample_grad (the same
              source) at the six abl04 points with B = 2 as training
              gives it (the golden sweep with part of it behind the
              source camera, and without): each item's float32 sums
              within GRAD_TOL of its largest |gradient| of the plain
              gradient in float64, with its event and profiler device
              times, its byte bound, grid_sample's backward on the
              same grid, the samples a touched cell and its atomics;
              row_gather, also at P4's shape; the variance cost volume's
              step warp_variance (the same source) at CasMVSNet's three
              DTU stages (1152x864: 48x216x288x32, 32x432x576x16,
              8x864x1152x8), four source views a stage (the golden pack's
              views 1-4 swept into view 0), f32 and bf16: both sums equal
              to warp_variance_plain's after every view, one launch a
              view; the stage's four views in f32 by events and the
              profiler against the plain version, grid_sample with two
              in-place adds, and the bound of harness/variance.py's bytes;
              the fusion kernels (csrc/tsdf_fuse.cu: integrate, the
              splat's full walk, the hole fill) on a fused curved wall at
              640x480 and 1152x864, bit for bit against their plain
              versions, each by events and profiler device time beside
              its bytes bound and the plain version's time (the splat
              also beside the CPU route's axis-culled scatter_reduce
              splat), and a keyframe's integrate + render on the card's
              route against the CPU route run on the card;
  4. track kernels  K6 track_reduce, in the Huber and the Student-t
              weighting, against a float64 evaluation of its plain version
              at the tracker's level caps (640x480 level 0, the six
              256x192 levels) for B = 1, 5, 15 candidates, within
              TRACK_TOL of the largest |entry|; num equal to the plain
              f32 version's; one launch a call; CUDA-event times of both
              and the kernel's profiler device time;
     track lm  the LM kernel track_lm (one launch a level) at the same caps
              and B in both weightings: (a) one step from a plain state
              (lm_run from the packed state) against lm_step_plain in
              float64 (dx, T_new and the sums within their LM_*
              tolerances and TRACK_TOL; dx's backward error in its own
              system; it, active, accept, done and lam equal except at
              ties within LM_TIE); (b) whole levels: every step of the
              kernel's history up to the loop's end against the plain f32
              step from the kernel's own state, the kernel's result equal
              to its history's (lm_level_from_history) and its sums at the
              accepted poses equal to K6's there, bit for bit, the end
              point against lm_level_plain on the card (pose within
              LM_POSE_PX pixels of the level, aff within LM_AFF_TOL, unless
              the paths parted at a near-tie, never at the 640x480 cap),
              iteration counts, no host read inside a level, the kernel's
              event and device times (and the plain level's at the 640x480
              cap);
  5. probes   the torch ports of the three Pallas probe scripts at their
              own shapes (tandem_tpu_torch/experiments), M rows/s;
     casmvsnet  the map path of the cascade without view aggregation at
              CasMVSNet's DTU test size: MvsnetRunner at 5 views and
              1152x864 in f32 with a unit of seeded weights (the
              benchmark's mapping_seeded.write_unit) on a window of the
              benchmark's scene; the eager call, the CUDA graph's capture
              and a replay equal bit for bit, each with 12 warp_variance
              launches (3 stages x 4 source views) and one edge filter,
              warp_sample none;
  6. golden   the trained abl04 unit (exported/tandem, 640x480, V=7)
              replays sample_inputs.npz in f32: worst MAE < 1e-2 over all
              12 outputs, the reference's own boot-check bar; the sha256
              digest of the 12 outputs, equal to a second run and to a run
              under torch.use_deterministic_algorithms;
              bilinear_sample and the edge filter (its kernel launches a
              call) must have launched, and P5 and P3, off the main path,
              not (slice and track mvs hold the same); a profiled forward
              in each dtype counts the edge filter's kernels on the device
              by name against the launches its wrapper counted;
  7. slice    TandemBackend (MvsnetRunner + TSDF allocate, integrate,
              culled splat render) runs 4 keyframes built from the golden
              views in f32; the rendered depth must agree with the MVSNet
              depth; per-keyframe times;
  8. track 640x480  (times only) the dense reference built on golden view 0
              from the f32 slice's rendered depth; track_frame on views
              1-6, track_frame_multi with 5 motion candidates and with the
              15 rotation perturbations: ms per frame and LM iterations;
              with --profile-dir one track_lm launch a level;
  9. culled   on the f32 slice's map and on the wall scene at 640x480,
              integrate_culled and both culled renders equal the full walk
              (torch.equal) at turned cameras; counts and both times;
     sensor 640x480  (times only) dvo's dense_match on level 1 between
              golden view 0 and views 1-6, each view's depth the f32
              slice's render at its pose; the Student-t track_frame of
              views 1-6 against the dense reference (track_lm and K6 must
              launch, track_lm once a level); raycast at the 7 golden
              poses on the slice's map beside render_depth_splat and the
              march alone; CUDA events, bounds, device events a call;
 10. golden and slice again in bf16: worst MAE < 1e-1 (10 x the bar, the
              JAX runtime's bf16 boot check), the same render contract;
 11. wall     the TSDF wall contract at 640x480;
 12. track gt tests/fixtures/replica_traj (256x192): GT depths 0-6 fused,
              the axis-culled render at frame 6, frames 7-14 tracked from
              the constant-motion prediction: worst position error < 5 mm;
 13. track mvs the map from TandemBackend on the fixture's first two 7-view
              windows (trained abl04, f32), the reference at frame 10, the
              8 frames after it tracked: worst position error within
              MVS_TRACK_BOUND; K1, bilinear_sample, K6 and track_lm must
              have launched;
 14. slam     the port's tandem_dataset CLI (the SLAM loop: joint
              initializer, tracking with the retry ladder, immature-point
              tracing, windowed BA, marginalization, the backend, mesh) on
              the fixture's 64 frames, VO only and then the full pipeline
              with the trained unit (bf16, boot golden self-check) twice,
              the second with preload=1 (frames decoded up front; the
              others through the prefetcher):
              >= SLAM_MIN_FRAMES frames and ATE (Sim3) < SLAM_ATE_BOUND in
              every run; the full runs call the backend, write a non-empty
              mesh, launch K1's filter, bilinear_sample, track_lm and K6,
              and give the same result.txt sha256 (else the first aten op
              that differs is named); frames, seconds, FPS, the Timer split
              per stage, host reads a frame, the calls of the torch-op hot
              spots K7, K8, K11 and _corner_grids a frame or keyframe and
              their CUDA-event ms a call with a bound;
     export   tandem_export (cli/tandem_export.main) on the card with the
              trained abl04 unit's weights at 640x480, V = 7, into a
              temporary directory (its own replays through model.pt2 and
              the eager model under GOLDEN_TOL); the repo's golden pack
              through the saved program from a fresh torch.export.load:
              worst MAE over the 4 stage-3 outputs < GOLDEN_TOL, the
              custom ops' kernels launched (warp_sample 18 times, the edge
              filter once); the program's stage-3 sha256 beside the eager
              f32 model's (the first differing op named if they differ);
              ms a runner keyframe from the program (ExportedRunner) and
              from the f32 model's CUDA graph (MvsnetRunner), host clock,
              median of 5; then a weightless unit (model.pt2, model_config.json
              and the pack, exported at 256x192 from replica_traj's first
              "val" window) serves tandem_dataset on the fixture's 64
              frames: the boot self-check, >= SLAM_MIN_FRAMES frames, ATE
              (Sim3) < SLAM_ATE_BOUND, beside the pkl unit's full run;
     runtime 640x480  tandem_dataset preset=runtime (preload=1) with the
              trained unit on bench_runtime.py's 60-frame synthetic
              640x480 sequence, written as PNGs with Paeth, Sub, Up and
              Average rows: frames, seconds, FPS against the 21 FPS bar,
              the Timer split with read_frame (the decode wait),
              keyframes, backend calls and tandem_ate's Sim3 ATE against
              the GT trajectory; >= RUNTIME_MIN_POSES poses, not lost, the
              backend called, K1, bilinear_sample, K6 and track_lm
              launched;
     decode   the C decoder against data/replica.decode_png on the card
              host's CPU: bit-equal, both times, at 256x192 and 640x480;
     demo     tandem_demo replay= record= over the fixture's first
              DEMO_FRAMES frames with the unit: the recorded folder
              (camera.txt, times.txt, an image a frame) replayed through
              tandem_dataset with log_stuff, debug_save_depth_images,
              save_dr_video and viewer3d gives the demo's poses
              (poses_dso.txt sha256, result.txt's pose columns), and each
              output directory is non-empty;
     rgbd     FullSystem(rgbd=True) through the API on the fixture's
              frames with their sensor depths (dvo's dense tracker on
              level 1, K6's calc_res_eval, the Student-t fallback and retry
              ladder), VO only on 64 frames and with the trained unit
              (bf16) on 48: the VO run tracks >= SLAM_MIN_FRAMES frames
              with an SE(3) ATE without scale within RGBD_ATE_BOUND and
              keeps dvo's pose on RGBD_DVO_POSES frames, give or take
              RGBD_DVO_POSES_SLACK; both runs take the dvo branch and
              launch K6 and track_lm (the Student-t LM); the unit run
              calls the backend and its result.txt
              equals the VO run's first 48 lines; dvo, fallback and kept
              frames, retry ladder firings, FPS, Timer split, host reads a
              frame (VO run), dense_match, calc_res_eval and Student-t LM
              ms with bounds;
     dr_debug the port's dr_debug_example CLI over the fixture's first 20
              frames with GT poses: per frame allocate, integrate and
              raycast ms, and the render against the frame's GT depth (hit
              share > 0.8, median |error| < 2 voxels); mesh vertices;
 15. train    the port's tandem_train CLI on replica_traj (abl04 config,
              640x480, B = 2, f32): one epoch (7 steps) with its
              checkpoint, a resume from it with --pretrained (to step 14);
              the learning curve of tests/test_train_learns.py at abl04
              640x480 (CURVE_STEPS steps on tuples 0 and 7: finite, the
              last 5 losses' mean under half the first 5's) with the step
              time and peak memory, and BF16_STEPS bf16 steps (finite,
              falling); every step launches the forward sample and its
              backward kernel 18 times each, and the first step of each
              curve holds every backward call it made to the plain
              gradient (GRAD_TOL, each batch item) and times each call's
              kernel and grid_sample's backward (CUDA events), with the
              samples a touched source cell;
 16. parallel the multi-card paths on the one card: MvsnetRunner(devices=
              [cuda:0] * n), n = 2 and 4, with the trained unit on the
              golden window against the eager runner: f32 depth within
              SHARD_FLOOR_X times what one ulp of the input moves the
              eager forward by, confidence within SHARD_CONF_TOL but for
              SHARD_FLIP_SHARE of the pixels, the golden MAE <
              GOLDEN_TOL, bf16 within
              SHARD_BF16_REL (relative L1), warp_sample 18 launches and
              the edge filter once a call, the sums' count, payload and
              ring bytes a card (parallel/collectives); 2 gloo ranks on
              cuda:0 (abl04 640x480 f32, B = 2 each, DP_STEPS steps,
              parallel/dryrun) against one process at world_size 2 on the
              global batch of 4: losses within DP_RTOL, each rank's steps
              launching the sample and its backward kernel 18 times a step,
              ms a step; tandem_train TRAIN.DEVICE mesh (an NCCL group of
              one, 2 steps, one checkpoint);
 17. eval     the port's tandem_eval CLI on replica_mini with the trained
              512x320 unit at 48,32,8 and 48,4,4 planes: stage abs_rel
              within EVAL_TOL of tests/test_eval_fixture.py's reference.
The launch counters are set to 0 just before each driven path (the probes,
the slices, the three tracking paths, the Student-t tracking at 640x480,
the slam runs, the export's replay
and its weightless tandem_dataset run, the runtime run, the demo and its
replay, the RGB-D runs, the dr_debug run, the training
runs, the view-sharded runner calls, the one-process data-parallel
reference and the evals) and read just after it; the data-parallel ranks
count their own launches in their processes.
The last line of stdout is the JSON result; any failed phase exits
non-zero without it.
The line before it lists every kernel with its launches on the driven
paths, its error and time against its plain version, its bound (the
larger of its bytes over HBM_BYTES_PER_S and its operations over
F32_OPS_PER_S, from this run's inputs) and, where one PyTorch call
computes the same function, that call's time (``library_ms``; the port
never calls it).
Without a CUDA device, or without the repository beside this script, it
fails at once. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

# Before CUDA starts: cuBLAS is deterministic only with a fixed workspace
# (the golden phase's run under torch.use_deterministic_algorithms).
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

REPO = Path(__file__).resolve().parent
UNIT = REPO / "exported" / "tandem"
GOLDEN_TOL = 1e-2
BF16_TOL = 10 * GOLDEN_TOL   # tandem_tpu/cli/tandem_dataset.py:107-108
N_KEYFRAMES = 4
FIXTURE = REPO / "tests" / "fixtures" / "replica_traj" / "scene0"
# K6 against float64: relative to the largest |entry| of each output. The
# f32 sums of up to 42,496 x 15 terms stay near 1e-6; a point whose border
# or cutoff test flips between f32 and f64 moves the energy by <= 400 of
# ~10^6.
TRACK_TOL = 1e-4
GT_TRACK_BOUND = 5e-3        # m; the JAX package gets ~1 mm on this loop
# m; 1.5 x the JAX package's worst error on the same loop on the CPU
# (tests/test_torch_tracker.py::test_track_against_the_mvs_model).
MVS_TRACK_BOUND = 0.0532
# The SLAM loop on the trajectory fixture: tests/test_vo_ate.py's bars
# (the JAX package on the CPU reads 10.26 mm VO only, 10.15 mm full).
SLAM_ATE_BOUND = 0.030
SLAM_MIN_FRAMES = 56
# The runtime 640x480 phase: bench_runtime.py's synthetic sequence (60
# frames, the textured plane at depth 2, the camera moving 0.015 a frame
# along x) through tandem_dataset preset=runtime with the trained unit;
# the reference's throughput bar for that preset (BASELINE.md) and the
# poses the run must keep.
RUNTIME_FRAMES = 60
RUNTIME_MIN_POSES = 56
RUNTIME_FPS_BAR = 21.0
# The demo phase replays the fixture's first DEMO_FRAMES frames: all 64,
# since its first 40 make 6 keyframes (the CPU rehearsal) and the 7-view
# window, so the backend and its sinks, would never run.
DEMO_FRAMES = 64
# track_lm, one step against float64 (phase track lm (a)). dx must solve
# the kernel's own damped system to a componentwise backward error of
# LM_SOLVE_TOL, |Hl dx + g| / (|Hl| |dx| + |g|) (the f32 plain step: <=
# 1.5e-7 on the CPU), and agree with the float64 plain step, relative to
# its largest |entry|, within LM_DX_TOL: their sums differ, and dx's
# offset entry is about -sum(w r) / sum(w), a sum that cancels near
# convergence (the f32 plain step is 2.1e-3 off on the CPU). For the same
# reason, and because each residual is a difference of intensities of
# ~100 that f32 rounds by ~1e-5, e and g are held within TRACK_TOL of
# their Cauchy-Schwarz scales with a floor of one grey level a term,
# e + n and sqrt(H_ii (e + n)), not of their own size. T_new carries dx's
# error: against the step, relative to its largest |dx|, within
# LM_DX_TOL; against se3_exp(dx) @ T of the kernel's own dx in float64
# within LM_SE3_TOL of its largest entry (or of 1; the f32 plain step:
# <= 3e-7 on the CPU, ~5 f32 ulps of 1), or within 4x the plain f32
# update's own error on the same dx where that is larger (far poses and
# large steps at the 16x12 level: 2e-6).
LM_SOLVE_TOL = 1e-5
LM_DX_TOL = 1e-2
LM_SE3_TOL = 2e-6
# The Student-t step's dx and T_new against the step: within LM_DX_TOL,
# or within LM_DX_PLAIN_X times the plain f32 step's own distance from
# the float64 step from the same state, where that is larger. The t
# weights share one scale, a fixed point of sums whose start takes the
# residuals at or below their mean: rounding moves the scale and with it
# every weight, and near convergence dx is a small difference of such
# weighted sums (the plain f32 step is up to 8.6e-2 off float64 in dx on
# the CPU at the tracker's caps, against 1.8e-3 with the Huber weights).
LM_DX_PLAIN_X = 4.0
# A candidate whose accept or convergence test lies within this relative
# margin of its threshold in float64 is a tie: f32 sums may decide it
# either way.
LM_TIE = 1e-5
# A whole level's end point, kernel against the plain f32 version on the
# card: within LM_POSE_PX pixels of motion at the level's focal length
# (|dT| <= LM_POSE_PX / fx) and aff within LM_AFF_TOL (its offset is in
# grey levels). The sums differ in order, so the LM's stopping rule (a
# relative improvement below 1e-4) and its accept test can flip on a
# near-tie; on the few hundred points of the 16x12 level the two paths
# then part for good (f32 against f64 on the CPU: 0.19 px; the kernel
# against the plain version on the card: 0.19 px at B = 5).
LM_POSE_PX = 0.5
LM_AFF_TOL = 0.05
# The RGB-D path (phase rgbd): SE(3) ATE without scale on replica_traj
# within 1.5 x the JAX package's on the CPU over the same 64 frames (the
# MVS map's 1.5 x convention): 1.9844264140336252 mm, printed by
# tests/test_torch_rgbd.py::test_replica_traj_rgbd_ate (the port on the
# CPU: 1.859570720845736 mm).
RGBD_ATE_BOUND = 1.5 * 1.9844264140336252e-3
# The VO run's frames whose final pose is dvo's (neither the fallback's nor
# the retry ladder's): the JAX package's count on the CPU over the same 64
# frames, printed by the same test (frames 1-7; the port on the CPU: 7).
# After the ladder's first firing every frame retries (PERF.md), so a
# gate decision that flips on the card moves the count by one frame.
RGBD_DVO_POSES = 7
RGBD_DVO_POSES_SLACK = 1
# dvo's dense_match, per pixel and iteration: the warp and projection ~30,
# the six-plane bilinear sample ~50, the residual, gradients and gates
# ~55, the t weights, scale and log-likelihood ~35, the 2x6 Jacobian ~60
# and its 2x2-weighted normal equations (J^T W J over 6x6, J^T W r) ~220.
DVO_OPS = 450
# raycast, per ray: the direction ~10, the seed's 4 fill rounds 36, five
# march steps of ~50 (position, voxel and page-table index, step, hit
# test) and the colour's nine lookups (~34 each) and trilinear blend ~100.
RAYCAST_OPS = 700
# Bounds: NVIDIA's H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores (an FMA is two)
# f32 compare/min/max: 64 results a clock an SM at compute capability 9.0
# (the CUDA C++ Programming Guide's arithmetic throughput table), 132 SMs,
# at the 1,980 MHz boost clock of the data sheet's rates.
F32_CMP_PER_S = 64 * 132 * 1.98e9
# K6's work per (valid point, candidate): projection ~20, bilinear sample
# of three planes ~30, residual and Huber ~10, Jacobian ~20, the 44 sums of
# H and g ~100 operations.
TRACK_OPS = 180
# The Student-t weights of the RGB-D LM (coarse_tracker._tdist_weights) per
# residual: the trimmed-mean start ~12 and ten IRLS rounds of ~6.
TDIST_OPS = 72
# The edge filter's work per pixel, in compare/min/max slots. The centre's
# difference is always +0, so the answer is the 14th smallest of the other
# 24; the fewest min/max of a known selection network for that rank:
# Parberry's pairwise sorting network for 32 inputs, wires 24-31 at +inf,
# pruned to the one output, 165 (ops/selection_network.py; Batcher's
# odd-even merge sort pruned the same way needs 187; csrc/edge_kth.cu runs
# the pairwise one). Its 24 subtractions run at twice that rate (the |.| is
# an operand modifier): 12 slots. The radix passes' few integer operations
# a pixel are not counted.
EDGE_OPS = 165 + 24 / 2
# The device kernels of one edge filter call (csrc/edge_kth.cu), by name.
EDGE_FILTER_KERNELS = ("select_kernel<true>", "refine_kernel<2>",
                       "refine_kernel<3>", "output_kernel")
# The plane-sweep sample's work per sample, besides 7 per channel for the
# blend: ~15 for the projection and its two divisions, ~15 for the floor,
# the weights and the in-bounds test, ~10 for the corner addresses.
SAMPLE_OPS = 40
# abl04 at 640x480: per stage (depth planes, H, W, feature channels).
STAGE_SHAPES = {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
                "stage3": (4, 480, 640, 8)}
# CasMVSNet's DTU test at 1152x864, as the benchmark's
# mapping.casmvsnet_dtu_1152x864 cell runs it: the same, and the source
# views a stage.
DTU_STAGE_SHAPES = {"stage1": (48, 216, 288, 32),
                    "stage2": (32, 432, 576, 16),
                    "stage3": (8, 864, 1152, 8)}
DTU_SOURCE_VIEWS = 4
# The same at 256x192, the slam phase's fixture.
SLAM_STAGE_SHAPES = {"stage1": (48, 48, 64, 32), "stage2": (4, 96, 128, 16),
                     "stage3": (4, 192, 256, 8)}
# The training and eval phases: tandem_train on the trajectory fixture
# (abl04 at 640x480, B = 2), the learning curve's gate and steps
# (tests/test_train_learns.py's), and tandem_eval on replica_mini
# (tests/test_eval_fixture.py's reference numbers and tolerance).
TRAIN_ROOT = REPO / "tests" / "fixtures" / "replica_traj"
EVAL_ROOT = REPO / "tests" / "fixtures" / "replica_mini"
EVAL_UNIT = REPO / "exported" / "tandem_512x320"
CURVE_STEPS = 41
BF16_STEPS = 8
REF_ABS_REL = {"48,32,8": {"stage1": 0.008706, "stage2": 0.177201,
                           "stage3": 0.144266},
               "48,4,4": {"stage1": 0.008706, "stage2": 0.006343,
                          "stage3": 0.006183}}
EVAL_TOL = 0.01
# The backward kernel against its plain version in float64: the error of
# its float32 sums (atomics in any order) as a share of the largest
# |gradient|.
GRAD_TOL = 1e-4
# Every hand kernel: where it lives and which Pallas kernels it replaces.
KERNELS = {
    "edge_kth": ("tandem_tpu_torch/csrc/edge_kth.cu",
                 "tandem_tpu/ops/pallas_kernels.py:59, with the threshold, "
                 "mask and wheres of tandem_tpu/models/edge_filter.py:45-51 "
                 "(XLA)"),
    "bilinear_index": ("tandem_tpu_torch/csrc/bilinear_index.cu",
                       "experiments/bench_idxchain.py:62"),
    "corner_blend": ("tandem_tpu_torch/csrc/corner_blend.cu",
                     "experiments/pallas_gather_probe.py:82"),
    "bilinear_sample": ("tandem_tpu_torch/csrc/bilinear_sample.cu",
                        "experiments/bench_idxchain.py:62 + "
                        "experiments/pallas_gather_probe.py:82 (P5 + P3) "
                        "on the main path, and the position math of "
                        "tandem_tpu/ops/warp.py:96-116 (XLA)"),
    "warp_sample_grad": ("tandem_tpu_torch/csrc/bilinear_sample.cu",
                         "the gradient of P5 + P3's function on the main "
                         "path: the scatter-add XLA derives for jax.grad "
                         "from the gather of tandem_tpu/ops/warp.py:147-157"),
    "warp_variance": ("tandem_tpu_torch/csrc/bilinear_sample.cu",
                      "the variance cost volume without view aggregation, "
                      "tandem_tpu/models/cva_mvsnet.py:194 + :209-210 "
                      "(XLA: each view's warped volume and its square "
                      "added to two sums; no Pallas kernel)"),
    "tsdf_integrate": ("tandem_tpu_torch/csrc/tsdf_fuse.cu",
                       "none: tandem_tpu/mapping/tsdf.py integrate + "
                       "integrate_culled (XLA), ported as torch ops"),
    "tsdf_splat": ("tandem_tpu_torch/csrc/tsdf_fuse.cu",
                   "none: tandem_tpu/mapping/tsdf.py render_depth_splat's "
                   "splat and its culls (XLA), ported as torch ops"),
    "tsdf_fill_holes": ("tandem_tpu_torch/csrc/tsdf_fuse.cu",
                        "none: tandem_tpu/mapping/tsdf.py _fill_holes "
                        "(XLA), ported as torch ops"),
    "row_gather": ("tandem_tpu_torch/csrc/row_gather.cu",
                   "experiments/pallas_gather_probe.py:35 "
                   "experiments/pallas_gather_probe.py:59 "
                   "experiments/pallas_shuffle_probe.py:25"),
    "track_reduce": ("tandem_tpu_torch/csrc/track_reduce.cu",
                     "tandem_tpu/tracking/coarse_tracker.py:348 "
                     "(_energy_and_system with :314 _tdist_weights: XLA "
                     "code, not a Pallas kernel)"),
    "track_lm": ("tandem_tpu_torch/csrc/track_lm.cu",
                 "tandem_tpu/tracking/coarse_tracker.py:382 _lm_level + "
                 ":348 _energy_and_system + :314 _tdist_weights (XLA, not "
                 "Pallas)"),
}


def log(msg: str):
    print(msg, flush=True)


def wrappers() -> dict:
    """Each kernel's wrappers; their ``.launches`` count its launches."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      warp_sample,
                                                      warp_sample_grad,
                                                      warp_variance)
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    from tandem_tpu_torch.ops.edge_kth import edge_filter, edge_kth_value
    from tandem_tpu_torch.ops.row_gather import row_gather
    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    from tandem_tpu_torch.mapping.tsdf import _fill_holes, integrate, splat_zbuf
    return {"edge_kth": (edge_filter, edge_kth_value),
            "bilinear_index": (bilinear_index,),
            "corner_blend": (corner_blend,),
            "bilinear_sample": (warp_sample, bilinear_sample),
            "warp_sample_grad": (warp_sample_grad,),
            "warp_variance": (warp_variance,),
            "tsdf_integrate": (integrate,), "tsdf_splat": (splat_zbuf,),
            "tsdf_fill_holes": (_fill_holes,),
            "row_gather": (row_gather,), "track_reduce": (track_reduce,),
            "track_lm": (lm_level,)}


def reset_counts():
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0
    edge_filter.calls = 0


def read_counts() -> dict:
    return {name: sum(fn.launches for fn in fns)
            for name, fns in wrappers().items()}


def require_launched(path: str, counts: dict, names, at_least: int = 1):
    for name in names:
        if counts[name] < at_least:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 f"< {at_least} times")


def edge_calls() -> int:
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    return edge_filter.calls


def require_edge_filter(path: str, launches: int, calls: int,
                        at_least: int) -> str:
    """The edge filter ran ``at_least`` times on this path, each call with
    the kernel launches its C call reported, KERNELS_PER_CALL of them, and
    nothing else of edge_kth.cu ran (K1 alone is off the path). Returns the
    launches a call, for the log."""
    from tandem_tpu_torch.ops.edge_kth import KERNELS_PER_CALL
    if calls < at_least or launches != KERNELS_PER_CALL * calls:
        raise AssertionError(f"{path}: edge_kth launched {launches} times in "
                             f"{calls} edge_filter calls (need >= {at_least} "
                             f"calls of {KERNELS_PER_CALL} launches)")
    return (f"edge_filter {calls} calls, {launches // calls} kernel launches "
            f"a call (+ 1 memset)")


def profiled_edge_filter(path: str, fn) -> str:
    """Run ``fn`` once under torch.profiler and hold the device kernels of
    csrc/edge_kth.cu it ran, counted by name, against the launches the
    wrapper counted: KERNELS_PER_CALL a filter call, and K1 alone none.
    Returns a line for the log."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from tandem_tpu_torch.ops.edge_kth import KERNELS_PER_CALL
    for _ in range(3):       # a session that saw no kernel is taken again
        calls, launches = edge_calls(), read_counts()["edge_kth"]
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        calls = edge_calls() - calls
        launches = read_counts()["edge_kth"] - launches
        seen = {"filter": 0, "K1 alone": 0, "memsets": 0}
        for e in p.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if any(k in e.key for k in EDGE_FILTER_KERNELS):
                seen["filter"] += e.count
            elif "select_kernel<false>" in e.key:
                seen["K1 alone"] += e.count
            elif "Memset" in e.key:
                seen["memsets"] += e.count
        if any(seen.values()):
            break
    if not (calls and seen["filter"] == launches == KERNELS_PER_CALL * calls
            and not seen["K1 alone"]):
        raise AssertionError(f"{path}: the profiler saw {seen} device events "
                             f"of edge_kth.cu in {calls} edge_filter calls "
                             f"with {launches} counted launches")
    return (f"profiled: {seen['filter']} edge_kth.cu kernels on the device "
            f"in {calls} edge_filter calls ({seen['filter'] // calls} a "
            f"call), {seen['memsets']} memsets in the whole run")


def require_not_launched(path: str, counts: dict, names):
    for name in names:
        if counts[name]:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 "times; it is off this path")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
           ) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their rate (f32 by default)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_device():
    import torch

    from tandem_tpu_torch.utils.cuda_timing import card_label
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(card_label())
    return name


def phase_build():
    from tandem_tpu_torch.ops import _build
    secs = _build.build()
    lib = _build.library_path()
    log(f"[build] csrc/*.cu -> {lib.relative_to(REPO)} in {secs:.2f} s")
    report = lib.parent / "ptxas.log"
    if report.exists():
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    _build.kernels()


def _exact(name: str, got, ref) -> float:
    """Hold a kernel's output(s) against the plain version's: equal, or
    raise. Returns the max |difference| (0.0)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{name} differs from plain: max |err| {err}")
    return err


def _edge_depth(kind: str, shape, rng):
    """A depth case of the edge filter's kernels phase."""
    if kind == "random":
        return (rng.rand(*shape) * 4).astype(np.float32)
    if kind == "tied":                 # quantised: many equal differences
        return (np.round(rng.rand(*shape) * 4) / 2).astype(np.float32)
    if kind == "all_equal":
        return np.full(shape, 1.5, np.float32)
    if kind == "heavy":                # clipped Cauchy magnitudes
        return (np.clip(np.abs(rng.standard_cauchy(shape)), 0, 1e6)
                * 1e-3).astype(np.float32)
    d = np.full(shape, 2.0, np.float32)  # border: an empty band and a step
    d[..., :5] = 0.0
    d[..., shape[1] // 2:, :] = 3.5
    return d


def _parent_filter(depth, ranks, conf):
    """The edge filter as it was composed before it was one op: K1, a
    torch.kthvalue an image, the comparison and two wheres."""
    import torch

    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    edge = edge_kth_value(depth)
    flat = edge.reshape(edge.shape[0], -1)
    thres = torch.stack([torch.kthvalue(flat[b], k + 1).values
                         for b, k in enumerate(ranks)])
    mask = edge > thres[:, None, None]
    return (torch.where(mask, torch.zeros_like(depth), depth),
            torch.where(mask, torch.zeros_like(conf), conf), mask)


def _edge_host_cost(d, c, ranks, fns) -> dict:
    """The edge filter wrapper's host cost per call and its parts: the
    checks, the allocations and the argument block (the wrapper's own
    helper), the bare ctypes call (the memset and the four launches), the
    whole wrapper; K1 alone's wrapper (one launch) and torch.kthvalue's, for
    comparison."""
    import ctypes

    import torch

    from tandem_tpu_torch.ops import _build
    from tandem_tpu_torch.ops import edge_kth as ek
    call = ek._filter_call(d, ranks, c)   # alive while the raw calls run
    launched = ctypes.c_int(0)
    raw = _build.kernels().tandem_edge_filter
    stream = torch.cuda.current_stream().cuda_stream
    return {"checks": _host_us(lambda: ek._check("edge_filter", d, c)),
            "allocations and argument block": _host_us(
                lambda: ek._filter_call(d, ranks, c)),
            "ctypes call (memset + 4 launches)": _host_us(
                lambda: raw(call[0], ctypes.byref(launched), stream)),
            "edge_filter": _host_us(fns["op"]),
            "K1 alone (one launch)": _host_us(fns["K1 alone"]),
            "torch.kthvalue": _host_us(fns["torch.kthvalue"])}


def _edge_kth(dev, out: dict):
    """The edge filter op (csrc/edge_kth.cu) against its plain version,
    equal in depth, confidence and mask, its threshold equal to
    torch.kthvalue; K1 alone against edge_kth_plain; times at 1x480x640 by
    CUDA events and profiler device time of the op, K1 alone, the parent's
    composition and torch.kthvalue."""
    import torch

    from tandem_tpu_torch.ops.edge_kth import (edge_filter, edge_filter_plain,
                                               edge_kth_plain, edge_kth_value)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    rng = np.random.RandomState(0)
    checked, err = 0, 0.0
    for H, W in ((480, 640), (120, 160), (240, 320), (192, 256), (61, 83)):
        n = H * W
        k10 = int(np.float32(n * 0.9))
        for kind in ("random", "tied", "border", "all_equal", "heavy"):
            for B, rank_sets in ((1, ([k10], [0], [n - 1])),
                                 (3, ([0, k10, n - 1],))):
                d = torch.from_numpy(_edge_depth(kind, (B, H, W), rng)).to(dev)
                c = torch.from_numpy(rng.rand(B, H, W).astype(
                    np.float32)).to(dev)
                _exact(f"K1 alone {kind} {B}x{H}x{W}", edge_kth_value(d),
                       edge_kth_plain(d))
                edge = edge_kth_plain(d).reshape(B, -1)
                for ranks in rank_sets:
                    for conf in (c, None):
                        got = edge_filter(d, ranks, conf)
                        ref = edge_filter_plain(d, ranks, conf)
                        kth = torch.stack(
                            [torch.kthvalue(edge[b], k + 1).values
                             for b, k in enumerate(ranks)])
                        where = f"edge_filter {kind} {B}x{H}x{W} k={ranks}"
                        err = max(err, _exact(
                            where, tuple(x for x in got if x is not None),
                            tuple(x for x in ref if x is not None)))
                        _exact(f"{where}: threshold vs torch.kthvalue",
                               got.threshold, kth)
                        checked += 1
    log(f"[kernels] edge_filter: {checked} calls equal to the plain version "
        f"(depth, confidence, mask) with the threshold equal to "
        f"torch.kthvalue: 480x640, 120x160, 240x320, 192x256 (the slam "
        f"path's), 61x83; B = 1, 3; "
        f"random, tied, border, all-equal, heavy-tailed; k = 0, N-1 and the "
        f"10% discard; with and without confidence; K1 alone equal")

    H, W = 480, 640
    d = torch.from_numpy(_edge_depth("random", (1, H, W), rng)).to(dev)
    c = torch.from_numpy(rng.rand(1, H, W).astype(np.float32)).to(dev)
    ranks = [int(np.float32(H * W * 0.9))]
    edge = edge_kth_value(d).reshape(-1)
    fns = {"op": lambda: edge_filter(d, ranks, c),
           "K1 alone": lambda: edge_kth_value(d),
           "parent composition": lambda: _parent_filter(d, ranks, c),
           "torch.kthvalue": lambda: torch.kthvalue(edge, ranks[0] + 1)}
    ev = {k: cuda_ms(f, iters=100) for k, f in fns.items()}
    devt = {k: _device_ms(f, calls=10) for k, f in fns.items()}
    plain_ms = cuda_ms(lambda: edge_filter_plain(d, ranks, c), iters=10)
    host = _edge_host_cost(d, c, ranks, fns)
    bound = _bound(_nbytes(d, c) * 2 + d.numel(), EDGE_OPS * d.numel(),
                   F32_CMP_PER_S)
    k1_bound = _bound(_nbytes(d) * 2, EDGE_OPS * d.numel(), F32_CMP_PER_S)
    log(f"[kernels] edge filter 1x480x640 with confidence (CUDA events, "
        f"median of rounds of 20 / profiler device time of 10 calls): "
        + "; ".join(f"{k} {ev[k]:.4f} / {devt[k]:.4f} ms" for k in fns)
        + f"; plain {plain_ms:.4f} ms (events); bound {bound['bound_ms']:.5f}"
        f" ms ({bound['bound_by']}): share "
        f"{bound['bound_ms'] / devt['op']:.1%} of the op's device time; K1 "
        f"alone bound {k1_bound['bound_ms']:.5f}"
        f" ms: share {k1_bound['bound_ms'] / devt['K1 alone']:.1%}; host a "
        f"call (perf_counter, 500 calls): "
        + ", ".join(f"{k} {v:.2f} us" for k, v in host.items()))
    out["edge_kth"] = {"max_abs_err": err, "ms": ev["op"],
                       "plain_ms": plain_ms, "device_ms": devt["op"],
                       **bound, "library_ms": ev["torch.kthvalue"],
                       "library": "torch.kthvalue on the 307,200 edge values"}


def _warp_positions(dev, gen, D: int, H: int, W: int):
    """Plane-sweep-like positions of one source view: a shifted, slightly
    scaled pixel grid per depth plane (neighbouring samples read
    neighbouring rows, as in the warp) with jitter, running past both pad
    edges; a 5% random keep=False share stands in for rays behind the
    source camera."""
    import torch
    gy, gx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    shift = torch.linspace(-4.0, 6.0, D, device=dev)[:, None, None]
    jit = torch.rand((2, D, H, W), generator=gen, device=dev) - 0.5
    x = (gx * 1.02 + shift + jit[0])[None].contiguous()
    y = (gy * 0.99 + 1.5 + jit[1])[None].contiguous()
    keep = torch.rand((1, D, H, W), generator=gen, device=dev) < 0.95
    return x, y, keep


def _grid_sample_args(feat, x, y, keep, H: int, W: int):
    """The P5 + P3 pair's function as one torch.nn.functional.grid_sample
    call (bilinear, align_corners=True, zeros padding): NCHW features and
    a normalised grid, with the dropped samples moved outside the image."""
    import torch
    gx = torch.where(keep, x / (W - 1) * 2 - 1, torch.full_like(x, -3.0))
    gy = torch.where(keep, y / (H - 1) * 2 - 1, torch.full_like(y, -3.0))
    grid = torch.stack([gx, gy], -1).reshape(feat.shape[0], -1, W, 2) \
        .to(feat.dtype)
    return feat.permute(0, 3, 1, 2).contiguous(), grid


def _sample_kernels(dev, out: dict):
    """P5 and P3 at the abl04 640x480 stage shapes, f32 and bf16, and the
    one PyTorch call that computes the pair, grid_sample."""
    import torch
    import torch.nn.functional as F

    from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                     bilinear_index_plain)
    from tandem_tpu_torch.ops.corner_blend import (corner_blend,
                                                   corner_blend_plain)
    from tandem_tpu_torch.ops.bilinear_sample import pack_corners
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"bilinear_index": {"max_abs_err": 0.0},
           "corner_blend": {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            x, y, keep = _warp_positions(dev, gen, D, H, W)
            args = (x, y, H, W, keep, 1, dtype)
            rows, w = bilinear_index(*args)
            e5 = _exact(f"P5 {dn} {stage}", (rows, w),
                        bilinear_index_plain(*args))
            feat = torch.randn((1, H, W, C), generator=gen, device=dev)
            table = pack_corners(feat.to(dtype)).reshape(-1, 4 * C)
            bargs = (table, rows.reshape(-1), w.reshape(4, -1))
            e3 = _exact(f"P3 {dn} {stage}", corner_blend(*bargs),
                        corner_blend_plain(*bargs))
            t5 = (cuda_ms(lambda: bilinear_index(*args)),
                  cuda_ms(lambda: bilinear_index_plain(*args)))
            t3 = (cuda_ms(lambda: corner_blend(*bargs)),
                  cuda_ms(lambda: corner_blend_plain(*bargs)))
            gs = _grid_sample_args(feat.to(dtype), x, y, keep, H, W)

            def library():
                return F.grid_sample(*gs, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)
            # The same function, to the rounding of the normalised grid
            # (x / (W - 1) * 2 - 1 and back moves a sample by ~1e-5 px:
            # 2.8e-5 of the largest |feature| at stage 1 on the card).
            if dtype == torch.float32:
                lib_err = float((library().reshape(C, -1).t()
                                 - corner_blend(*bargs)).abs().max())
                if not lib_err <= 2e-4 * float(feat.abs().max()):
                    raise AssertionError(f"grid_sample differs from P5 + P3 "
                                         f"at {stage}: {lib_err}")
            lib_ms = cuda_ms(library)
            n = rows.numel()
            b5 = _bound(_nbytes(x, y, keep, rows, w), 20 * n)
            b3 = _bound(_nbytes(*bargs) + n * C * table.element_size(),
                        8 * n * C)
            log(f"[kernels] {stage} {dn} N={n} C={C}: bilinear_index exact, "
                f"kernel {t5[0]:.4f} ms plain {t5[1]:.4f} ms bound "
                f"{b5['bound_ms']:.4f} ms ({b5['bound_by']}); corner_blend "
                f"exact, kernel {t3[0]:.4f} ms plain {t3[1]:.4f} ms bound "
                f"{b3['bound_ms']:.4f} ms ({b3['bound_by']}); the pair "
                f"{t5[0] + t3[0]:.4f} ms, grid_sample {lib_ms:.4f} ms")
            for name, e, t, b in (("bilinear_index", e5, t5, b5),
                                  ("corner_blend", e3, t3, b3)):
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], e)
                if stage == "stage1" and dtype == torch.bfloat16:
                    # grid_sample computes the pair: its time stands
                    # beside each of the two kernels.
                    r.update(ms=t[0], plain_ms=t[1], library_ms=lib_ms,
                             library="grid_sample (the P5 + P3 pair)", **b)
    out.update(res)


def _golden_sweep(dev, stage: str, D: int, H: int, W: int,
                  behind: bool = False, shapes: dict = STAGE_SHAPES,
                  view: int = 1):
    """The plane sweep of the golden pack's view 0 (reference) from view
    ``view`` (source) at one stage of ``shapes``: the stage's intrinsics
    (the pack's, scaled to W), and the depth hypotheses as the model makes
    them (uniform at stage 1; adaptive around the pack's upsampled depth of
    the stage before after it). ``behind`` moves the source camera forward
    by the median hypothesis, so that about half of the sweep lies behind
    it. Returns the ref->src matrix (1, 3, 4), the depth (1, D, H, W) and
    the cameras (K, src, ref)."""
    import torch

    from tandem_tpu_torch.models.layers import interpolate_bilinear
    from tandem_tpu_torch.models.ranges import (adaptive_depth_range,
                                                uniform_depth_range)
    from tandem_tpu_torch.ops.warp import ref_to_src_matrix
    pack = np.load(UNIT / "sample_inputs.npz")
    with open(UNIT / "model_config.json") as f:
        ratios = json.load(f)["depth_interval_ratio"]
    i = int(stage[-1]) - 1
    K = torch.from_numpy(pack[f"K{i + 1}"]).to(dev)
    K[..., :2, :] *= W / STAGE_SHAPES[stage][2]
    c2w = torch.from_numpy(pack["cam_to_world"]).to(dev)
    src, ref = c2w[:, view].clone(), c2w[:, 0].contiguous()
    D1, H1, W1, _ = shapes["stage1"]
    depth, base = uniform_depth_range(
        depth_min=torch.from_numpy(pack["depth_min"]).to(dev),
        depth_max=torch.from_numpy(pack["depth_max"]).to(dev),
        depth_num=D1, height=H1, width=W1)
    if i > 0:
        prev = torch.from_numpy(pack[f"out.stage{i}.depth_dense"]).to(dev)
        up = interpolate_bilinear(prev[..., None], H, W)[..., 0]
        depth = adaptive_depth_range(depth=up, interval=ratios[i] * base,
                                     depth_num=D)
    if behind:
        src[:, 2, 3] += float(depth.median())
    return (ref_to_src_matrix(K, src, K, ref), depth.contiguous(),
            (K, src, ref))


def _device_ms(fn, calls: int = 5) -> float:
    """torch.profiler's device time of one call of ``fn``: the kernels and
    copies of ``calls`` calls, summed, over the calls. A profiling session
    that saw no device time at all (the first of a process can miss the
    kernels) is taken again, up to three times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in p.key_averages()
                      if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / 1e3 / calls
    raise AssertionError("the profiler saw no device time in three sessions")


def _host_us(fn, calls: int = 500) -> float:
    """Host time of one call of ``fn`` (time.perf_counter over ``calls``
    calls, no sync between them: the device runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def _old_sample(feat, mat, depth):
    """The warp's sample before the one-launch kernel: the positions in
    torch, pack_corners, P5, P3."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.bilinear_sample import (pack_corners,
                                                      sweep_positions)
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    B, H, W, C = feat.shape
    px, py, z = sweep_positions(mat, depth, H, W)
    rows, w = bilinear_index(px, py, H, W, keep=~(z < 0.001), batches=B,
                             dtype=feat.dtype)
    table = pack_corners(feat).reshape(-1, 4 * C)
    out = corner_blend(table, rows.reshape(-1), w.reshape(4, -1))
    return out.reshape(*px.shape, C)


def _host_cost(dev, feat, mat, depth, cams, library) -> dict:
    """The wrapper's host cost per call and its parts: the ctypes call
    alone, ``_build.launch`` (device and stream lookup + the call), the
    checks, the output's allocation (and its free), the whole wrapper;
    grid_sample's, for comparison; and plane_sweep_warp (the 4x4 matrices
    + the wrapper), with and without the reference's matrix passed in."""
    import torch

    from tandem_tpu_torch.ops import _build
    from tandem_tpu_torch.ops import bilinear_sample as bs
    from tandem_tpu_torch.ops.warp import plane_sweep_warp, ref_pixel_to_world
    B, H, W, C = feat.shape
    D = depth.shape[1]
    buf = torch.empty((B, D, H, W, C), dtype=feat.dtype, device=dev)
    args = (bs._SWEEP_ARGS.pack(
        feat.data_ptr(), mat.data_ptr(), depth.data_ptr(), buf.data_ptr(),
        B, D, H, W, C, *bs._plan(B, D, H, W, C, feat.element_size(),
                                 feat.data_ptr() % 16, 0),
        int(feat.dtype == torch.bfloat16), 0.001),)
    raw = _build.kernels().tandem_warp_sample
    stream = torch.cuda.current_stream().cuda_stream
    K, src, ref = cams
    p2w = ref_pixel_to_world(K, ref)

    def sweep(**kw):
        return plane_sweep_warp(feat, depth, src_K=K, src_cam_to_world=src,
                                ref_K=K, ref_cam_to_world=ref,
                                with_mask=False, **kw)
    return {
        "ctypes call": _host_us(lambda: raw(*args, stream)),
        "_build.launch": _host_us(
            lambda: _build.launch("tandem_warp_sample", dev, *args)),
        "checks": _host_us(lambda: bs._check("warp_sample", feat,
                                             (mat, depth))),
        "output allocation": _host_us(lambda: feat.new_empty(buf.shape)),
        "warp_sample": _host_us(lambda: bs.warp_sample(feat, mat, depth)),
        "grid_sample": _host_us(library),
        "plane_sweep_warp": _host_us(sweep),
        "plane_sweep_warp with the stage's ref_p2w": _host_us(
            lambda: sweep(ref_p2w=p2w))}


def _sweep_kernels(dev, out: dict):
    """csrc/bilinear_sample.cu in its two modes against its plain versions
    at the abl04 640x480 stage shapes, f32 and bf16, with the times of the
    kernel, its plain version, the old path and grid_sample."""
    import torch
    import torch.nn.functional as F

    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      bilinear_sample_plain,
                                                      sweep_positions,
                                                      warp_sample,
                                                      warp_sample_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            feat = torch.randn((1, H, W, C), generator=gen,
                               device=dev).to(dtype)
            for behind in (True, False):    # the main case stays in mat
                mat, depth, cams = _golden_sweep(dev, stage, D, H, W, behind)
                got = warp_sample(feat, mat, depth)
                res["max_abs_err"] = max(res["max_abs_err"], _exact(
                    f"warp_sample {dn} {stage} behind={behind}", got,
                    warp_sample_plain(feat, mat, depth)))
                if behind:
                    z = sweep_positions(mat, depth, H, W)[2]
                    dropped = float((z < 0.001).float().mean())
            x, y, keep = (a.reshape(1, -1)
                          for a in _warp_positions(dev, gen, D, H, W))
            res["max_abs_err"] = max(res["max_abs_err"], _exact(
                f"bilinear_sample {dn} {stage}",
                bilinear_sample(feat, x, y, keep),
                bilinear_sample_plain(feat, x, y, keep)))
            px, py, z = sweep_positions(mat, depth, H, W)
            gs = _grid_sample_args(feat, px, py, ~(z < 0.001), H, W)

            def library():
                return F.grid_sample(*gs, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)
            if dtype == torch.float32:   # the same function (see P5 + P3)
                lib_err = float((library().reshape(C, -1).t()
                                 - got.reshape(-1, C)).abs().max())
                if not lib_err <= 2e-4 * float(feat.abs().max()):
                    raise AssertionError(f"grid_sample differs from "
                                         f"warp_sample at {stage}: {lib_err}")

            def kernel():
                return warp_sample(feat, mat, depth)
            # Rounds of 20 calls: where the host dispatch is the longer,
            # the events read its steady rate, not a round's first call.
            t = {"kernel": cuda_ms(kernel, iters=100),
                 "plain": cuda_ms(lambda: warp_sample_plain(feat, mat, depth),
                                  iters=10),
                 "old": cuda_ms(lambda: _old_sample(feat, mat, depth)),
                 "grid_sample": cuda_ms(library, iters=100),
                 "given positions": cuda_ms(
                     lambda: bilinear_sample(feat, x, y, keep), iters=100)}
            dev_ms = {"kernel": _device_ms(kernel)}
            reported = stage == "stage1" and dtype == torch.bfloat16
            if reported:    # the old path and grid_sample by the profiler
                dev_ms.update(old=_device_ms(
                    lambda: _old_sample(feat, mat, depth)),
                    grid_sample=_device_ms(library))
            bound = _bound(_nbytes(feat, mat, depth, got),
                           got.numel() // C * (SAMPLE_OPS + 7 * C))
            log(f"[kernels] warp_sample {stage} {dn} D={D} {W}x{H} C={C}: "
                f"exact (and behind the source camera, {dropped:.1%} of the "
                f"samples dropped; bilinear_sample on given positions "
                f"exact); kernel {t['kernel']:.4f} ms (events) "
                f"{dev_ms['kernel']:.4f} ms (device), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): share "
                f"{bound['bound_ms'] / dev_ms['kernel']:.1%} of the device "
                f"time; plain {t['plain']:.4f} ms; old path (positions, "
                f"pack_corners, P5, P3) {t['old']:.4f} ms (events"
                + (f", {dev_ms['old']:.4f} ms device" if reported else "")
                + f"); grid_sample on the positions {t['grid_sample']:.4f} "
                f"ms (events"
                + (f", {dev_ms['grid_sample']:.4f} ms device" if reported
                   else "")
                + f"); bilinear_sample on given positions "
                f"{t['given positions']:.4f} ms (events)")
            if stage == "stage2" and dtype == torch.float32:
                host = _host_cost(dev, feat, mat, depth, cams, library)
                log("[kernels] host cost a call (perf_counter, 500 calls, "
                    "stage 2 f32): " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in host.items()))
            if reported:
                res.update(ms=t["kernel"], plain_ms=t["plain"],
                           device_ms=dev_ms["kernel"],
                           library_ms=t["grid_sample"],
                           library="grid_sample on the warp's positions",
                           **bound)
    # The slam phase feeds the kernel the 256x192 stages: exact there too.
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in SLAM_STAGE_SHAPES.items():
            feat = torch.randn((1, H, W, C), generator=gen,
                               device=dev).to(dtype)
            for behind in (True, False):
                mat, depth, _ = _golden_sweep(dev, stage, D, H, W, behind,
                                              SLAM_STAGE_SHAPES)
                res["max_abs_err"] = max(res["max_abs_err"], _exact(
                    f"warp_sample {dn} {stage} {W}x{H} behind={behind}",
                    warp_sample(feat, mat, depth),
                    warp_sample_plain(feat, mat, depth)))
            x, y, keep = (a.reshape(1, -1)
                          for a in _warp_positions(dev, gen, D, H, W))
            res["max_abs_err"] = max(res["max_abs_err"], _exact(
                f"bilinear_sample {dn} {stage} {W}x{H}",
                bilinear_sample(feat, x, y, keep),
                bilinear_sample_plain(feat, x, y, keep)))
    log("[kernels] warp_sample and bilinear_sample exact at the slam "
        "path's 256x192 stages too (D 48/4/4, C 32/16/8; f32 and bf16; "
        "with and without the sweep behind the source camera)")
    out["bilinear_sample"] = res


def _row_gather(dev, out: dict):
    import torch

    from tandem_tpu_torch.experiments.gather_probe import CW, M, N_FULL
    from tandem_tpu_torch.ops.row_gather import row_gather, row_gather_plain
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randint(0, M, (N_FULL,), generator=gen, device=dev,
                        dtype=torch.int32)
    err = 0.0
    for dtype, width in ((torch.float32, CW), (torch.bfloat16, 33),
                         (torch.bfloat16, CW)):
        tbl = torch.randn((M, width), generator=gen, device=dev).to(dtype)
        err = max(err, _exact(f"row_gather {dtype} width {width}",
                              row_gather(tbl, idx), row_gather_plain(tbl, idx)))
    ms = cuda_ms(lambda: row_gather(tbl, idx))   # the (M, CW) bf16 table
    plain_ms = cuda_ms(lambda: row_gather_plain(tbl, idx))
    idx64 = idx.long()
    lib_ms = cuda_ms(lambda: torch.index_select(tbl, 0, idx64))
    bound = _bound(_nbytes(tbl, idx) + N_FULL * CW * tbl.element_size(), 0)
    log(f"[kernels] row_gather ({M}, {CW}) bf16 N={N_FULL}: exact in f32 "
        f"and bf16 (and width 33); kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms index_select {lib_ms:.4f} ms; bound {bound}")
    # P4's own shape: G chunks of the (M, 64) bf16 table's rows.
    from tandem_tpu_torch.experiments.shuffle_probe import G
    idx4 = torch.randint(0, M, (G * M,), generator=gen, device=dev,
                         dtype=torch.int32)
    p4 = {"kernel": cuda_ms(lambda: row_gather(tbl, idx4)),
          "plain": cuda_ms(lambda: row_gather_plain(tbl, idx4)),
          "index_select": cuda_ms(lambda: torch.index_select(
              tbl, 0, idx4.long()))}
    b4 = _bound(_nbytes(tbl, idx4) + G * M * CW * tbl.element_size(), 0)
    _exact("row_gather at P4's shape", row_gather(tbl, idx4),
           row_gather_plain(tbl, idx4))
    log(f"[kernels] row_gather at P4's shape ({G} x {M} rows of ({M}, {CW}) "
        f"bf16): exact; kernel {p4['kernel']:.4f} ms, bound "
        f"{b4['bound_ms']:.4f} ms ({b4['bound_by']}): share "
        f"{b4['bound_ms'] / p4['kernel']:.1%}; plain {p4['plain']:.4f} ms; "
        f"index_select {p4['index_select']:.4f} ms (CUDA events)")
    out["row_gather"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **bound, "library_ms": lib_ms,
                         "library": "torch.index_select"}


def _grad_error(path: str, acc, gout, mat, depth,
                min_depth: float = 0.001) -> tuple:
    """The backward kernel's float32 sums ``acc`` against the plain
    gradient in float64 (the same rounded weights and grad_out), each batch
    item on its own: (worst error, largest |gradient| of that item). Fails
    unless every item's error is within GRAD_TOL of its largest
    |gradient|."""
    import torch

    from tandem_tpu_torch.ops.bilinear_sample import warp_sample_grad_plain
    ref = warp_sample_grad_plain(gout, mat, depth, min_depth,
                                 acc_dtype=torch.float64)
    worst = (0.0, 1.0)
    for b in range(ref.shape[0]):
        top = float(ref[b].abs().max())
        err = float((acc[b].double() - ref[b]).abs().max())
        if not (top > 0 and err <= GRAD_TOL * top and acc.dtype
                == torch.float32):
            raise AssertionError(f"{path}: item {b}'s gradient off by "
                                 f"{err:.3e} of max |grad| {top:.3e}")
        if err / top >= worst[0] / worst[1]:
            worst = (err, top)
    return worst


def _sweep_grad_kernel(dev, out: dict):
    """The plane-sweep sample's backward kernel (warp_sample_grad) at the
    abl04 640x480 stage shapes with B = 2, as training gives it: item 0
    the golden sweep with part of it behind the source camera, item 1 the
    golden sweep itself, f32 and bf16 grad_out; each item's float32 sums
    within GRAD_TOL of its largest |gradient| in float64; the kernel's
    time by events and by the profiler, the plain version's (torch ops,
    float32 sums), its byte bound, grid_sample's backward (the input's
    gradient) on the same grid, the samples a touched source cell and the
    atomics the kernel issues (experiments/grad_contention.py)."""
    import torch

    from tandem_tpu_torch.experiments.grad_contention import atomics, cells
    from tandem_tpu_torch.ops import bilinear_sample as bs
    from tandem_tpu_torch.ops.bilinear_sample import (sweep_positions,
                                                      warp_sample_grad,
                                                      warp_sample_grad_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            sweeps = [_golden_sweep(dev, stage, D, H, W, behind)
                      for behind in (True, False)]
            mat = torch.cat([m for m, _, _ in sweeps]).contiguous()
            depth = torch.cat([d for _, d, _ in sweeps]).contiguous()
            gout = torch.randn((2, D, H, W, C), generator=gen,
                               device=dev).to(dtype)
            acc = warp_sample_grad(gout, mat, depth)
            err, top = _grad_error(f"warp_sample_grad {dn} {stage}", acc,
                                   gout, mat, depth)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            px, py, z = sweep_positions(mat, depth, H, W)
            feat = torch.zeros((2, H, W, C), device=dev, dtype=dtype)
            nchw, grid = _grid_sample_args(feat, px, py, ~(z < 0.001), H, W)
            gnchw = gout.reshape(2, D * H, W, C).permute(0, 3, 1, 2) \
                .contiguous()

            def library():
                return torch.ops.aten.grid_sampler_2d_backward(
                    gnchw, nchw, grid, 0, 0, True, [True, False])

            def kernel():
                return warp_sample_grad(gout, mat, depth)
            t = {"kernel": cuda_ms(kernel, iters=50),
                 "plain": cuda_ms(lambda: warp_sample_grad_plain(
                     gout, mat, depth), iters=5),
                 "grid_sample": cuda_ms(library, iters=50)}
            dev_ms = {"kernel": _device_ms(kernel),
                      "grid_sample": _device_ms(library)}
            # The kernel reads grad_out only for the samples with a corner
            # in the image, in front of the source camera.
            read = int((~(z < 0.001) & (px > -1) & (px < W) & (py > -1)
                        & (py < H)).sum())
            vec = bs._grad_vec(C, gout.element_size(), gout.data_ptr())
            share = cells(mat, depth, H, W)
            ops = atomics(mat, depth, H, W, C, vec, bs.grad_tiling(
                2, D, H, W, C // vec, bs._sm_count(dev.index or 0)))
            bound = _bound(read * C * gout.element_size()
                           + _nbytes(mat, depth, acc),
                           gout.numel() // C * SAMPLE_OPS + read * 8 * C)
            log(f"[kernels] warp_sample_grad {stage} {dn} B=2 D={D} {W}x{H} "
                f"C={C} ({read / (gout.numel() // C):.1%} of the samples "
                f"read: in front of the source camera with a corner in its "
                f"image): sums within {err / top:.2e} of max |grad| "
                f"{top:.3e} (bar {GRAD_TOL:g}, each item); kernel "
                f"{t['kernel']:.4f} ms (events) "
                f"{dev_ms['kernel']:.4f} ms (device, the zeroing "
                f"included), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): share "
                f"{bound['bound_ms'] / dev_ms['kernel']:.1%} of the device "
                f"time; plain {t['plain']:.4f} ms; grid_sample backward "
                f"{t['grid_sample']:.4f} ms (events) "
                f"{dev_ms['grid_sample']:.4f} ms (device); "
                f"{share['per_cell']:.2f} samples a touched cell; atomics: "
                f"{ops['runs']:,} of {vec} channels "
                f"({ops['runs_scalar']:,} float32 additions; one thread a "
                f"sample would add {ops['per_sample']:,})")
            if stage == "stage1" and dtype == torch.float32:
                res.update(ms=t["kernel"], plain_ms=t["plain"],
                           device_ms=dev_ms["kernel"],
                           library_ms=t["grid_sample"],
                           library="grid_sample's backward (the input's "
                                   "gradient) on the warp's grid",
                           **bound)
    out["warp_sample_grad"] = res


def _variance_kernel(dev, out: dict):
    """The variance cost volume's step (warp_variance, one launch a source
    view) against its plain version at CasMVSNet's DTU stages, four source
    views a stage, in f32 and bf16: both sums equal after every view. A
    stage's four views in f32 timed against the plain version and against
    grid_sample with two in-place adds, and held against the bound of
    their bytes and operations (``benchmark/harness/variance.py``); the
    kernel's row is a keyframe's 12 launches, the three stages summed."""
    import torch
    import torch.nn.functional as F

    from benchmark.harness.variance import variance_work
    from tandem_tpu_torch.ops.bilinear_sample import (sweep_positions,
                                                      warp_variance,
                                                      warp_variance_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {"max_abs_err": 0.0}
    total = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "library_ms": 0.0,
             "bytes": 0, "ops": 0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in DTU_STAGE_SHAPES.items():
            views = range(1, DTU_SOURCE_VIEWS + 1)
            feats = [torch.randn((1, H, W, C), generator=gen,
                                 device=dev).to(dtype) for _ in views]
            sweeps = [_golden_sweep(dev, stage, D, H, W,
                                    shapes=DTU_STAGE_SHAPES, view=v)
                      for v in views]
            mats, depth = [m for m, _, _ in sweeps], sweeps[0][1]
            shape = (1, D, H, W, C)
            plain_sums = (torch.empty(shape, dtype=dtype, device=dev),
                          torch.empty(shape, dtype=dtype, device=dev))

            def kernel():
                sums = None
                for feat, mat in zip(feats, mats):
                    sums = warp_variance(feat, mat, depth, sums)
                return sums

            def plain():
                for i, (feat, mat) in enumerate(zip(feats, mats)):
                    warp_variance_plain(feat, mat, depth, *plain_sums,
                                        i == 0)
                return plain_sums
            launches = warp_variance.launches
            sums = None
            for i, (feat, mat) in enumerate(zip(feats, mats)):
                sums = warp_variance(feat, mat, depth, sums)
                warp_variance_plain(feat, mat, depth, *plain_sums, i == 0)
                res["max_abs_err"] = max(res["max_abs_err"], _exact(
                    f"warp_variance {dn} {stage} after source view {i + 1}",
                    sums, plain_sums))
            if warp_variance.launches - launches != DTU_SOURCE_VIEWS:
                raise AssertionError(
                    f"warp_variance {dn} {stage}: "
                    f"{warp_variance.launches - launches} launches for "
                    f"{DTU_SOURCE_VIEWS} source views")
            if dtype != torch.float32:   # the configuration's dtype is timed
                continue
            grids = []
            for feat, mat in zip(feats, mats):
                px, py, z = sweep_positions(mat, depth, H, W)
                grids.append(_grid_sample_args(feat, px, py, ~(z < 0.001),
                                               H, W))
            lib_sums = (torch.empty((1, C, D * H, W), dtype=dtype,
                                    device=dev),
                        torch.empty((1, C, D * H, W), dtype=dtype,
                                    device=dev))

            def library():
                for i, gs in enumerate(grids):
                    x = F.grid_sample(*gs, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)
                    if i == 0:
                        lib_sums[0].copy_(x)
                        torch.mul(x, x, out=lib_sums[1])
                    else:
                        lib_sums[0].add_(x)
                        lib_sums[1].addcmul_(x, x)
            library()      # the same sums (see warp_sample's grid_sample)
            lib = lib_sums[0].reshape(C, D, H, W).permute(1, 2, 3, 0)
            lib_err = float((lib - sums[0][0]).abs().max())
            if not lib_err <= 1e-3 * float(sums[0].abs().max()):
                raise AssertionError(f"grid_sample's sums differ from "
                                     f"warp_variance's at {stage}: {lib_err}")
            t = {"kernel": cuda_ms(kernel, iters=20),
                 "plain": cuda_ms(plain, iters=5),
                 "library": cuda_ms(library, iters=20)}
            dev_ms = _device_ms(kernel)
            nbytes = ops = 0
            for i in range(DTU_SOURCE_VIEWS):
                b, o = variance_work(D, H, W, C, dn, i == 0)
                nbytes, ops = nbytes + b, ops + o
            bound = _bound(nbytes, ops)
            log(f"[kernels] warp_variance {stage} {dn} D={D} {W}x{H} C={C}, "
                f"{DTU_SOURCE_VIEWS} source views: exact after every view, "
                f"{DTU_SOURCE_VIEWS} launches; kernel {t['kernel']:.4f} ms "
                f"(events) {dev_ms:.4f} ms (device), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB): share "
                f"{bound['bound_ms'] / dev_ms:.1%} of the device time; plain "
                f"{t['plain']:.4f} ms; grid_sample + add_/addcmul_ "
                f"{t['library']:.4f} ms (events)")
            total.update(ms=total["ms"] + t["kernel"],
                         plain_ms=total["plain_ms"] + t["plain"],
                         device_ms=total["device_ms"] + dev_ms,
                         library_ms=total["library_ms"] + t["library"],
                         bytes=total["bytes"] + nbytes,
                         ops=total["ops"] + ops)
            del feats, sweeps, mats, plain_sums, sums, grids, lib_sums
            torch.cuda.empty_cache()
    bound = _bound(total.pop("bytes"), total.pop("ops"))
    log(f"[kernels] warp_variance a 1152x864 f32 keyframe "
        f"({3 * DTU_SOURCE_VIEWS} launches): {total['device_ms']:.4f} ms "
        f"(device), bound {bound['bound_ms']:.4f} ms: share "
        f"{bound['bound_ms'] / total['device_ms']:.1%}")
    res.update(total, library="grid_sample on the warp's positions, then "
                              "add_ and addcmul_ into the two sums",
               **bound)
    out["warp_variance"] = res


def _tsdf_scene(dev, H: int, W: int, f: float):
    """A curved wall ~2 m away fused from two cameras by the plain
    integrator, at a mapping cell's image size and focal length, in the
    default TSDF (1 cm voxels); and the next scan (its band allocated) with
    the pose it is fused and rendered at, 5 degrees and ~12 cm from the
    first camera: (cfg, volume, depth, rgb, K, pose)."""
    import torch

    from tandem_tpu_torch.mapping import tsdf as tt

    def pose(deg, t):
        a = np.deg2rad(deg)
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        p[:3, 3] = t
        return torch.from_numpy(p).to(dev)

    K = torch.tensor([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]],
                     device=dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    wall = (2.013 + 0.3 * torch.sin(u * (7.0 / W)) * torch.cos(v * (5.0 / H))
            ).contiguous()
    rgb = torch.stack([100 + 150 * u / W, 60 + 190 * v / H,
                       200 - 150 * u / W], -1).contiguous()
    cfg = tt.TsdfConfig()
    vol = tt.create_volume(cfg, dev)
    for p in (pose(0.0, (0, 0, 0)), pose(10.0, (0.1, -0.05, 0.15))):
        tt.allocate_blocks(cfg, vol, wall, K, p)
        tt.integrate_plain(cfg, vol, wall, rgb, K, p)
    depth = (wall + 0.01).contiguous()
    p = pose(5.0, (0.05, 0.02, -0.1))
    tt.allocate_blocks(cfg, vol, depth, K, p)
    return cfg, vol, depth, rgb, K, p


def _tsdf_kernels(dev, out: dict):
    """The fusion kernels (csrc/tsdf_fuse.cu) against their plain versions
    at both mapping cells' image sizes (abl04 640x480, fx 375; CasMVSNet
    1152x864, fx 675) on a fused curved wall: integrate, the splat's full
    walk, the fill from the z-buffer and render_depth_splat bit for bit.
    Each timed by CUDA events and the profiler's device time beside the
    bound of its bytes, the plain version, and for the splat
    scatter_reduce's full walk and the CPU route's axis-culled splat (with
    its cull and host read, host clock); the keyframe's fusion after the
    allocation on the card's route (integrate + render) against the CPU
    route run on the card (cull, read, integrate, cull, read, render). The
    kernels' rows are the 640x480 numbers."""
    import torch

    from tandem_tpu_torch.mapping import tsdf as tt
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    rows = {}
    for (H, W, f) in ((480, 640, 375.0), (864, 1152, 675.0)):
        shape = f"{W}x{H}"
        cfg, vol, depth, rgb, K, p = _tsdf_scene(dev, H, W, f)
        n = vol.n_allocated
        got, want = tt.copy_volume(vol), tt.copy_volume(vol)
        tt.integrate(cfg, got, depth, rgb, K, p)
        tt.integrate_plain(cfg, want, depth, rgb, K, p)
        for name in ("tsdf", "weight", "color"):
            _exact(f"tsdf_integrate {shape} {name}", getattr(got, name),
                   getattr(want, name))
        changed = int(((got.weight != vol.weight)
                       | (got.tsdf != vol.tsdf))[:n].sum())
        zbuf = tt.splat_zbuf(cfg, got, K, p, H, W)
        zplain = tt.splat_zbuf_plain(cfg, got, K, p, H, W)
        _exact(f"tsdf_splat {shape}", zbuf, zplain)
        finite = torch.where(torch.isfinite(zplain), zplain,
                             torch.zeros_like(zplain)).reshape(H, W)
        filled = tt.fill_holes_plain(finite, 2)
        _exact(f"tsdf_fill_holes {shape}",
               tt._fill_holes(zbuf.reshape(H, W), 2, from_zbuf=True), filled)
        _exact(f"render_depth_splat {shape}",
               tt.render_depth_splat(cfg, got, K, p, H, W), filled)
        shown = int(tt._frustum_mask(cfg, K, p, H, W,
                                     got.block_coords[:n]).sum())
        b3 = cfg.block_size ** 3
        work = {
            "integrate": (lambda: tt.integrate(cfg, got, depth, rgb, K, p),
                          lambda: tt.integrate_plain(cfg, want, depth, rgb,
                                                     K, p),
                          n * 12 + changed * 40 + H * W * 20),
            "splat": (lambda: tt.splat_zbuf(cfg, got, K, p, H, W),
                      lambda: tt.splat_zbuf_plain(cfg, got, K, p, H, W),
                      n * 12 + shown * b3 * 8 + H * W * 8),
            "fill_holes": (lambda: tt._fill_holes(zbuf.reshape(H, W), 2,
                                                  from_zbuf=True),
                           lambda: tt.fill_holes_plain(finite, 2),
                           2 * H * W * 8)}
        for name, (kernel, plain, nbytes) in work.items():
            bound = _bound(nbytes, 0)
            row = {"ms": cuda_ms(kernel), "device_ms": _device_ms(kernel),
                   "plain_ms": cuda_ms(plain), **bound}
            row["share"] = bound["bound_ms"] / row["device_ms"]
            rows[(name, shape)] = row
        slots3, counts3 = tt.surface_axis_slots(cfg, got, K, p, H, W)
        counts = counts3.tolist()
        axis_ms = cuda_ms(lambda: tt.splat_zbuf_plain(
            cfg, got, K, p, H, W, axis_slots=slots3, axis_counts=counts))
        rows[("splat", shape)]["library_ms"] = axis_ms

        def card_route():
            tt.integrate(cfg, got, depth, rgb, K, p)
            return tt.render_depth_splat(cfg, got, K, p, H, W)

        def cpu_route():
            slots, n_vis = tt.visible_slots(cfg, want, K, p, H, W)
            n_vis = int(n_vis)
            if n_vis < 0.5 * n:
                tt.integrate_culled(cfg, want, depth, rgb, K, p, slots, n_vis)
            else:
                tt.integrate_plain(cfg, want, depth, rgb, K, p)
            s3, c3 = tt.surface_axis_slots(cfg, want, K, p, H, W)
            zb = tt.splat_zbuf_plain(cfg, want, K, p, H, W, axis_slots=s3,
                                     axis_counts=c3.tolist())
            return tt.fill_holes_plain(torch.where(
                torch.isfinite(zb), zb, torch.zeros_like(zb)).reshape(H, W),
                2)

        route_ms, _ = _median_ms(card_route)
        old_ms, _ = _median_ms(cpu_route)
        log(f"[kernels] tsdf {shape}: n_allocated {n}, {changed} voxels "
            f"updated, {shown} blocks in the frustum, axis counts {counts}; "
            f"integrate, splat, fill and render exact")
        for name in work:
            r = rows[(name, shape)]
            log(f"[kernels] tsdf_{name} {shape}: kernel {r['ms']:.4f} ms "
                f"events, {r['device_ms']:.4f} ms device; bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}): share "
                f"{r['share']:.1%}; plain {r['plain_ms']:.4f} ms"
                + (f"; the CPU route's axis-culled scatter_reduce splat "
                   f"{r['library_ms']:.4f} ms" if name == "splat" else ""))
        log(f"[kernels] tsdf {shape}: a keyframe's integrate + render, "
            f"card route {route_ms:.3f} ms, CPU route on the card "
            f"{old_ms:.3f} ms (host clock, synced, median of 5)")
    for name in ("integrate", "splat", "fill_holes"):
        r = rows[(name, "640x480")]
        out[f"tsdf_{name}"] = {
            "max_abs_err": 0.0, "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "at_1152x864": rows[(name, "1152x864")]}
        if name == "splat":
            out["tsdf_splat"].update(
                library_ms=r["library_ms"],
                library="the CPU route's axis-culled scatter_reduce splat")


def phase_kernels(dev) -> dict:
    out = {}
    _edge_kth(dev, out)
    _sample_kernels(dev, out)
    _sweep_kernels(dev, out)
    _sweep_grad_kernel(dev, out)
    _variance_kernel(dev, out)
    _tsdf_kernels(dev, out)
    _row_gather(dev, out)
    return out


def phase_probes() -> dict:
    from tandem_tpu_torch.experiments import (gather_probe, idxchain_probe,
                                              shuffle_probe)
    reset_counts()
    for probe in (gather_probe, shuffle_probe, idxchain_probe):
        log(f"[probes] {probe.__name__}")
        probe.main()
    counts = read_counts()
    require_launched("probes", counts,
                     ("row_gather", "corner_blend", "bilinear_index"))
    return counts


def phase_casmvsnet(dev) -> dict:
    """CasMVSNet's map path at its DTU test size: MvsnetRunner at 5 views
    and 1152x864 in f32 with a unit of seeded weights (the benchmark's
    ``mapping_seeded.write_unit``, its BatchNorm statistics calibrated on
    the benchmark's scene) on one of the scene's keyframe windows. The
    eager call, the call that captures the CUDA graph and a replay give
    the same four outputs bit for bit, each with 12 warp_variance
    launches (3 stages x 4 source views), counted at each replay, and
    one edge filter call; warp_sample launches none. Returns the
    launches."""
    import tempfile

    import torch

    from benchmark.traffic import mapping_seeded
    from tandem_tpu_torch.cli.golden import load_model_config
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    bench = REPO / "benchmark"
    config = json.loads((bench / "configs" /
                         "casmvsnet_dtu_1152x864.json").read_text())
    traffic = json.loads((bench / "workloads" /
                          "kf_stream_seeded.json").read_text())
    im = config["image"]
    V = config["views"]
    windows = mapping_seeded.calibration_windows(config, traffic, dev)
    reset_counts()
    with tempfile.TemporaryDirectory() as unit:
        mapping_seeded.write_unit(Path(unit), config["model"], 2 ** 31 + 19,
                                  dev, windows)
        runner = MvsnetRunner(
            CvaMVSNet(**load_model_config(unit)),
            load_variables(str(Path(unit) / "model_variables.pkl")),
            im["height"], im["width"], view_num=V, device=dev)
    rec = windows[0]
    names = ("depth", "confidence", "depth_dense", "confidence_dense")
    outs, served, per_call = [], [], []
    for _ in range(3):
        before, calls = read_counts(), edge_calls()
        t0 = time.perf_counter()
        runner.call_async(rec["bgrs"], rec["c2w"], rec["K"], rec["dmin"],
                          rec["dmax"], rec["discard"])
        got = runner.get_result(device=True)
        outs.append([got[k].clone() for k in names])
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
        served.append(runner._forward.served)
        after = read_counts()
        if (after["warp_variance"] - before["warp_variance"]
                != 3 * (V - 1) or edge_calls() - calls != 1):
            raise AssertionError(
                f"casmvsnet {served[-1]}: warp_variance launched "
                f"{after['warp_variance'] - before['warp_variance']} times "
                f"and the edge filter {edge_calls() - calls} (need "
                f"{3 * (V - 1)} and 1)")
    if served != ["eager", "capture", "replay"]:
        raise AssertionError(f"casmvsnet: the runner served {served}")
    for call, out in zip(served[1:], outs[1:]):
        if not all(torch.equal(a, b) for a, b in zip(out, outs[0])):
            raise AssertionError(f"casmvsnet: the {call} differs from the "
                                 "eager call")
    counts = read_counts()
    require_not_launched("casmvsnet", counts, ("bilinear_sample",))
    depth = outs[0][2]
    log(f"[casmvsnet] {im['width']}x{im['height']} V={V} f32 seeded "
        f"(calibrated) weights: eager, capture and replay equal bit for "
        f"bit, {3 * (V - 1)} warp_variance launches and 1 edge filter a "
        f"call; ms a call (host clock, synced) "
        + ", ".join(f"{s} {t:.1f}" for s, t in zip(served, per_call))
        + f"; depth {float(depth.min()):.3f}-{float(depth.max()):.3f} m "
        f"(std {float(depth.std()):.3f}); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB")
    del runner, outs
    torch.cuda.empty_cache()
    return counts


def load_runner(dev, dtype):
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    pack = np.load(UNIT / "sample_inputs.npz")
    V, H, W = pack["image"].shape[1], pack["image"].shape[3], \
        pack["image"].shape[4]
    runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=dtype),
                          load_variables(UNIT / "model_variables.pkl"),
                          H, W, view_num=V, device=dev)
    return runner, pack


def _golden_forward(runner, pack, dev, scale: float = 1.0):
    """The unit's model on the golden pack (the image times ``scale``)."""
    import torch
    return runner.model(
        torch.from_numpy(pack["image"].astype(np.float32) / 255.0
                         * np.float32(scale)).to(dev),
        [torch.from_numpy(pack[k]).to(dev) for k in ("K1", "K2", "K3")],
        torch.from_numpy(pack["cam_to_world"]).to(dev),
        torch.from_numpy(pack["depth_min"]).to(dev),
        torch.from_numpy(pack["depth_max"]).to(dev),
        torch.full((1,), float(pack["discard_percentage"])))


def _determinism(runner, pack, dev, first) -> None:
    """The f32 forward again, and again under
    torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG is set at
    the top of this script): all 12 outputs must equal the first run's."""
    import torch

    from tandem_tpu_torch.utils.digest import digest

    def equal(out):
        return all(torch.equal(a, b) for sa, sb in zip(first, out)
                   for a, b in zip(sa, sb))
    again = equal(_golden_forward(runner, pack, dev))
    torch.use_deterministic_algorithms(True)
    try:
        strict = equal(_golden_forward(runner, pack, dev))
    except RuntimeError as e:          # an op with no deterministic form
        strict = f"raised: {str(e)[:300]}"
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[golden] float32 outputs sha256 {digest(first)}; a second run "
        f"equal: {again}; under use_deterministic_algorithms equal: {strict}"
        f" (cudnn.deterministic {torch.backends.cudnn.deterministic})")
    if not (again and strict is True):
        raise AssertionError("the f32 golden forward is not deterministic")


def phase_golden(runner, pack, dev, tol: float) -> float:
    import torch
    dn = str(runner.dtype).split(".")[-1]
    before, calls = read_counts(), edge_calls()
    t0 = time.perf_counter()
    out = _golden_forward(runner, pack, dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after, calls = read_counts(), edge_calls() - calls
    worst, worst_key = 0.0, ""
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            got = getattr(getattr(out, s), f)
            if got.dtype != torch.float32:
                raise AssertionError(f"golden {s}.{f} is {got.dtype}")
            got = got.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"golden {s}.{f} is not finite")
            mae = float(np.abs(got - pack[f"out.{s}.{f}"]).mean())
            if mae > worst:
                worst, worst_key = mae, f"{s}.{f}"
    delta = {k: after[k] - before[k] for k in after}
    _, V, _, H, W = pack["image"].shape
    edge = require_edge_filter(f"{dn} golden", delta["edge_kth"], calls, 3)
    log(f"[golden] exported/{UNIT.name} {W}x{H} V={V} {dn}: worst MAE "
        f"{worst:.3e} "
        f"({worst_key}), bar {tol}, first call {secs:.3f} s, launches "
        f"{delta}; {edge}")
    if not worst < tol:
        raise AssertionError(f"{dn} golden MAE {worst:.3e} >= {tol}")
    require_launched(f"{dn} golden", delta, ("bilinear_sample",))
    require_not_launched(f"{dn} golden", delta,
                         ("bilinear_index", "corner_blend"))
    log(f"[golden] {dn} " + profiled_edge_filter(
        f"{dn} golden", lambda: _golden_forward(runner, pack, dev)))
    if runner.dtype == torch.float32:
        _determinism(runner, pack, dev, out)
    return worst


def golden_window(pack):
    """The pack's 7 views as a runtime window: the pack is ref-first, so
    view 0 goes back to index V-2; RGB back to BGR uint8."""
    rgb = pack["image"][0]                     # (V, 3, H, W) uint8
    c2w = pack["cam_to_world"][0]
    V = rgb.shape[0]
    order = list(range(1, V - 1)) + [0, V - 1]
    bgrs = [np.ascontiguousarray(rgb[i].transpose(1, 2, 0)[..., ::-1])
            for i in order]
    return bgrs, [c2w[i] for i in order], c2w[0]


def phase_slice(runner, pack, dev, profile: Path = None) -> dict:
    import torch

    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    dn = str(runner.dtype).split(".")[-1]
    cfg = TsdfConfig()
    K = pack["K3"][0]
    H, W = runner.height, runner.width
    bgrs, poses, ref_pose = golden_window(pack)
    dmin, dmax = float(pack["depth_min"][0]), float(pack["depth_max"][0])
    backend = TandemBackend(runner, cfg, K, H, W, mesh_extraction_freq=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    call_ms = []
    for _ in range(N_KEYFRAMES):
        t0 = time.perf_counter()
        backend.call(bgrs, poses, dmin, dmax, ref_pose)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    edge = require_edge_filter(f"{dn} slice", counts["edge_kth"],
                               edge_calls(), N_KEYFRAMES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[slice {dn}] {N_KEYFRAMES} backend calls: launches {counts} "
        f"({edge}), n_allocated {backend.stats()['n_allocated']}, peak "
        f"memory {peak_gb:.3f} GB, call ms {[round(x, 3) for x in call_ms]}")
    require_launched(f"{dn} slice", counts, ("bilinear_sample",),
                     N_KEYFRAMES)
    # Each call after the first fuses a keyframe through the fusion kernels.
    require_launched(f"{dn} slice", counts, ("tsdf_integrate", "tsdf_splat"),
                     N_KEYFRAMES - 1)
    require_launched(f"{dn} slice", counts, ("tsdf_fill_holes",),
                     2 * (N_KEYFRAMES - 1))
    require_not_launched(f"{dn} slice", counts,
                         ("bilinear_index", "corner_blend"))

    rdepth = backend.get_tracking_depth_map()["depth"]
    mvs = runner.get_result(device=True)["depth"]
    if mvs.dtype != torch.float32:
        raise AssertionError(f"MVSNet depth handed to fusion is {mvs.dtype}")
    rd, md = rdepth.cpu().numpy(), mvs.cpu().numpy()
    if rd.shape != (H, W) or not np.isfinite(rd).all() or (rd < 0).any():
        raise AssertionError("rendered depth not finite / non-negative")
    want = (md >= cfg.min_depth) & (md <= cfg.max_depth)
    hit = float((rd[want] > 0).mean())
    both = want & (rd > 0)
    med = float(np.median(np.abs(rd[both] - md[both])))
    log(f"[slice {dn}] render vs MVSNet depth: hit share {hit:.4f}, median "
        f"|err| {med * 100:.3f} cm over {int(both.sum())} px")
    if not (hit > 0.8 and med < 2 * cfg.voxel_size):
        raise AssertionError("rendered depth disagrees with MVSNet depth")

    # Per-keyframe parts, each ended by a device sync.
    from tandem_tpu_torch.mapping.tsdf import (allocate_blocks, integrate,
                                               render_depth_splat)
    Kt = torch.from_numpy(K).to(dev)
    pose = torch.from_numpy(ref_pose).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(
        bgrs[-2][..., ::-1], dtype=np.float32)).to(dev)

    def mvsnet():
        runner.call_async(bgrs, poses, K, dmin, dmax)
        return runner.get_result(device=True)["depth"]

    def fuse(depth):
        allocate_blocks(backend.cfg, backend.volume, depth, Kt, pose)
        integrate(backend.cfg, backend.volume, depth, rgb, Kt, pose)
        render_depth_splat(backend.cfg, backend.volume, Kt, pose, H, W)

    pack_ms, mvs_ms, fuse_ms = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        runner.pack_inputs(bgrs, poses, K)
        t1 = time.perf_counter()
        depth = mvsnet()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fuse(depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pack_ms.append((t1 - t0) * 1e3)
        mvs_ms.append((t2 - t1) * 1e3)
        fuse_ms.append((t3 - t2) * 1e3)
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            fuse(mvsnet())
            torch.cuda.synchronize()
        events = p.key_averages()
        log(events.table(sort_by="cuda_time_total", row_limit=30))
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        log(f"[slice {dn}] profiled keyframe: {sum(e.count for e in device)}"
            f" device events (kernels and copies), device busy "
            f"{sum(e.self_device_time_total for e in device) / 1e3:.3f} ms")
        profile.mkdir(parents=True, exist_ok=True)
        p.export_chrome_trace(str(profile / f"keyframe_trace_{dn}.json"))
    m, f = float(np.median(mvs_ms)), float(np.median(fuse_ms))
    log(f"[slice {dn}] per keyframe (host clock, synced, median of 5): "
        f"MVSNet {m:.3f} ms (of which host input packing alone "
        f"{float(np.median(pack_ms)):.3f} ms), fusion "
        f"(allocate+integrate+render) {f:.3f} ms, total {m + f:.3f} ms = "
        f"{1000.0 / (m + f):.3f} KF/s (reference GPU bar 201 ms/KF for the "
        f"MVSNet alone)")
    return counts, backend


def _stage3_digest(outputs) -> str:
    from tandem_tpu_torch.utils.digest import digest
    return digest([outputs])


def _golden_digest(runner, pack, dev) -> str:
    from tandem_tpu_torch.utils.digest import digest
    return digest(_golden_forward(runner, pack, dev))


def _first_differing_program_op(program, eager, args) -> str:
    """Both forwards traced op by op (every aten op and custom op on the
    card with a checksum of its output, in call order): the first op whose
    name or output differs."""
    from tandem_tpu_torch.experiments.determinism import _traced_run
    import torch
    with torch.no_grad():
        a, b = _traced_run(program, args), _traced_run(eager, args)
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"op {i}: program {x[0]} vs eager {y[0]}"
    return f"no traced op differs ({len(a)} and {len(b)} ops)"


def phase_export(dev, pkl_ate: float) -> dict:
    """tandem_export on the card: the trained abl04 unit (exported/tandem's
    weights, 48/4/4 planes, view aggregation, f32) at 640x480, V = 7, into
    a temporary directory (main's own replays through model.pt2 and the
    eager model under GOLDEN_TOL); the repo's golden pack replayed through
    the saved program from a fresh torch.export.load: worst MAE over the
    four stage-3 outputs < GOLDEN_TOL, warp_sample launched 18 times and
    the edge filter once (its kernels), P5 and P3 not; the program's
    stage-3 sha256 beside the eager f32 model's (the first differing op
    named if they differ); a runner keyframe served from the program
    (ExportedRunner) and from the f32 model's CUDA graph (MvsnetRunner),
    host clock, synced, median of 5 after a warm-up. Meanwhile a second process
    runs ``python -m tandem_tpu_torch.cli.tandem_export`` at
    replica_traj's 256x192 on the fixture's first "val" window; a
    weightless unit of its model.pt2, device record, model_config.json and
    pack serves tandem_dataset on the fixture's 64 frames: the boot
    self-check, >= SLAM_MIN_FRAMES frames and ATE (Sim3) < SLAM_ATE_BOUND,
    printed beside ``pkl_ate``, the slam phase's full run with the pkl
    unit (bf16)."""
    import contextlib
    import io
    import shutil
    import subprocess
    import tempfile
    from types import SimpleNamespace

    import torch

    from tandem_tpu_torch.cli import tandem_export as te
    from tandem_tpu_torch.models.cva_mvsnet import Stage3Forward
    from tandem_tpu_torch.pipeline.mvsnet_runner import ExportedRunner
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    pack = np.load(UNIT / "sample_inputs.npz")
    _, V, _, H, W = pack["image"].shape
    label = card_label_once()
    work = Path(tempfile.mkdtemp(prefix="export_"))
    proc = None
    try:
        # The weightless unit at the fixture's size, exported by the CLI as
        # a user runs it, in a second process while this one exports and
        # replays the 640x480 unit (both are mostly host-side tracing).
        small = work / "small"
        small_log = work / "small.log"
        t_small = time.perf_counter()
        with open(small_log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tandem_tpu_torch.cli.tandem_export",
                 "--ckpt", str(UNIT / "model_variables.pkl"),
                 "--out-dir", str(small), "--width", "256", "--height",
                 "192", "--view-num", str(V), "--depth-num",
                 ",".join(str(d) for d in cfg["depth_num"]),
                 "--data-root", str(FIXTURE.parent), "--device", dev.type],
                cwd=REPO, stdout=f, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        res = te.main(SimpleNamespace(
            ckpt=str(UNIT / "model_variables.pkl"), out_dir=str(work / "unit"),
            data_root=None, width=W, height=H, view_num=V,
            discard_percentage=float(pack["discard_percentage"]),
            view_aggregation=cfg["view_aggregation"],
            depth_num=",".join(str(d) for d in cfg["depth_num"]),
            device=dev.type))
        main_s = time.perf_counter() - t0
        log(f"[export] tandem_export.main at {W}x{H} V={V} depth_num "
            f"{cfg['depth_num']}: {main_s:.1f} s in all, torch.export + "
            f"save {res['export_s']:.1f} s, model.pt2 "
            f"{(work / 'unit' / te.PROGRAM).stat().st_size} bytes; its pack "
            f"replayed through model.pt2 MAE {res['exported_mae']:.3e}, "
            f"through the eager model {res['golden_mae']:.3e} ({label})")

        program, served = te.load_program(str(work / "unit"))
        module = program.module()
        x = te.program_inputs(pack, float(pack["discard_percentage"]), dev)
        torch.cuda.synchronize()
        reset_counts()
        calls0 = edge_calls()
        with torch.no_grad():
            outs = module(*x)
        torch.cuda.synchronize()
        counts = read_counts()
        edge = require_edge_filter("export replay", counts["edge_kth"],
                                   edge_calls() - calls0, 1)
        if counts["bilinear_sample"] != 3 * (V - 1):
            raise AssertionError(f"export replay: warp_sample launched "
                                 f"{counts['bilinear_sample']} times, want "
                                 f"{3 * (V - 1)}")
        require_not_launched("export replay", counts,
                             ("bilinear_index", "corner_blend"))
        worst = max(float(np.abs(pack["out." + k]
                                 - v.float().cpu().numpy()).mean())
                    for k, v in zip(te.STAGE3, outs))
        log(f"[export] exported/{UNIT.name}/sample_inputs.npz through a "
            f"fresh torch.export.load of model.pt2 on {served}: worst MAE "
            f"{worst:.3e} over the 4 stage-3 outputs (bar {GOLDEN_TOL}); "
            f"launches {counts}; {edge}")
        if not worst < GOLDEN_TOL:
            raise AssertionError(f"export replay MAE {worst:.3e}")

        runner, _ = load_runner(dev, torch.float32)
        eager = Stage3Forward(runner.model)
        with torch.no_grad():
            want = eager(*x)
        prog_digest, eager_digest = _stage3_digest(outs), _stage3_digest(want)
        equal = prog_digest == eager_digest
        log(f"[export] stage-3 outputs sha256: program {prog_digest}, eager "
            f"f32 model {eager_digest}, equal: {equal}; the eager 12 "
            f"outputs' sha256 (the golden phase's): "
            f"{_golden_digest(runner, pack, dev)}")
        if not equal:
            log("[export] first differing op: "
                + _first_differing_program_op(module, eager, x))

        if proc.wait(timeout=600) != 0:
            raise AssertionError("export: tandem_export at 256x192 failed:\n"
                                 + small_log.read_text()[-3000:])
        small_s = time.perf_counter() - t_small
        exported = ExportedRunner(str(work / "unit"), H, W, view_num=V,
                                  device=dev)
        bgrs, poses, _ = golden_window(pack)
        K = pack["K3"][0]
        dmin, dmax = float(pack["depth_min"][0]), float(pack["depth_max"][0])
        times = {}
        for name, r in (("program", exported), ("graphed f32", runner),
                        ("program again", exported),
                        ("graphed f32 again", runner)):
            def keyframe():
                r.call_async(bgrs, poses, K, dmin, dmax)
                return r.get_result(device=True)
            keyframe()
            times[name] = round(_median_ms(keyframe)[0], 3)
        log(f"[export] ms a runner keyframe at {W}x{H} (host clock, synced, "
            f"median of 5 after a warm-up; ExportedRunner on model.pt2 vs "
            f"MvsnetRunner f32): {times} ({label})")
        del runner, exported, module, program
        torch.cuda.empty_cache()

        unit = work / "weightless"
        unit.mkdir()
        for name in (te.PROGRAM, te.PROGRAM_INFO, "model_config.json",
                     "sample_inputs.npz"):
            shutil.copy(small / name, unit / name)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            r = _slam_run(dev, work / "slam", True, unit=unit)
        boot = [ln for ln in out.getvalue().splitlines()
                if "self-check" in ln]
        nf = r["res"]["frames"]
        log(f"[export] weightless unit ({sorted(os.listdir(unit))}, "
            f"exported at 256x192 by python -m "
            f"tandem_tpu_torch.cli.tandem_export in a second process, "
            f"{small_s:.1f} s to its end; "
            + " | ".join(ln for ln in small_log.read_text().splitlines()
                         if "exported" in ln or "error" in ln)
            + f"): tandem_dataset "
            f"{boot}; frames {nf}, {r['res']['seconds']:.3f} s, FPS "
            f"{nf / r['res']['seconds']:.3f}, keyframes {r['kfs']}, backend "
            f"calls {r['res']['backend'].call_num}; ATE "
            f"{r['ate']['rmse'] * 1e3:.3f} mm (Sim3, {r['pairs']}/64 frames; "
            f"bound {SLAM_ATE_BOUND * 1e3} mm; the pkl unit in bf16, the "
            f"slam phase's full run: {pkl_ate * 1e3:.3f} mm) ({label})")
        if not boot or r["pairs"] < SLAM_MIN_FRAMES or not (
                r["ate"]["rmse"] < SLAM_ATE_BOUND):
            raise AssertionError(f"export slam: boot {boot}, {r['pairs']} "
                                 f"frames, ATE {r['ate']['rmse'] * 1e3:.3f} "
                                 "mm")
        if r["res"]["backend"].call_num < 1:
            raise AssertionError("export slam: the backend was never called")
        require_launched("export slam", r["counts"],
                         ("bilinear_sample", "track_reduce", "track_lm"))
        require_edge_filter("export slam", r["counts"]["edge_kth"],
                            r["edge_calls"], 1)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"export_replay": counts, "export_slam": r["counts"]}


def phase_wall(dev):
    """tests/test_tsdf.py::test_render_depth_splat_wall at 640x480 with the
    default TSDF configuration."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate,
                                               render_depth_splat)
    H, W = 480, 640
    cfg = TsdfConfig()
    K = torch.tensor([[499.2, 0, 319.5], [0, 499.2, 239.5], [0, 0, 1]],
                     device=dev)
    pose = torch.eye(4, device=dev)
    depth = torch.full((H, W), 2.0, device=dev)
    color = torch.full((H, W, 3), 100.0, device=dev)
    vol = allocate_blocks(cfg, create_volume(cfg, dev), depth, K, pose)
    for _ in range(3):
        integrate(cfg, vol, depth, color, K, pose)
    r = render_depth_splat(cfg, vol, K, pose, H, W).cpu().numpy()
    crop = r[64:-64, 64:-64]
    hit = crop > 0
    med = float(np.median(np.abs(crop[hit] - 2.0)))
    pose2 = torch.tensor([[1, 0, 0, 0.15], [0, 1, 0, 0.0], [0, 0, 1, -0.3],
                          [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    r2 = render_depth_splat(cfg, vol, K, pose2, H, W).cpu().numpy()
    c2 = r2[80:-80, 112:-112]
    hit2 = c2 > 0
    med2 = float(np.median(np.abs(c2[hit2] - 2.3)))
    log(f"[wall] 640x480 n_allocated {vol.n_allocated}: hit {hit.mean():.4f} "
        f"median err {med * 100:.3f} cm; shifted pose hit "
        f"{hit2.mean():.4f} median err {med2 * 100:.3f} cm")
    if not (hit.mean() > 0.97 and med < 1.5 * cfg.voxel_size
            and hit2.mean() > 0.9 and med2 < 2 * cfg.voxel_size):
        raise AssertionError("TSDF wall contract failed at 640x480")


# --- the tracker ------------------------------------------------------------

def _track_case(dev, N: int, B: int, H: int, W: int, seed: int):
    """A level's point list, planes and candidates for K6: a smooth
    textured image, points on integer pixels with a 10% invalid share and a
    5% photometric-outlier share (past the cutoff), poses within ~1 cm /
    0.6 degrees of the identity; f32/f64 ties dropped (_drop_ties)."""
    import torch

    from tandem_tpu_torch.core.pyramid import gradients
    from tandem_tpu_torch.core.se3 import se3_exp
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (120 + 50 * np.sin(0.07 * xx) * np.cos(0.05 * yy)
           + 30 * np.sin(0.23 * xx + 1) + 20 * np.cos(0.31 * yy + 2)
           ).astype(np.float32)
    pu = rng.randint(0, W, N).astype(np.float32)
    pv = rng.randint(0, H, N).astype(np.float32)
    col = img[pv.astype(int), pu.astype(int)] + rng.normal(0, 4, N)
    col += (rng.rand(N) < 0.05) * rng.uniform(30, 80, N)
    pts = (pu, pv, rng.uniform(0.2, 0.8, N).astype(np.float32),
           col.astype(np.float32), rng.rand(N) < 0.9)
    T = se3_exp(torch.from_numpy(
        rng.uniform(-0.01, 0.01, (B, 6)).astype(np.float32)))
    aff = np.stack([1 + rng.uniform(-0.05, 0.05, B),
                    rng.uniform(-3, 3, B)], -1).astype(np.float32)
    planes = (torch.from_numpy(img),) + gradients(torch.from_numpy(img))
    K = (0.78 * W, 0.78 * W, (W - 1) / 2, (H - 1) / 2)
    case = (T.to(dev), torch.from_numpy(aff).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in pts),
            tuple(p.contiguous().to(dev) for p in planes), K)
    return _drop_ties(*case)


def _double(T, aff, pts, planes, K):
    return (T.double(), aff.double(),
            tuple(p.double() if p.is_floating_point() else p for p in pts),
            tuple(p.double() for p in planes), K)


def _drop_ties(T, aff, pts, planes, K):
    """Invalidate the points whose border or cutoff test comes out
    differently in f32 and in f64 (a residual within rounding of the
    cutoff, a projection within rounding of the border): one such point
    moves the sums by its whole term, which says nothing of the kernel's
    arithmetic. The kernel keeps the same points as the plain f32 version
    (``num`` equal) either way."""
    from tandem_tpu_torch.ops.track_reduce import CUTOFF_TH, level_residuals
    r32, _, g32, _, _ = level_residuals(T, aff, pts, planes, K)
    r64, _, g64, _, _ = level_residuals(*_double(T, aff, pts, planes, K))
    tie = ((g32 != g64) | ((r32.abs() < CUTOFF_TH)
                           != (r64.abs() < CUTOFF_TH))).any(0)
    return T, aff, pts[:4] + (pts[4] & ~tie,), planes, K


def _track_shapes():
    """(N, H, W, max_iter) of the tracker's levels: the 640x480 level-0
    cap, then the six 256x192 levels (the level caps of a dense
    reference, the LM iteration caps of coarse_tracker.MAX_ITERS)."""
    from tandem_tpu_torch.tracking.coarse_tracker import MAX_ITERS, _level_caps
    shapes = [(_level_caps(480, 640, True)[0], 480, 640, MAX_ITERS[0])]
    shapes += [(cap, 192 >> lvl, 256 >> lvl, MAX_ITERS[lvl])
               for lvl, cap in enumerate(_level_caps(192, 256, True))]
    return shapes


def _track_bound(T, aff, pts, planes, outs, evaluations: int,
                 tdist: bool = False) -> dict:
    """Bound of ``evaluations`` K6 evaluations of one level: the points,
    planes and poses read once and ``outs`` written once, against
    TRACK_OPS (and TDIST_OPS in the t-mode) per valid point and candidate
    for each evaluation."""
    ops = (evaluations * (TRACK_OPS + TDIST_OPS * tdist)
           * int(pts[4].sum()) * T.shape[0])
    return _bound(_nbytes(T, aff, *pts, *planes, *outs), ops)


def phase_track_kernels(dev, out: dict):
    """K6 in both weightings against the float64 plain version at the
    tracker's level caps: one launch a call, num equal to the plain f32
    version's, both times by CUDA events and the kernel's by the
    profiler."""
    import torch

    from tandem_tpu_torch.ops.track_reduce import (cluster_plan,
                                                   track_reduce,
                                                   track_reduce_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    shapes = [shape[:3] for shape in _track_shapes()]
    worst, times = 0.0, {}
    for tdist in (False, True):
        mode = "t" if tdist else "huber"
        for i, (N, H, W) in enumerate(shapes):
            for B in (1, 5, 15):
                case = _track_case(dev, N, B, H, W, 10 * i + B)
                before = track_reduce.launches
                got = track_reduce(*case, tdist=tdist)
                launches = track_reduce.launches - before
                f32 = track_reduce_plain(*case, tdist)
                f64 = track_reduce_plain(*_double(*case), tdist)
                torch.cuda.synchronize()
                if launches != 1:
                    raise AssertionError(f"K6 {mode}: {launches} launches "
                                         "a call")
                if not torch.equal(got[1], f32[1]):
                    raise AssertionError(f"K6 {mode} num {got[1].tolist()} "
                                         f"!= plain {f32[1].tolist()} at "
                                         f"N={N} B={B}")

                def errs(x):   # (worst relative, worst absolute) over outputs
                    d = [((a.double() - b).abs().max(), b.abs().max())
                         for j, (a, b) in enumerate(zip(x, f64)) if j != 1]
                    return (max(float(e / m.clamp_min(1e-30)) for e, m in d),
                            max(float(e) for e, _ in d))
                (err, abs_err), (err32, _) = errs(got), errs(f32)
                worst = max(worst, abs_err)
                if not err <= TRACK_TOL:
                    raise AssertionError(f"K6 {mode} at N={N} {H}x{W} B={B}: "
                                         f"rel err {err:.3e} > {TRACK_TOL}")
                ms = cuda_ms(lambda: track_reduce(*case, tdist=tdist))
                dev_ms = _device_ms(lambda: track_reduce(*case, tdist=tdist))
                plain_ms = cuda_ms(lambda: track_reduce_plain(*case, tdist))
                times[(tdist, N, B)] = (ms, dev_ms, plain_ms, _track_bound(
                    *case[:4], got, 1, tdist))
                log(f"[track kernels] {mode} N={N} level {W}x{H} B={B} "
                    f"({cluster_plan(N, tdist)['C']} CTAs a candidate): num "
                    f"{int(got[1].sum())} equal; rel err vs f64 kernel "
                    f"{err:.3e} (abs {abs_err:.4g}), plain f32 {err32:.3e} "
                    f"(tol {TRACK_TOL}); one launch; kernel {ms:.4f} ms "
                    f"events, {dev_ms:.4f} ms device; plain "
                    f"{plain_ms:.4f} ms")
    for tdist in (False, True):
        ms, dev_ms, plain_ms, bound = times[(tdist, shapes[0][0], 15)]
        log(f"[track kernels] {'t' if tdist else 'huber'} N={shapes[0][0]} "
            f"B=15: events {ms:.4f} ms, device {dev_ms:.4f} ms, bound "
            f"{bound}, share of the device time "
            f"{100 * bound['bound_ms'] / dev_ms:.2f}%")
    ms, dev_ms, plain_ms, bound = times[(False, shapes[0][0], 15)]
    out["track_reduce"] = {"max_abs_err": worst, "ms": ms,
                           "device_ms": dev_ms, "plain_ms": plain_ms,
                           **bound, "library_ms": None}


def _cast(x, dtype):
    import torch
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _lm_compare(where, prev, got, pts, planes, K, max_iter, dtype,
                tdist: bool = False) -> dict:
    """Hold one kernel step (the state ``prev`` to ``got``) against
    lm_step_plain from ``prev`` evaluated in ``dtype`` (float64 for phase
    (a); float32 along a whole level). An inactive step must leave the
    state as it was. Raises past the tolerances; returns the errors, the
    tie count and whether the step was active."""
    import torch

    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.ops.track_reduce import track_reduce_plain
    if not prev.active:
        if not all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                   for a, b in zip(got, prev)):
            raise AssertionError(f"{where}: an inactive step changed the "
                                 "state")
        return {"active": False, "solve": 0.0, "se3": 0.0, "se3_plain": 0.0,
                "dx": 0.0, "T_new": 0.0, "dx_plain": 0.0, "sums": 0.0,
                "ties": 0}
    p = tl.LMState(*(_cast(x, dtype) for x in prev))
    ptsd = tuple(_cast(x, dtype) for x in pts)
    planesd = tuple(_cast(x, dtype) for x in planes)
    ref = tl.lm_step_plain(p, ptsd, planesd, K, max_iter, tdist)
    e_new, n_new, _, _ = track_reduce_plain(p.T_new, p.aff_new, ptsd,
                                            planesd, K, tdist)
    e_old_n = p.e / p.n.clamp(min=1.0)
    e_new_n = e_new / n_new.clamp(min=1.0)
    margin = LM_TIE * e_old_n.clamp(min=1e-6)
    tie = ~p.done & (((e_new_n - e_old_n).abs() <= margin)
                     | ((e_old_n - e_new_n - 1e-4 * e_old_n.clamp(min=1e-6))
                        .abs() <= margin))
    ok = ~tie
    # active is any(live): a tie's done or lam may decide it either way.
    if got.it != ref.it or (got.active != ref.active and not tie.any()):
        raise AssertionError(f"{where}: it/active {got.it} {got.active} != "
                             f"{ref.it} {ref.active}")
    if not (torch.equal(got.done[ok], ref.done[ok])
            and torch.equal(got.lam[ok].to(dtype), ref.lam[ok])
            and torch.equal(got.T[ok].to(dtype), ref.T[ok])
            and torch.equal(got.n[ok].to(dtype), ref.n[ok])):
        raise AssertionError(f"{where}: done/lam/T/n differ: "
                             f"{got.done.tolist()} {got.lam.tolist()} vs "
                             f"{ref.done.tolist()} {ref.lam.tolist()} (ties "
                             f"{tie.tolist()})")

    def rel(a, b, scale=None):
        if not ok.any():
            return 0.0
        d = (a[ok].to(dtype) - b[ok]).abs()
        if scale is None:
            return float(d.max() / b[ok].abs().max().clamp(min=1e-30))
        return float((d / scale[ok].clamp(min=1e-30)).max())
    e_scale = ref.e + ref.n
    g_scale = (torch.diagonal(ref.Hm, dim1=-2, dim2=-1)
               * e_scale[:, None]).sqrt()
    errs = {"active": True, "solve": 0.0, "se3": 0.0, "se3_plain": 0.0,
            "dx": 0.0, "T_new": 0.0, "dx_plain": 0.0,
            "sums": max(rel(got.e, ref.e, e_scale), rel(got.Hm, ref.Hm),
                        rel(got.g, ref.g, g_scale)),
            "ties": int(tie.sum())}
    if ref.active:   # the next proposal
        Hk = got.Hm.double()
        eye = torch.eye(8, dtype=torch.float64, device=Hk.device)
        Hl = (Hk + got.lam.double()[:, None, None]
              * (torch.diagonal(Hk, dim1=-2, dim2=-1)[:, :, None] * eye)
              + 1e-5 * eye)
        dx, g = got.dx.double(), got.g.double()
        resid = (Hl @ dx[..., None])[..., 0] + g
        size = (Hl.abs() @ dx.abs()[..., None])[..., 0] + g.abs()
        own = se3_exp(dx[:, :6]) @ got.T.double()
        scale = own.abs().max().clamp(min=1.0)
        own32 = se3_exp(got.dx[:, :6]) @ got.T       # the plain f32 update
        step = ref.dx[ok].abs().max().clamp(min=1e-30) if ok.any() else 1.0
        errs.update(solve=float((resid.abs() / size.clamp(min=1e-300))
                                .max()),
                    se3=float((got.T_new.double() - own).abs().max()
                              / scale),
                    se3_plain=float((own32.double() - own).abs().max()
                                    / scale),
                    dx=rel(got.dx, ref.dx),
                    T_new=float((got.T_new[ok].to(dtype) - ref.T_new[ok])
                                .abs().max() / step) if ok.any() else 0.0)
        if tdist:   # the plain f32 step's own dx error against float64
            other = (torch.float32 if dtype == torch.float64
                     else torch.float64)
            alt = tl.lm_step_plain(
                tl.LMState(*(_cast(x, other) for x in prev)),
                tuple(_cast(x, other) for x in pts),
                tuple(_cast(x, other) for x in planes), K, max_iter, True)
            s32, s64 = (alt, ref) if other == torch.float32 else (ref, alt)
            both = ok & (s32.done == s64.done)
            if alt.active and both.any():
                errs["dx_plain"] = float(
                    (s32.dx[both].double() - s64.dx[both]).abs().max()
                    / s64.dx[both].abs().max().clamp(min=1e-30))
    dx_tol = max(LM_DX_TOL, LM_DX_PLAIN_X * errs["dx_plain"])
    if not (errs["solve"] <= LM_SOLVE_TOL
            and errs["se3"] <= max(LM_SE3_TOL, 4 * errs["se3_plain"])
            and max(errs["dx"], errs["T_new"]) <= dx_tol
            and errs["sums"] <= TRACK_TOL):
        raise AssertionError(f"{where}: {errs} past LM_SOLVE_TOL "
                             f"{LM_SOLVE_TOL}, LM_SE3_TOL {LM_SE3_TOL}, "
                             f"LM_DX_TOL {LM_DX_TOL} (here {dx_tol:.3e}), "
                             f"TRACK_TOL {TRACK_TOL}")
    return errs


def _lm_one_step(dev, N, B, H, W, max_iter, seed, tdist=False) -> dict:
    """Phase track lm (a): a plain f32 state after one step, then one
    kernel step from it (``lm_run`` from the packed state) against
    lm_step_plain in float64."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    T, aff, pts, planes, K = _track_case(dev, N, B, H, W, seed)
    s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter, tdist)
    s = tl.lm_step_plain(s, pts, planes, K, max_iter, tdist)
    # The points the step evaluates, without f32/f64 ties at T_new.
    pts = _drop_ties(s.T_new, s.aff_new, pts, planes, K)[2]
    _, hist, last = tl.lm_run(T, aff, pts, planes, K, max_iter, tdist,
                              state=tl.pack_state(s), it0=s.it, n_steps=1)
    # The state after the step: the recorded one, or the input where the
    # loop had already ended (its candidates that are not done step on).
    got = tl.history_state(hist, last,
                           min(tl.loop_end(hist, last, s.it, max_iter), 1),
                           s.it, max_iter)
    return _lm_compare(f"track lm (a) {'t' if tdist else 'huber'} N={N} "
                       f"{W}x{H} B={B}", s, got, pts, planes, K, max_iter,
                       torch.float64, tdist)


def _lm_level_steps(dev, case, max_iter, where, tdist) -> tuple:
    """Phase track lm (b), along the kernel's own path: one launch of the
    level, whose history holds every candidate's state after every step;
    the first record against lm_init_plain, then every step up to the
    loop's end against lm_step_plain (f32, on the card) from the kernel's
    state before it; the kernel's result equal to its history's
    (``lm_level_from_history``) and its sums at the accepted poses equal to
    K6's at those poses, bit for bit. Returns the worst errors and the
    kernel's result."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    T, aff, pts, planes, K = case
    B = T.shape[0]
    before = tl.lm_level.launches
    out, hist, last = tl.lm_run(*case, max_iter, tdist)
    if tl.lm_level.launches != before + 1:
        raise AssertionError(f"{where}: not one launch a level")
    end = tl.loop_end(hist, last, 0, max_iter)
    prev = tl.history_state(hist, last, 0, 0, max_iter)
    ref = tl.lm_init_plain(*case, max_iter, tdist)
    if not (torch.equal(prev.T, T) and torch.equal(prev.n, ref.n)
            and torch.equal(prev.lam, ref.lam) and prev.it == ref.it
            and prev.active == ref.active):
        raise AssertionError(f"{where}: the first record differs from "
                             "lm_init_plain")
    worst = {"solve": 0.0, "se3": 0.0, "se3_plain": 0.0, "dx": 0.0,
             "T_new": 0.0, "dx_plain": 0.0, "sums": 0.0, "ties": 0}
    for k in range(end):
        got = tl.history_state(hist, last, k + 1, 0, max_iter)
        errs = _lm_compare(where, prev, got, pts, planes, K, max_iter,
                           torch.float32, tdist)
        worst = {key: max(v, errs[key]) for key, v in worst.items()}
        prev = got
    if prev.active and end < max_iter:
        raise AssertionError(f"{where}: the loop ended at step {end} with a "
                             "live candidate")
    got = tl.level_result(out, B)
    res = tl.lm_level_from_history(hist, last, T, aff, 0, max_iter)
    if not all(torch.equal(a.float(), b.float()) for a, b in zip(got, res)):
        raise AssertionError(f"{where}: the kernel's result differs from "
                             "its history's")
    k6 = track_reduce(prev.T, prev.aff, pts, planes, K, tdist=tdist)
    if not all(torch.equal(a, b) for a, b in zip(
            k6, (prev.e, prev.n, prev.Hm, prev.g))):
        raise AssertionError(f"{where}: the LM's sums at the accepted poses "
                             "differ from K6's")
    return worst, got


def phase_track_lm(dev, out: dict):
    """The LM kernel against its plain version in both weightings: one step
    against float64, whole levels step by step (from the kernel's history)
    and against the plain f32 level on the card; one launch and no host
    read a level."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    worst = {"solve": 0.0, "se3": 0.0, "se3_plain": 0.0, "dx": 0.0,
             "T_new": 0.0, "dx_plain": 0.0, "sums": 0.0}
    shapes = _track_shapes()
    for tdist in (False, True):
        mode = "t" if tdist else "huber"
        for i, (N, H, W, _) in enumerate(shapes):
            for B in (1, 5, 15):
                errs = _lm_one_step(dev, N, B, H, W, 50, 100 + 10 * i + B,
                                    tdist)
                worst = {k: max(v, errs[k]) for k, v in worst.items()}
                log(f"[track lm] (a) {mode} N={N} level {W}x{H} B={B}: one "
                    f"step vs float64: dx's backward error "
                    f"{errs['solve']:.3e} (tol {LM_SOLVE_TOL}), T_new vs "
                    f"se3_exp(dx) T {errs['se3']:.3e} (plain f32 "
                    f"{errs['se3_plain']:.3e}, tol {LM_SE3_TOL} or 4x "
                    f"plain); dx {errs['dx']:.3e} and T_new "
                    f"{errs['T_new']:.3e} vs the step (tol {LM_DX_TOL}, or "
                    f"{LM_DX_PLAIN_X:g}x the plain f32 step's "
                    f"{errs['dx_plain']:.3e}); "
                    f"e/H/g {errs['sums']:.3e} (tol {TRACK_TOL}); ties "
                    f"{errs['ties']}; active {errs['active']}; it, active, "
                    f"accept, done, lam equal")
    res = {}
    for tdist in (False, True):
        mode = "t" if tdist else "huber"
        for i, (N, H, W, max_iter) in enumerate(shapes):
            for B in (1, 5, 15):
                case = _track_case(dev, N, B, H, W, 10 * i + B)
                where = f"track lm (b) {mode} N={N} {W}x{H} B={B}"
                steps, got = _lm_level_steps(dev, case, max_iter, where,
                                             tdist)
                worst = {k: max(v, steps[k]) for k, v in worst.items()}
                ref = tl.lm_level_plain(*case, max_iter, tdist)
                d_T = float((got[0] - ref[0]).abs().max())
                d_aff = float((got[1] - ref[1]).abs().max())
                its = (int(got[4]), int(ref[4]))
                tol_T = LM_POSE_PX / case[4][0]
                close = d_T <= tol_T and d_aff <= LM_AFF_TOL
                # Paths that took another number of steps parted at a
                # near-tie (the step check above holds each step);
                # elsewhere, and always at the 640x480 cap, the end points
                # must agree.
                if not torch.isfinite(got[0]).all() or not (
                        close or (i > 0 and its[0] != its[1])):
                    raise AssertionError(f"{where}: T {d_T:.3e} aff "
                                         f"{d_aff:.3e} past {tol_T:.3e} / "
                                         f"{LM_AFF_TOL}")

                def level():
                    return tl.lm_level(*case, max_iter, tdist)
                reads = _host_reads(level)
                if reads:
                    raise AssertionError(f"{where}: {reads} host reads "
                                         "inside a level")
                ms = cuda_ms(level)
                dev_ms = _device_ms(level)
                # The plain level (host-bound, ~50 steps of eager ops) is
                # timed at the 640x480 cap only, the kernel's row in the
                # result.
                plain_ms = cuda_ms(
                    lambda: tl.lm_level_plain(*case, max_iter, tdist),
                    iters=5, warmup=1) if i == 0 else None
                res[(tdist, N, B)] = (ms, dev_ms, plain_ms, its, d_T,
                                      _track_bound(*case[:4], got[:4],
                                                   its[0] + 1, tdist))
                log(f"[track lm] (b) {mode} N={N} level {W}x{H} B={B} "
                    f"max_iter {max_iter}: one launch, no host read; every "
                    f"step vs the plain step from the same state: dx's "
                    f"backward error {steps['solve']:.3e}, T_new vs "
                    f"se3_exp(dx) T {steps['se3']:.3e} (plain f32 "
                    f"{steps['se3_plain']:.3e}), dx {steps['dx']:.3e} and "
                    f"T_new {steps['T_new']:.3e} vs the step (the plain f32 "
                    f"step's own {steps['dx_plain']:.3e}), e/H/g "
                    f"{steps['sums']:.3e}, ties {steps['ties']}; the result "
                    f"equal to its history's, the sums to K6's; end point "
                    f"vs lm_level_plain: pose {d_T:.3e} (tol {tol_T:.3e}), "
                    f"aff {d_aff:.3e} (tol {LM_AFF_TOL})"
                    f"{'' if close else ', paths parted'}; iterations "
                    f"kernel {its[0]} plain {its[1]}; level kernel "
                    f"{ms:.4f} ms events, {dev_ms:.4f} ms device"
                    + (f"; plain {plain_ms:.4f} ms" if plain_ms else ""))
    for tdist in (False, True):
        ms, dev_ms, plain_ms, its, d_T, bound = res[(tdist, shapes[0][0],
                                                     15)]
        log(f"[track lm] {'t' if tdist else 'huber'} N={shapes[0][0]} B=15: "
            f"events {ms:.4f} ms, device {dev_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms; bound {bound} for {its[0] + 1} "
            f"evaluations, share of the device time "
            f"{100 * bound['bound_ms'] / dev_ms:.2f}%")
    log(f"[track lm] worst over (a) and (b) {worst}")
    ms, dev_ms, plain_ms, its, d_T, bound = res[(False, shapes[0][0], 15)]
    out["track_lm"] = {"max_abs_err": max(worst["se3"], d_T), "ms": ms,
                       "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
                       "library_ms": None}


def _motion_init(ref_c2w, last_c2w, prev_c2w):
    """FullSystem._motion_model: constant velocity, as T_ref->new."""
    pred = last_c2w @ np.linalg.inv(prev_c2w) @ last_c2w
    return (np.linalg.inv(pred) @ ref_c2w).astype(np.float32)


def _track_loop(dev, scene, ref, ref_id: int, frames, tag: str):
    """Track ``frames`` one after another from the constant-motion
    prediction; print and return each frame's (position error m, worst
    rotation entry error) against the GT poses."""
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    ref_c2w = scene.c2w(ref_id).astype(np.float64)
    prev, last = scene.c2w(ref_id - 1).astype(np.float64), ref_c2w
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    errs, ms, iters = [], [], []
    for f in frames:
        img = torch.from_numpy(scene.gray(f)).to(dev)
        T0 = torch.from_numpy(_motion_init(ref_c2w, last, prev)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = track_frame(ref, img, T0, aff0)
        T = out["T"].cpu().numpy().astype(np.float64)
        ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(sum(out["lm_iters"]))
        c2w = ref_c2w @ np.linalg.inv(T)
        gt = scene.c2w(f).astype(np.float64)
        errs.append((float(np.linalg.norm(c2w[:3, 3] - gt[:3, 3])),
                     float(np.abs(c2w[:3, :3] - gt[:3, :3]).max())))
        if not np.isfinite(T).all() or not np.isfinite(float(
                out["energy"])):
            raise AssertionError(f"{tag}: frame {f} pose not finite")
        prev, last = last, c2w
    log(f"[{tag}] frames {frames[0]}-{frames[-1]} on ref {ref_id}: position "
        f"error mm {[round(e * 1e3, 3) for e, _ in errs]}, rotation entry "
        f"error {[round(r, 5) for _, r in errs]}, LM iterations {iters}, "
        f"ms/frame {[round(x, 3) for x in ms]} (host clock, synced)")
    return errs


def _dense_ref(dev, depth, c2w, gray, K, fx, fy, cx, cy):
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import (make_tracker_ref,
                                                          splat_depth_to_ref)
    H, W = gray.shape
    idp, w = splat_depth_to_ref(depth, c2w, c2w, K, H, W, stride=3)
    return make_tracker_ref(torch.from_numpy(gray).to(dev), fx, fy, cx, cy,
                            dense_idepth=idp, dense_weight=w)


def phase_track_gt(dev) -> dict:
    """Track against a model fused from the fixture's GT depths."""
    import torch

    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate,
                                               render_depth_splat,
                                               surface_axis_slots)
    scene = ReplicaScene(FIXTURE)
    cfg = TsdfConfig()
    K = torch.from_numpy(scene.K).to(dev)
    vol = create_volume(cfg, dev)
    for i in range(7):
        d = torch.from_numpy(scene.depth(i)).to(dev)
        p = torch.from_numpy(scene.c2w(i)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(
            scene.bgr(i)[..., ::-1], dtype=np.float32)).to(dev)
        allocate_blocks(cfg, vol, d, K, p)
        integrate(cfg, vol, d, rgb, K, p)
    pose = torch.from_numpy(scene.c2w(6)).to(dev)
    slots, counts = surface_axis_slots(cfg, vol, K, pose, scene.height,
                                       scene.width)
    rdepth = render_depth_splat(cfg, vol, K, pose, scene.height, scene.width,
                                axis_slots=slots, axis_counts=counts.tolist())
    gt = torch.from_numpy(scene.depth(6)).to(dev)
    hit = rdepth > 0
    med = float((rdepth[hit] - gt[hit]).abs().median())
    log(f"[track gt] map from GT depths 0-6: n_allocated {vol.n_allocated}, "
        f"render at frame 6 hit {float(hit.float().mean()):.4f}, median "
        f"|err| {med * 1e3:.3f} mm")
    reset_counts()
    ref = _dense_ref(dev, rdepth, pose, scene.gray(6), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, 6, list(range(7, 15)), "track gt")
    counts = read_counts()
    require_launched("track gt", counts, ("track_reduce", "track_lm"))
    worst = max(e for e, _ in errs)
    log(f"[track gt] worst position error {worst * 1e3:.3f} mm (bound "
        f"{GT_TRACK_BOUND * 1e3} mm), launches {counts}")
    if not worst < GT_TRACK_BOUND:
        raise AssertionError(f"track gt: {worst * 1e3:.3f} mm >= bound")
    return counts


def phase_track_mvs(dev) -> dict:
    """Track against the model the backend fuses from trained-MVSNet depth
    (the fixture's first two 7-view windows, f32)."""
    import torch

    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    scene = ReplicaScene(FIXTURE)
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=torch.float32),
                          load_variables(UNIT / "model_variables.pkl"),
                          scene.height, scene.width, view_num=7, device=dev)
    backend = TandemBackend(runner, TsdfConfig(), scene.K, scene.height,
                            scene.width)
    calls = []
    for window in scene.windows[:2]:
        depths = [scene.depth(i) for i in window]
        valid = np.concatenate([d[d > 0] for d in depths])
        calls.append(([scene.bgr(i) for i in window],
                      [scene.c2w(i) for i in window], float(valid.min()),
                      float(valid.max()), scene.c2w(window[-1])))
    ref_id = scene.windows[1][-1]
    torch.cuda.synchronize()
    reset_counts()
    for args in calls:
        backend.call(*args)
    dm = backend.get_tracking_depth_map()
    K = torch.from_numpy(scene.K).to(dev)
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    ref = _dense_ref(dev, dm["depth"], c2w, scene.gray(ref_id), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, ref_id,
                       list(range(ref_id + 1, ref_id + 9)), "track mvs")
    counts = read_counts()
    edge = require_edge_filter("track mvs", counts["edge_kth"], edge_calls(),
                               len(calls))
    require_launched("track mvs", counts,
                     ("bilinear_sample", "track_reduce", "track_lm"))
    require_not_launched("track mvs", counts,
                         ("bilinear_index", "corner_blend"))
    worst = max(e for e, _ in errs)
    log(f"[track mvs] backend {backend.last_fuse}; worst position error "
        f"{worst * 1e3:.3f} mm (bound {MVS_TRACK_BOUND * 1e3} mm), "
        f"launches {counts} ({edge})")
    if not worst <= MVS_TRACK_BOUND:
        raise AssertionError(f"track mvs: {worst * 1e3:.3f} mm > bound")
    return counts


def _gray(bgr):
    from tandem_tpu_torch.data.replica import gray
    return gray(bgr).astype(np.float32)


def _median_ms(fn, reps: int = 5):
    import torch
    out, ms = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def _profile_track(ref, img, T0, aff0, profile: Path):
    """torch.profiler over one track_frame: the kernel table, the device's
    busy share of the host span, and a trace in ``profile``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    torch.cuda.synchronize()
    launches = lm_level.launches
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        out = track_frame(ref, img, T0, aff0)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    launches = lm_level.launches - launches
    events = p.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    lm_ms = sum(e.self_device_time_total for e in device
                if "track_lm_kernel" in e.key) / 1e3
    log(events.table(sort_by="self_cuda_time_total", row_limit=20))
    log(f"[track 640x480] profiled track_frame: device busy {busy_ms:.3f} "
        f"ms of a {span_ms:.3f} ms host span (profiler on), idle "
        f"{100 * (1 - busy_ms / span_ms):.1f}%; launches per frame: "
        f"{sum(e.count for e in device)} device events (kernels and "
        f"copies), of them {launches} track_lm launches (one a level, "
        f"{lm_ms:.3f} ms of device time; LM iterations by level "
        f"{out['lm_iters']}, {sum(out['lm_iters'])} in all)")
    if launches != 6:
        raise AssertionError(f"track 640x480: {launches} track_lm launches "
                             "a frame, not one a level")
    profile.mkdir(parents=True, exist_ok=True)
    p.export_chrome_trace(str(profile / "track_frame_trace.json"))


def phase_track_640(dev, backend, pack, profile: Path = None) -> dict:
    """Tracker times at the deployed size: the dense reference on golden
    view 0 from the f32 slice's rendered depth (rendered at view 0's pose);
    views 1-6 tracked from the identity. The golden views are not
    photometrically consistent with their poses, so no accuracy bound."""
    import torch

    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.tracking.coarse_tracker import (
        make_tracker_ref, rotation_perturbations, splat_depth_to_ref,
        track_frame, track_frame_multi)
    rgb = pack["image"][0]                            # (V, 3, H, W) RGB
    grays = [_gray(np.ascontiguousarray(v.transpose(1, 2, 0)[..., ::-1]))
             for v in rgb]
    H, W = grays[0].shape
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    fx, fy, cx, cy = (float(pack["K3"][0][i]) for i in ((0, 0), (1, 1),
                                                         (0, 2), (1, 2)))
    dm = backend.get_tracking_depth_map()
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    img0 = torch.from_numpy(grays[0]).to(dev)
    reset_counts()
    splat_ms, (idp, w) = _median_ms(
        lambda: splat_depth_to_ref(dm["depth"], c2w, c2w, K, H, W, stride=3))
    ref_ms, ref = _median_ms(lambda: make_tracker_ref(
        img0, fx, fy, cx, cy, dense_idepth=idp, dense_weight=w))
    log(f"[track 640x480] per keyframe: splat_depth_to_ref {splat_ms:.3f} "
        f"ms, make_tracker_ref {ref_ms:.3f} ms (host clock, synced, median "
        f"of 5); points per level {[int(v.sum()) for v in ref.pvalid]} of "
        f"caps {[v.numel() for v in ref.pvalid]}")
    eye = torch.eye(4, device=dev)
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    moves = torch.tensor([[0.01, 0, 0, 0, 0, 0], [-0.01, 0, 0, 0, 0, 0],
                          [0, 0.01, 0, 0, 0, 0], [0, 0, 0, 0, 0.005, 0]],
                         device=dev)
    cand5 = torch.cat([eye[None], se3_exp(moves)]).contiguous()
    cand15 = torch.from_numpy(rotation_perturbations()).to(dev)
    rows = {"track_frame": [], "multi 5": [], "multi 15": []}
    iters = {k: [] for k in rows}
    for v in range(1, len(grays)):
        img = torch.from_numpy(grays[v]).to(dev)
        for name, fn in (
                ("track_frame", lambda: track_frame(ref, img, eye, aff0)),
                ("multi 5", lambda: track_frame_multi(ref, img, cand5,
                                                      aff0)),
                ("multi 15", lambda: track_frame_multi(ref, img, cand15,
                                                       aff0))):
            ms, out = _median_ms(fn, reps=3)
            if not torch.isfinite(out["T"]).all():
                raise AssertionError(f"track 640x480 {name}: view {v} pose "
                                     "not finite")
            rows[name].append(ms)
            iters[name].append(sum(out["lm_iters"]))
    counts = read_counts()
    require_launched("track 640x480", counts, ("track_reduce", "track_lm"))
    if profile:
        _profile_track(ref, torch.from_numpy(grays[1]).to(dev), eye, aff0,
                       profile)
    for name in rows:
        log(f"[track 640x480] {name}: ms/frame {[round(x, 3) for x in rows[name]]}"
            f" median {float(np.median(rows[name])):.3f} ms (host clock, "
            f"synced, median of 3 per view); LM iterations {iters[name]}")
    log(f"[track 640x480] launches {counts}")
    return counts


def _turned(pose: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    out = pose.copy()
    out[:3, :3] = pose[:3, :3] @ R
    return out


def _culled_cases(dev, name, cfg, vol, depth, rgb, K, pose: np.ndarray):
    """At the pose and turned by 20/40/60 degrees: integrate_culled equals
    integrate, and both culled renders equal the full walk (torch.equal)."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (copy_volume, integrate,
                                               integrate_culled,
                                               render_depth_splat,
                                               surface_axis_slots,
                                               visible_slots)
    H, W = depth.shape
    for deg in (0.0, 20.0, 40.0, 60.0):
        p = torch.from_numpy(_turned(pose, deg)).to(dev)
        vis_ms, (slots, n_vis) = _median_ms(
            lambda: visible_slots(cfg, vol, K, p, H, W), reps=3)
        n_vis = int(n_vis)
        full = integrate(cfg, copy_volume(vol), depth, rgb, K, p)
        cull = integrate_culled(cfg, copy_volume(vol), depth, rgb, K, p,
                                slots, n_vis)
        for f in ("tsdf", "weight", "color"):
            if not torch.equal(getattr(full, f), getattr(cull, f)):
                raise AssertionError(f"culled {name} {deg} deg: "
                                     f"integrate_culled {f} != full walk")
        # Timed on the two copies, in place: the same work every repeat.
        full_ms, _ = _median_ms(lambda: integrate(cfg, full, depth, rgb, K,
                                                  p), reps=3)
        cull_ms, _ = _median_ms(lambda: integrate_culled(
            cfg, cull, depth, rgb, K, p, slots, n_vis), reps=3)
        del full, cull
        ax_ms, (ax_slots, ax_counts) = _median_ms(
            lambda: surface_axis_slots(cfg, vol, K, p, H, W), reps=3)
        ax_counts = ax_counts.tolist()
        r_full_ms, r_full = _median_ms(
            lambda: render_depth_splat(cfg, vol, K, p, H, W), reps=3)
        r_vis_ms, r_vis = _median_ms(lambda: render_depth_splat(
            cfg, vol, K, p, H, W, slots=slots, n_visible=n_vis), reps=3)
        r_ax_ms, r_ax = _median_ms(lambda: render_depth_splat(
            cfg, vol, K, p, H, W, axis_slots=ax_slots,
            axis_counts=ax_counts), reps=3)
        if not (torch.equal(r_full, r_vis) and torch.equal(r_full, r_ax)):
            raise AssertionError(f"culled {name} {deg} deg: culled render "
                                 "!= full walk")
        log(f"[culled] {name} turned {deg:.0f} deg: n_allocated "
            f"{vol.n_allocated} n_visible {n_vis} axis counts {ax_counts}; "
            f"equal; integrate full {full_ms:.3f} ms culled {cull_ms:.3f} "
            f"ms (+ visible_slots {vis_ms:.3f} ms); render full "
            f"{r_full_ms:.3f} ms "
            f"frustum-culled "
            f"{r_vis_ms:.3f} ms axis-culled {r_ax_ms:.3f} ms (+ "
            f"surface_axis_slots {ax_ms:.3f} ms) (host clock, synced, "
            f"median of 3)")


def phase_culled(dev, backend, pack):
    """Culled == full on the f32 slice's map and on the 640x480 wall."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate)
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    bgrs, poses, ref_pose = golden_window(pack)
    backend.runner.call_async(bgrs, poses, pack["K3"][0],
                              float(pack["depth_min"][0]),
                              float(pack["depth_max"][0]))
    depth = backend.runner.get_result(device=True)["depth"]
    rgb = torch.from_numpy(np.ascontiguousarray(
        bgrs[-2][..., ::-1], dtype=np.float32)).to(dev)
    _culled_cases(dev, "golden map", backend.cfg, backend.volume, depth, rgb,
                  K, np.asarray(ref_pose, np.float32))
    H, W = 480, 640
    cfg = TsdfConfig()
    Kw = torch.tensor([[499.2, 0, 319.5], [0, 499.2, 239.5], [0, 0, 1]],
                      device=dev)
    pose = torch.eye(4, device=dev)
    wall = torch.full((H, W), 2.0, device=dev)
    color = torch.full((H, W, 3), 100.0, device=dev)
    vol = allocate_blocks(cfg, create_volume(cfg, dev), wall, Kw, pose)
    integrate(cfg, vol, wall, color, Kw, pose)
    _culled_cases(dev, "wall", cfg, vol, wall, color, Kw,
                  np.eye(4, dtype=np.float32))


def _slam_run(dev, out_dir: Path, mvsnet: bool,
              count_syncs: bool = False, preload: bool = False,
              unit: Path = UNIT) -> dict:
    """One run of the port's tandem_dataset CLI on the trajectory fixture
    (frames read through the prefetcher, or all up front with
    ``preload``; ``unit`` is its mvsnet_folder); its ATE against the GT
    poses, the launches of each kernel in the run and, with
    ``count_syncs``, the host reads (synchronizing CUDA calls, by torch's
    sync debug mode)."""
    import warnings

    import torch

    from tandem_tpu_torch.cli import tandem_dataset
    from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                           load_tum_trajectory, tum_to_xyz)
    from tandem_tpu_torch.mapping.mesh import _corner_grids
    from tandem_tpu_torch.tracking.ba import _system_terms
    from tandem_tpu_torch.tracking.immature import trace_points
    from tandem_tpu_torch.tracking.initializer import _calc_res_gs
    argv = ["preset=dataset", f"files={FIXTURE / 'images'}",
            f"calib={FIXTURE / 'camera_dso.txt'}", f"result_folder={out_dir}",
            "dr_timing=1"]
    if mvsnet:
        argv.append(f"mvsnet_folder={unit}")
    if preload:
        argv.append("preload=1")
    ops = (_system_terms, trace_points, _calc_res_gs, _corner_grids)
    for fn in ops:
        fn.calls = 0
    torch.cuda.synchronize()
    reset_counts()
    calls0 = edge_calls()
    syncs = None
    if count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            res = tandem_dataset.main(argv, device=dev)
        torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in seen)
    else:
        res = tandem_dataset.main(argv, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    gt = load_tum_trajectory(str(FIXTURE / "gt_tum.txt"))
    est = load_tum_trajectory(str(out_dir / "result.txt"))
    matches = associate(gt, est)
    ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in matches]),
                       tum_to_xyz(est, [b for _, b in matches]),
                       with_scale=True)
    fs = res["fs"]
    return {"res": res, "counts": counts, "edge_calls": edge_calls() - calls0,
            "pairs": len(matches), "ate": ate, "syncs": syncs,
            "kfs": len(fs.keyframes), "op_calls": {
                "K7": _system_terms.calls, "K8": trace_points.calls,
                "K11": _calc_res_gs.calls, "corner_grids": _corner_grids.calls},
            "digest": __import__("hashlib").sha256(
                (out_dir / "result.txt").read_bytes()).hexdigest()}


def _first_differing_op(dev, out_dir: Path, frame: int) -> str:
    """Two more full runs to ``frame``, every aten op traced with a
    checksum of its outputs: the first op that differs."""
    from tandem_tpu_torch.cli import tandem_dataset
    from tandem_tpu_torch.experiments.determinism import _checksum
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if getattr(t, "is_cuda", False) and t.numel():
                    self.seen.append((str(func), int(_checksum(t))))
            return out

    traces = []
    for k in range(2):
        argv = ["preset=dataset", f"files={FIXTURE / 'images'}",
                f"calib={FIXTURE / 'camera_dso.txt'}",
                f"result_folder={out_dir / f'trace{k}'}",
                f"mvsnet_folder={UNIT}", f"end={frame + 1}"]
        with Trace() as trace:
            tandem_dataset.main(argv, device=dev)
        traces.append(trace.seen)
    for i, (a, b) in enumerate(zip(*traces)):
        if a != b:
            return f"op {i} of the run to frame {frame}: {a[0]}"
    return (f"no op of the run to frame {frame} differs "
            f"({len(traces[0])} ops)")


def _slam_op_times(dev, fs, backend) -> dict:
    """CUDA-event ms a call of the SLAM loop's torch-op hot spots on the
    run's final state, with a bound from their shapes: K7 (_system_terms +
    _assemble on the BA window), K8 (trace_points of the newest keyframe's
    immature points against the last frame), K11 (_calc_res_gs at level 0
    of the initializer's lists against the last keyframe's image) and the
    mesh's _corner_grids on 512 allocated blocks."""
    import torch

    from tandem_tpu_torch.core.pyramid import (build_pyramid,
                                               pyramid_intrinsics)
    from tandem_tpu_torch.mapping.mesh import _corner_grids
    from tandem_tpu_torch.tracking.ba import _assemble, _system_terms
    from tandem_tpu_torch.tracking.immature import trace_points
    from tandem_tpu_torch.tracking.initializer import _calc_res_gs
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    out = {}
    st, imgs, K = fs.ba_state, fs.slot_images, fs.K
    F, N = st.poses.shape[0], st.pt_valid.shape[0]
    P = 8 * F + 4
    rows = N * F * 8
    k7 = lambda: _assemble(st, *_system_terms(st, imgs, K)[:5])  # noqa
    # H_ff alone: rows x P x P multiply-adds; G (rows x P f32) written and
    # read twice (G and w G), the images read once.
    out["K7"] = {"ms": cuda_ms(k7, iters=10),
                 "system_terms_ms": cuda_ms(
                     lambda: _system_terms(st, imgs, K), iters=10),
                 **_bound(3 * rows * P * 4 + imgs.numel() * 4,
                          2.0 * rows * P * P),
                 "shape": f"N {N} x F {F} x 8 rows, P {P}"}
    kf = fs.keyframes[-1]
    pts = kf.immature
    host = torch.from_numpy(kf.c2w.astype(np.float32)).to(dev)
    tgt = torch.from_numpy(fs.last_c2w.astype(np.float32)).to(dev)
    n, S = pts.uv.shape[0], 32
    out["K8"] = {"ms": cuda_ms(lambda: trace_points(pts, host, tgt,
                                                    fs.slot_images[0], K),
                               iters=20),
                 # 4 corners x 8 pattern x S samples gathered per point,
                 # ~40 operations a pattern sample.
                 **_bound(n * 4 * 20 + kf.image.numel() * 4,
                          n * S * 8 * 40),
                 "shape": f"{n} points x {S} samples x 8"}
    ist = fs.init_state
    pyr = build_pyramid(kf.image, 6)
    Kl = pyramid_intrinsics(*K, 6)[0]
    H, W = kf.image.shape
    const = (ist.pu[0], ist.pv[0], ist.pcolor[0], ist.pvalid[0],
             (pyr[0]["img"], pyr[0]["gx"], pyr[0]["gy"]), H, W, Kl)
    n0 = ist.pu[0].shape[0]
    out["K11"] = {"ms": cuda_ms(lambda: _calc_res_gs(
        ist.T, ist.aff, ist.idepth[0], ist.is_good[0], ist.energy[0],
        ist.iR[0], const, ist.snapped), iters=20),
        # 8 pattern samples of 3 planes a point, ~150 operations each, and
        # the 8x8 normal equations (64 multiply-adds a sample).
        **_bound(n0 * 4 * 16 + 3 * H * W * 4, n0 * 8 * (150 + 128)),
        "shape": f"{n0} points x 8 at {W}x{H}"}
    if backend is not None and backend.volume.n_allocated:
        C = min(512, backend.volume.n_allocated)
        slots = torch.arange(C, device=dev)
        looks = C * 9 ** 3
        out["corner_grids"] = {
            "ms": cuda_ms(lambda: _corner_grids(backend.cfg, backend.volume,
                                                slots), iters=20),
            # per corner: the page-table and four voxel words read, five
            # words written
            **_bound(looks * (4 + 20 + 20), looks * 30),
            "shape": f"{C} blocks x 9^3 corners"}
    return out


def phase_slam(dev) -> dict:
    """The port's tandem_dataset CLI on tests/fixtures/replica_traj (64
    frames, 256x192, preset=dataset): VO only, then the full pipeline with
    the trained abl04 unit (bf16, boot golden self-check) twice. Each run
    must associate >= SLAM_MIN_FRAMES frames with ATE (Sim3) under
    SLAM_ATE_BOUND; the full runs must call the backend, write a non-empty
    mesh.obj, launch K1's filter, bilinear_sample, track_lm and
    track_reduce inside the loop, and give the same result.txt sha256: the
    first reads its frames through the prefetcher, the second with
    preload=1. Returns the launches by run and the full run's ATE (m)."""
    import shutil
    import tempfile

    import torch
    work = Path(tempfile.mkdtemp(prefix="slam_"))
    runs = {}
    try:
        for tag, mvs, syncs, preload in (
                ("vo", False, False, False), ("full", True, True, False),
                ("full_again", True, False, True)):
            runs[tag] = r = _slam_run(dev, work / tag, mvs, count_syncs=syncs,
                                      preload=preload)
            res = r["res"]
            split = _timer_split(res["timer"])
            nf = res["frames"]
            log(f"[slam {tag}] {card_label_once()} frames {nf}, "
                f"{res['seconds']:.3f} s, FPS {nf / res['seconds']:.3f}, "
                f"keyframes {r['kfs']}; ATE {r['ate']['rmse'] * 1e3:.3f} mm "
                f"(Sim3 scale {r['ate']['scale']:.4f}, {r['pairs']}/64 "
                f"frames; bound {SLAM_ATE_BOUND * 1e3} mm); result.txt "
                f"sha256 {r['digest']}")
            log(f"[slam {tag}] Timer (count, mean ms, host clock): {split}")
            log(f"[slam {tag}] calls: {r['op_calls']} "
                f"({r['op_calls']['K8'] / nf:.2f} K8 a frame, "
                f"{r['op_calls']['K7'] / max(r['kfs'], 1):.2f} K7 a "
                f"keyframe); kernel launches {r['counts']}"
                + (f"; host reads {r['syncs']} ({r['syncs'] / nf:.2f} a "
                   f"frame)" if r["syncs"] is not None else ""))
            if r["pairs"] < SLAM_MIN_FRAMES or not (
                    r["ate"]["rmse"] < SLAM_ATE_BOUND):
                raise AssertionError(
                    f"slam {tag}: {r['pairs']} frames, ATE "
                    f"{r['ate']['rmse'] * 1e3:.3f} mm")
            require_launched(f"slam {tag}", r["counts"],
                             ("track_reduce", "track_lm"))
            if mvs:
                backend = res["backend"]
                verts = backend.last_mesh[0]
                mesh_lines = (work / tag / "mesh.obj").read_text().count(
                    "\nv ")
                log(f"[slam {tag}] backend calls {backend.call_num}, "
                    f"{backend.last_fuse}; mesh {len(verts)} vertices "
                    f"({mesh_lines + 1} lines of v in mesh.obj); "
                    + require_edge_filter(f"slam {tag}",
                                          r["counts"]["edge_kth"],
                                          r["edge_calls"], 1))
                if backend.call_num < 1 or len(verts) == 0:
                    raise AssertionError(f"slam {tag}: no backend call or an "
                                         "empty mesh")
                require_launched(f"slam {tag}", r["counts"],
                                 ("bilinear_sample",))
        if runs["full"]["digest"] != runs["full_again"]["digest"]:
            a = (work / "full" / "result.txt").read_text().splitlines()
            b = (work / "full_again" / "result.txt").read_text().splitlines()
            frame = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            raise AssertionError("slam: a second full run (preload=1) gives "
                                 "another result.txt; first differing " +
                                 _first_differing_op(dev, work, frame))
        log("[slam] the two full runs (the prefetcher, then preload=1) give "
            "the same result.txt sha256")
        full = runs["full"]["res"]
        times = _slam_op_times(dev, full["fs"], full["backend"])
        log(f"[slam] torch-op hot spots, CUDA events ms a call on the full "
            f"run's final state: {json.dumps(times)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return ({"slam_vo": runs["vo"]["counts"],
             "slam_full": runs["full"]["counts"],
             "slam_full_again": runs["full_again"]["counts"]},
            runs["full"]["ate"]["rmse"])


def _runtime_frames(n: int, H: int, W: int):
    """A jax-free copy of bench_runtime.make_frames: the textured plane
    sequence at full resolution, uint8 grey, with its fx, cx, cy."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    fx = 0.6 * W
    cx, cy = (W - 1) / 2, (H - 1) / 2
    frames = []
    for i in range(n):
        tx = 0.015 * i
        x = (u - cx) / fx * 2.0 + tx
        y = (v - cy) / fx * 2.0
        img = (120 + 45 * np.sin(17 * x) * np.cos(13 * y)
               + 30 * np.sin(41 * x + 1) + 25 * np.cos(33 * y)
               + 15 * np.sin(77 * x * y))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, fx, cx, cy


def _png_filtered(img: np.ndarray) -> bytes:
    """An 8-bit grey or RGB image as PNG bytes whose rows cycle through the
    Paeth, Sub, Up and Average filters (data/replica.write_png writes only
    unfiltered rows), so a decoder does the work of a real file."""
    import struct
    import zlib
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    cur = img.reshape(h, -1).astype(np.int32)
    up = np.vstack([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.hstack([np.zeros_like(cur[:, :bpp]), cur[:, :-bpp]])
    ul = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    preds = {4: np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul)),
             1: left, 2: up, 3: (left + up) >> 1}
    ftype = np.array([4, 1, 2, 3], np.uint8)[np.arange(h) % 4]
    pred = np.empty_like(cur)
    for f, p in preds.items():
        pred[ftype == f] = p[ftype == f]
    raw = np.hstack([ftype[:, None], ((cur - pred) & 0xFF).astype(np.uint8)])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    hdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_runtime_sequence(root: Path, n: int = RUNTIME_FRAMES,
                           H: int = 480, W: int = 640) -> dict:
    """The runtime phase's sequence on disk: images/%06d.png (RGB, the
    grey replicated, filtered rows), camera.txt and gt_tum.txt (the camera
    at x = 0.015 i, stamps i / 30 as the reader gives without times.txt)."""
    from tandem_tpu_torch.pipeline.io import write_result_tum
    frames, fx, cx, cy = _runtime_frames(n, H, W)
    (root / "images").mkdir(parents=True)
    for i, g in enumerate(frames):
        (root / "images" / f"{i:06d}.png").write_bytes(
            _png_filtered(np.repeat(g[..., None], 3, -1)))
    (root / "camera.txt").write_text(f"Pinhole {fx} {fx} {cx} {cy} 0\n"
                                     f"{W} {H}\n")
    poses = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[0, 3] = 0.015 * i
        poses.append(c2w)
    write_result_tum(str(root / "gt_tum.txt"), [i / 30.0 for i in range(n)],
                     poses)
    return {"frames": frames, "fx": fx}


def _timer_split(timer) -> dict:
    return {k: (len(v), round(float(np.mean(v)), 3))
            for k, v in sorted(timer.intervals.items())}


def _ate_cli(est: Path, gt: Path) -> dict:
    """The port's tandem_ate --scale: its printed lines and its result."""
    import contextlib
    import io

    from tandem_tpu_torch.cli import tandem_ate
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tandem_ate.main(tandem_ate.parser.parse_args(
            ["--est", str(est), "--gt", str(gt), "--scale"]))
    return {"lines": buf.getvalue().strip().splitlines(), **res}


def phase_runtime_640(dev) -> dict:
    """tandem_dataset preset=runtime (preload=1, dense tracking, no mesh)
    with the trained abl04 unit (bf16, V = 7) on bench_runtime.py's 60-frame
    640x480 sequence, written as filtered PNGs: frames, seconds and FPS
    against the 21 FPS bar, the Timer split with read_frame (the loop's
    wait for a decoded frame), keyframes, backend calls and the Sim3 ATE of
    the port's tandem_ate against the GT trajectory. At least
    RUNTIME_MIN_POSES poses, not lost, the backend called, and K1's filter,
    bilinear_sample, track_lm and track_reduce launched."""
    import shutil
    import tempfile

    import torch

    from tandem_tpu_torch.cli import tandem_dataset
    work = Path(tempfile.mkdtemp(prefix="runtime_"))
    try:
        t0 = time.perf_counter()
        write_runtime_sequence(work)
        t_write = time.perf_counter() - t0
        argv = ["preset=runtime", f"files={work / 'images'}",
                f"calib={work / 'camera.txt'}",
                f"result_folder={work / 'out'}", f"mvsnet_folder={UNIT}",
                "dr_timing=1"]
        torch.cuda.synchronize()
        reset_counts()
        calls0 = edge_calls()
        t0 = time.perf_counter()
        res = tandem_dataset.main(argv, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        fs, backend, nf = res["fs"], res["backend"], res["frames"]
        label = card_label_once()
        log(f"[runtime 640x480] {label} preset=runtime, trained abl04 bf16 "
            f"V=7: frames {nf}, {res['seconds']:.3f} s in the loop, FPS "
            f"{nf / res['seconds']:.3f} against the {RUNTIME_FPS_BAR} FPS "
            f"bar; the CLI call {wall:.3f} s (preload, boot self-check and "
            f"results included); the sequence written in {t_write:.3f} s")
        log(f"[runtime 640x480] {label} Timer (count, mean ms, host clock): "
            f"{_timer_split(res['timer'])}")
        ate = _ate_cli(work / "out" / "result.txt", work / "gt_tum.txt")
        log(f"[runtime 640x480] {label} keyframes {len(fs.keyframes)}, "
            f"backend calls {backend.call_num} ({backend.last_fuse}), "
            f"dropped {fs.n_dropped_kf}, retry ladder {fs.n_retracks}; "
            f"tandem_ate --scale: {' | '.join(ate['lines'])}; launches "
            f"{counts}; " + require_edge_filter(
                "runtime 640x480", counts["edge_kth"],
                edge_calls() - calls0, 1))
        n_poses = len((work / "out" / "result.txt").read_text().splitlines())
        if n_poses < RUNTIME_MIN_POSES or fs.is_lost:
            raise AssertionError(f"runtime 640x480: {n_poses} poses, lost "
                                 f"{fs.is_lost}")
        if backend.call_num < 1:
            raise AssertionError("runtime 640x480: the backend was never "
                                 "called")
        require_launched("runtime 640x480", counts,
                         ("bilinear_sample", "track_lm", "track_reduce"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return counts


def _decode_ms(fn, data: bytes, reps: int) -> float:
    fn(data)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(data)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_decode():
    """The C decoder (native_bridge.decode_png_native) against the plain
    Python one (data/replica.decode_png) on the card host's CPU: bit-equal
    on the fixture's first frame (256x192) and on one 640x480 frame of the
    runtime sequence (rows Paeth, Sub, Up and Average); both times."""
    from tandem_tpu_torch.data.replica import decode_png
    from tandem_tpu_torch.native_bridge import decode_png_native
    g = _runtime_frames(1, 480, 640)[0][0]
    cases = {"replica_traj 000000.png 256x192":
             (FIXTURE / "images" / "000000.png").read_bytes(),
             "runtime 640x480 RGB": _png_filtered(
                 np.repeat(g[..., None], 3, -1))}
    for name, data in cases.items():
        a, b = decode_png_native(data), decode_png(data)
        if not (a.dtype == b.dtype and np.array_equal(a, b)):
            raise AssertionError(f"decode: {name}: the C decoder differs")
        c_ms = _decode_ms(decode_png_native, data, 20)
        py_ms = _decode_ms(decode_png, data, 2)
        log(f"[decode] {card_label_once()} {name} ({len(data)} bytes): C "
            f"{c_ms:.3f} ms, Python {py_ms:.3f} ms a frame (host clock, "
            f"the card host's CPU), bit-equal")


def phase_demo(dev) -> dict:
    """tandem_demo replay= record= over the fixture's first DEMO_FRAMES
    frames with the trained unit, the recorded folder (camera.txt,
    times.txt, an image a frame), and that folder replayed through
    tandem_dataset with log_stuff, debug_save_depth_images, save_dr_video
    and viewer3d: the same poses as the demo's (poses_dso.txt sha256 and
    result.txt's pose columns; the timestamps pass through times.txt's six
    decimals) and every output directory non-empty."""
    import hashlib
    import shutil
    import tempfile

    import torch

    from tandem_tpu_torch.cli import tandem_dataset, tandem_demo
    work = Path(tempfile.mkdtemp(prefix="demo_"))
    try:
        src = work / "replay"
        src.mkdir()
        for i in range(DEMO_FRAMES):
            shutil.copy(FIXTURE / "images" / f"{i:06d}.png", src)
        rec, out = work / "rec", work / "demo_out"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = tandem_demo.main([f"replay={src}",
                                f"calib={FIXTURE / 'camera_dso.txt'}",
                                f"record={rec}", f"result_folder={out}",
                                f"mvsnet_folder={UNIT}", "demo_secs=600"],
                               device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        nf = res["frames"]
        times = (rec / "times.txt").read_text().splitlines()
        images = sorted(os.listdir(rec / "images"))
        log(f"[demo] {card_label_once()} tandem_demo replay+record: {nf} "
            f"frames in {wall:.3f} s ({nf / wall:.3f} FPS, the recorder's "
            f"writer thread included), keyframes "
            f"{len(res['fs'].keyframes)}, backend calls "
            f"{res['backend'].call_num}; recorded {len(images)} images, "
            f"{len(times)} times; launches {counts}")
        if not (nf == DEMO_FRAMES == len(images) == len(times)
                and (rec / "camera.txt").exists()):
            raise AssertionError(f"demo: {nf} frames, {len(images)} images, "
                                 f"{len(times)} times")
        require_launched("demo", counts, ("track_lm", "track_reduce"))
        replay = work / "replay_out"
        torch.cuda.synchronize()
        reset_counts()
        tandem_dataset.main(
            ["preset=dataset", f"files={rec / 'images'}",
             f"calib={rec / 'camera.txt'}", f"result_folder={replay}",
             f"mvsnet_folder={UNIT}", "desired_immature_density=512",
             "log_stuff=1", "debug_save_depth_images=1", "save_dr_video=1",
             "viewer3d=1"], device=dev)
        torch.cuda.synchronize()
        counts_replay = read_counts()
        sha = [hashlib.sha256((d / "poses_dso.txt").read_bytes()).hexdigest()
               for d in (out, replay)]
        cols = [[ln.split()[1:] for ln in (d / "result.txt").read_text()
                 .splitlines()] for d in (out, replay)]
        dirs = {d: len(os.listdir(replay / d)) if (replay / d).is_dir()
                else 0 for d in ("logs", "depths", "dr_video", "view3d")}
        log(f"[demo] {card_label_once()} replay of the recording through "
            f"tandem_dataset: "
            f"poses_dso.txt sha256 {sha[1]} (the demo's {sha[0]}); outputs "
            f"{dirs}, view3d_final.png "
            f"{(replay / 'view3d_final.png').stat().st_size} bytes; "
            f"launches {counts_replay}")
        if sha[0] != sha[1] or cols[0] != cols[1]:
            raise AssertionError("demo: the recording's replay gives other "
                                 "poses than the demo")
        if min(dirs.values()) == 0:
            raise AssertionError(f"demo: an empty output directory: {dirs}")
        require_launched("demo replay", counts_replay,
                         ("bilinear_sample", "track_lm", "track_reduce"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return {"demo": counts, "demo_replay": counts_replay}


def _profiled_events(fn):
    """One call of ``fn`` under torch.profiler: (device events, device busy
    ms, host span ms), or None when three sessions saw no device event
    (the profiler late in a long process)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
        device = [e for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if device:
            busy = sum(e.self_device_time_total for e in device) / 1e3
            return sum(e.count for e in device), busy, span_ms
    return None


def _events_line(ev) -> str:
    if ev is None:
        return "device events not measured (the profiler saw none)"
    n, busy, span = ev
    return (f"{n} device events a call, device busy {busy:.3f} ms of a "
            f"{span:.3f} ms host span (profiler on), idle "
            f"{100 * (1 - busy / span):.1f}%")


def _dvo_bound(H: int, W: int, iterations: int) -> dict:
    """dense_match on one level of H x W: each input read once (the
    reference's I, Z, dI/dx, dI/dy and the current frame's six planes, 40
    B a pixel) and DVO_OPS a pixel an iteration."""
    return _bound(H * W * 40, H * W * iterations * DVO_OPS)


def _raycast_bound(n_allocated: int, H: int, W: int) -> dict:
    """raycast: the splat seed reads each allocated block's sdf and weight
    once (8 B a voxel); each ray reads, a march step, a page-table entry,
    an sdf and a weight (12 B) and, for its colour, nine page-table
    entries, weights and colours (20 B each), and writes its depth and
    colour (16 B); RAYCAST_OPS a ray."""
    rays = H * W
    return _bound(n_allocated * 512 * 8 + rays * (5 * 12 + 9 * 20 + 16),
                  rays * RAYCAST_OPS)


def phase_sensor_640(dev, backend, pack):
    """The sensor-depth hot spots at the deployed size, on the golden
    views and the f32 slice's map (times only: the golden views are not
    photometrically consistent with their poses):
    - dvo's dense_match on level 1 (320x240, max 5 iterations) between
      view 0 and each of views 1-6, each view's depth the slice's splat
      render at its pose, from the identity;
    - raycast at each golden pose, beside render_depth_splat (full walk)
      on the same volume and pose, and the march alone;
    - the Student-t track_frame (``_sensor_track``).
    Returns the launches of the Student-t tracking."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (_raycast_march, raycast,
                                               render_depth_splat, splat_zbuf)
    from tandem_tpu_torch.tracking.dvo import build_rgbd_pyramid, dense_match
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    rgb = pack["image"][0]                            # (V, 3, H, W) RGB
    grays = [torch.from_numpy(_gray(np.ascontiguousarray(
        v.transpose(1, 2, 0)[..., ::-1]))).to(dev) for v in rgb]
    H, W = grays[0].shape
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    fx, fy, cx, cy = (float(pack["K3"][0][i]) for i in ((0, 0), (1, 1),
                                                         (0, 2), (1, 2)))
    poses = [torch.from_numpy(np.asarray(c, np.float32)).to(dev)
             for c in pack["cam_to_world"][0]]
    cfg, vol = backend.cfg, backend.volume
    depths = [render_depth_splat(cfg, vol, K, p, H, W) for p in poses]
    pyrs = [build_rgbd_pyramid(g, d, fx, fy, cx, cy, num_levels=2)
            for g, d in zip(grays, depths)]
    eye = torch.eye(4, device=dev)
    dvo_ms, ns = [], []
    for v in range(1, len(pyrs)):
        def match():
            return dense_match(pyrs[0], pyrs[v], eye, on_level=1)
        out = match()
        if not torch.isfinite(out["T"]).all():
            raise AssertionError(f"sensor 640x480: dense_match view {v} "
                                 "pose not finite")
        ns.append(int(out["n"]))
        dvo_ms.append(cuda_ms(match, iters=10))
    ev = _profiled_events(lambda: dense_match(pyrs[0], pyrs[1], eye,
                                              on_level=1))
    b = _dvo_bound(H // 2, W // 2, 5)
    med = float(np.median(dvo_ms))
    log(f"[sensor 640x480] {card_label_once()} dense_match on level 1 "
        f"({W // 2}x{H // 2}, 5 iterations), views 1-6 against view 0: ms "
        f"{[round(x, 4) for x in dvo_ms]} median {med:.4f} ms (CUDA "
        f"events); n {ns}; bound {b['bound_ms']:.5f} ms ({b['bound_by']}), "
        f"share {100 * b['bound_ms'] / med:.3f}%; {_events_line(ev)}")

    counts = _sensor_track(dev, backend, pack, grays)

    ray_ms, splat_ms, march_ms, hits = [], [], [], []
    for v, p in enumerate(poses):
        d, _ = raycast(cfg, vol, (K, p), H, W)
        if not torch.isfinite(d).all():
            raise AssertionError(f"sensor 640x480: raycast view {v} not "
                                 "finite")
        both = (d > 0) & (depths[v] > 0)
        hits.append((float((d > 0).float().mean()),
                     float((d[both] - depths[v][both]).abs().median())
                     / cfg.voxel_size if both.any() else float("nan")))
        ray_ms.append(cuda_ms(lambda: raycast(cfg, vol, (K, p), H, W),
                              iters=5))
        splat_ms.append(cuda_ms(lambda: render_depth_splat(cfg, vol, K, p,
                                                           H, W), iters=5))
        zbuf = splat_zbuf(cfg, vol, K, p, H, W)
        march_ms.append(cuda_ms(lambda: _raycast_march(cfg, vol, K, p, zbuf,
                                                       H, W), iters=5))
    ev = _profiled_events(lambda: raycast(cfg, vol, (K, poses[0]), H, W))
    b = _raycast_bound(vol.n_allocated, H, W)
    med = float(np.median(ray_ms))
    log(f"[sensor 640x480] raycast on the f32 slice's map (n_allocated "
        f"{vol.n_allocated}) at the 7 golden poses: ms "
        f"{[round(x, 4) for x in ray_ms]} median {med:.4f} (the march "
        f"alone {float(np.median(march_ms)):.4f}); render_depth_splat "
        f"on the same volume and poses median "
        f"{float(np.median(splat_ms)):.4f} ms (CUDA events); hit share "
        f"and median |raycast - splat| in voxels "
        f"{[(round(h, 4), round(e, 3)) for h, e in hits]}; bound "
        f"{b['bound_ms']:.5f} ms ({b['bound_by']}), share "
        f"{100 * b['bound_ms'] / med:.3f}%; {_events_line(ev)}")
    return counts


def _sensor_track(dev, backend, pack, grays) -> dict:
    """The RGB-D path's fallback tracker at the deployed size: the
    Student-t track_frame of golden views 1-6 against the dense reference
    on view 0 (the slice's rendered depth, as phase track 640x480 builds
    it), from the identity; it must launch track_lm (one a level) and
    K6. Times only (host clock, synced), iterations, host reads a frame.
    Returns the launches."""
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    fx, fy, cx, cy = (float(pack["K3"][0][i]) for i in ((0, 0), (1, 1),
                                                         (0, 2), (1, 2)))
    dm = backend.get_tracking_depth_map()
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    ref = _dense_ref(dev, dm["depth"], c2w, grays[0].cpu().numpy(), K, fx,
                     fy, cx, cy)
    eye = torch.eye(4, device=dev)
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    reset_counts()
    ms, iters = [], []
    for img in grays[1:]:
        t, out = _median_ms(lambda: track_frame(ref, img, eye, aff0, True),
                            reps=3)
        if not torch.isfinite(out["T"]).all():
            raise AssertionError("sensor 640x480: a Student-t track_frame "
                                 "pose is not finite")
        ms.append(t)
        iters.append(out["lm_iters"])
    counts = read_counts()
    require_launched("sensor 640x480", counts, ("track_lm", "track_reduce"))
    if counts["track_lm"] != 6 * 3 * len(ms):
        raise AssertionError(f"sensor 640x480: {counts['track_lm']} track_lm "
                             f"launches for {3 * len(ms)} frames")
    reads = _host_reads(lambda: track_frame(ref, grays[1], eye, aff0, True))
    log(f"[sensor 640x480] {card_label_once()} Student-t track_frame "
        f"(tdist=True), views 1-6 against view 0: ms/frame "
        f"{[round(x, 3) for x in ms]} median {float(np.median(ms)):.3f} ms "
        f"(host clock, synced, median of 3); LM iterations by level "
        f"{iters}; track_lm one launch a level; host reads a frame {reads}")
    return counts


def _rgbd_run(dev, out_dir: Path, unit: bool, frames: int = 64,
              count_syncs: bool = False) -> dict:
    """FullSystem(rgbd=True) through the API on the trajectory fixture's
    frames and sensor depths (depths/*.png, scale 0.0002), with the dataset
    preset as tandem_dataset builds it (``unit``: the trained abl04 unit,
    bf16, in the backend): its SE(3) ATE without scale, the dvo and
    fallback frames, FPS and the Timer split, the launches of each kernel
    and, with ``count_syncs``, the host reads."""
    import hashlib
    import warnings

    import torch

    from tandem_tpu_torch.cli.golden import load_model_config
    from tandem_tpu_torch.data.reader import RGBDReader
    from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                           load_tum_trajectory, tum_to_xyz)
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.full_system import (
        FullSystem, make_full_system_options)
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    from tandem_tpu_torch.settings import parse_arguments, preset
    from tandem_tpu_torch.utils.timer import Timer
    s = parse_arguments(["rgbd=1"], base=preset("dataset"))
    fx, fy, cx, cy, W, H = 200.0, 200.0, 127.5, 95.5, 256, 192
    K_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    timer = Timer(enabled=True)
    backend = None
    if unit:
        model = CvaMVSNet(**load_model_config(str(UNIT)),
                          dtype=torch.bfloat16)
        runner = MvsnetRunner(model, load_variables(
            str(UNIT / "model_variables.pkl")), H, W,
            view_num=s.dr_mvsnet_view_num, device=dev)
        backend = TandemBackend(runner, TsdfConfig(), K_mat, H, W,
                                mesh_extraction_freq=s.mesh_extraction_freq,
                                timer=timer)
    fs = FullSystem(fx, fy, cx, cy, H, W, options=make_full_system_options(s),
                    backend=backend, timer=timer, device=dev)
    reader = RGBDReader(str(FIXTURE / "images"),
                        depth_path=str(FIXTURE / "depths"),
                        depth_scale=2e-4)
    torch.cuda.synchronize()
    reset_counts()
    calls0 = edge_calls()

    def loop():
        for i in range(frames):
            tid = timer.start_timing("read_frame")
            gray, ts, _ = reader.get_image(i)
            bgr, depth = reader.get_image_bgr(i), reader.get_depth(i)
            timer.end_timing("read_frame", tid)
            fs.add_active_frame(gray, i, ts, bgr=bgr, depth=depth)
            if fs.is_lost:
                raise AssertionError(f"rgbd: lost at frame {i}")
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = None
    if count_syncs:
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            loop()
        torch.cuda.set_sync_debug_mode(0)
        syncs = sum("synchroniz" in str(w.message) for w in seen)
    else:
        loop()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    fs.write_results(str(out_dir))
    gt = load_tum_trajectory(str(FIXTURE / "gt_tum.txt"))
    est = load_tum_trajectory(str(out_dir / "result.txt"))
    pairs = associate(gt, est)
    ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in pairs]),
                       tum_to_xyz(est, [b for _, b in pairs]),
                       with_scale=False)
    lines = (out_dir / "result.txt").read_bytes().splitlines(True)
    return {"fs": fs, "backend": backend, "timer": timer,
            "seconds": seconds, "counts": counts, "syncs": syncs,
            "edge_calls": edge_calls() - calls0, "pairs": len(pairs),
            "ate": ate, "frames": frames, "reader": reader,
            "digest": hashlib.sha256(b"".join(lines)).hexdigest(),
            "digest_48": hashlib.sha256(b"".join(lines[:48])).hexdigest()}


def _host_reads(fn) -> int:
    """The synchronizing CUDA calls of one call of ``fn``."""
    import warnings

    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _rgbd_op_times(dev, r) -> dict:
    """CUDA-event ms a call on the run's final state (the last keyframe's
    dvo and tracking references against the last frame) of dense_match
    (level 1), calc_res_eval, the Student-t track_frame (dvo's fallback)
    and the retry ladder's first call (track_frame_multi, 5 candidates),
    and of the Student-t LM on level 0 (``_lm_level``: one launch of
    track_lm in the t-mode) at B = 1 and 5 with its steps, host reads,
    device events and bound."""
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import (
        MAX_ITERS, NUM_LEVELS, _lm_level, _planes, build_pyramid,
        calc_res_eval, track_frame, track_frame_multi)
    from tandem_tpu_torch.tracking.dvo import build_rgbd_pyramid, dense_match
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    fs, reader = r["fs"], r["reader"]
    ref = fs.tracker_ref
    i = r["frames"] - 1
    img = torch.from_numpy(reader.get_image(i)[0].astype(np.float32)).to(dev)
    depth = torch.from_numpy(reader.get_depth(i)).to(dev)
    cur = build_rgbd_pyramid(img, depth, *fs.K, num_levels=2)
    T = torch.from_numpy(np.linalg.inv(fs.last_c2w) @ fs.ref_kf.c2w).to(
        dev, torch.float32)
    aff = torch.tensor([1.0, 0.0], device=dev)
    H, W = img.shape
    T5 = T[None].expand(5, 4, 4).contiguous()
    out = {"dense_match": {"ms": cuda_ms(lambda: dense_match(
        fs._dvo_ref, cur, T, on_level=1), iters=20),
        **_dvo_bound(H // 2, W // 2, 5)},
        "calc_res_eval": {"ms": cuda_ms(lambda: calc_res_eval(
            ref, img, T, aff), iters=20)},
        "track_frame_tdist": {"ms": cuda_ms(lambda: track_frame(
            ref, img, T, aff, True), iters=3, warmup=1)},
        "track_frame_multi_tdist_B5": {"ms": cuda_ms(
            lambda: track_frame_multi(ref, img, T5, aff, True), iters=3,
            warmup=1)}}
    pts = ref.level(0)
    planes = _planes(build_pyramid(img, NUM_LEVELS)[0])
    for B in (1, 5):
        Tb = T[None].expand(B, 4, 4).contiguous()
        affb = aff[None].expand(B, 2).contiguous()

        def level():
            return _lm_level(Tb, affb, pts, planes, ref.K[0], MAX_ITERS[0],
                             tdist=True)
        res = level()
        steps = int(res[4])
        ms = cuda_ms(level, iters=5)
        ev = _profiled_events(level)
        b = _bound(_nbytes(Tb, affb, *pts, *planes, *res[:4]),
                   (1 + steps) * (TRACK_OPS + TDIST_OPS)
                   * int(pts[4].sum()) * B)
        out[f"tdist_lm_level0_B{B}"] = {
            "ms": ms, "steps": steps, "host_reads": _host_reads(level),
            "device_events": None if ev is None else ev[0],
            "device_busy_ms": None if ev is None else ev[1],
            **b, "share": b["bound_ms"] / ms, "library_ms": None}
    return out


def phase_rgbd(dev) -> dict:
    """FullSystem(rgbd=True) through the API on tests/fixtures/replica_traj
    with its sensor depths: VO only on the 64 frames, then with the trained
    abl04 unit (bf16) on the first 48 (a frame costs ~1 s on this path,
    most of it the Student-t retry ladder, see PERF.md; the backend's first
    call comes at frame 39, the seventh keyframe). The VO run must track
    >= SLAM_MIN_FRAMES frames with an SE(3) ATE (no scale) within
    RGBD_ATE_BOUND and keep dvo's pose on RGBD_DVO_POSES frames give or
    take RGBD_DVO_POSES_SLACK; both runs must take the dvo branch on at
    least one frame and launch K6 (calc_res_eval); the unit run must call
    the backend, launch K1 and bilinear_sample, and its result.txt must
    equal the VO run's first 48 lines (sha256): in RGB-D mode the sensor
    depth, not the unit's, feeds the tracker, so the two runs compute the
    same poses."""
    import shutil
    import tempfile

    import torch
    work = Path(tempfile.mkdtemp(prefix="rgbd_"))
    runs = {}
    try:
        for tag, unit, frames, syncs in (("vo", False, 64, True),
                                         ("full", True, 48, False)):
            (work / tag).mkdir()
            runs[tag] = r = _rgbd_run(dev, work / tag, unit, frames=frames,
                                      count_syncs=syncs)
            fs, nf = r["fs"], r["frames"]
            dvo = fs.n_dvo_frames - fs.n_dvo_fallbacks
            split = {k: (len(v), round(float(np.mean(v)), 3))
                     for k, v in sorted(r["timer"].intervals.items())}
            log(f"[rgbd {tag}] {card_label_once()} frames {nf}, "
                f"{r['seconds']:.3f} s, FPS {nf / r['seconds']:.3f}, "
                f"keyframes {len(fs.keyframes)}; dvo branch {dvo} frames, "
                f"fallback to track_frame {fs.n_dvo_fallbacks}, retry "
                f"ladder on {fs.n_retracks}, dvo's pose kept on "
                f"{fs.n_dvo_poses}; ATE (SE(3), no scale) "
                f"{r['ate']['rmse'] * 1e3:.3f} mm over {r['pairs']}/{nf} "
                f"frames (bound {RGBD_ATE_BOUND * 1e3:.3f} mm at 64); "
                f"result.txt sha256 {r['digest']}, its first 48 lines "
                f"{r['digest_48']}")
            log(f"[rgbd {tag}] Timer (count, mean ms, host clock): {split}; "
                f"kernel launches {r['counts']}"
                + (f"; host reads {r['syncs']} ({r['syncs'] / nf:.2f} a "
                   f"frame)" if r["syncs"] is not None else ""))
            if dvo < 1:
                raise AssertionError(f"rgbd {tag}: no frame took the dvo "
                                     "branch")
            if nf == 64:
                if r["pairs"] < SLAM_MIN_FRAMES or not (
                        r["ate"]["rmse"] <= RGBD_ATE_BOUND):
                    raise AssertionError(f"rgbd {tag}: {r['pairs']} frames, "
                                         f"ATE {r['ate']['rmse'] * 1e3:.3f}"
                                         " mm")
                if abs(fs.n_dvo_poses - RGBD_DVO_POSES) > \
                        RGBD_DVO_POSES_SLACK:
                    raise AssertionError(
                        f"rgbd {tag}: dvo's pose kept on {fs.n_dvo_poses} "
                        f"frames, the JAX package's {RGBD_DVO_POSES} "
                        f"+- {RGBD_DVO_POSES_SLACK}")
            require_launched(f"rgbd {tag}", r["counts"], ("track_reduce",),
                             at_least=dvo)
            require_launched(f"rgbd {tag}", r["counts"], ("track_lm",))
            if unit:
                backend = r["backend"]
                log(f"[rgbd {tag}] backend calls {backend.call_num}, "
                    f"{backend.last_fuse}; "
                    + require_edge_filter(f"rgbd {tag}",
                                          r["counts"]["edge_kth"],
                                          r["edge_calls"], 1))
                if backend.call_num < 1:
                    raise AssertionError(f"rgbd {tag}: no backend call")
                require_launched(f"rgbd {tag}", r["counts"],
                                 ("bilinear_sample",))
        if runs["full"]["digest"] != runs["vo"]["digest_48"]:
            raise AssertionError("rgbd: the unit run's result.txt differs "
                                 "from the VO run's first 48 lines")
        log("[rgbd] the 48-frame unit run's result.txt equals the first 48 "
            "lines of the VO run's (sha256)")
        times = _rgbd_op_times(dev, runs["vo"])
        log(f"[rgbd] {card_label_once()} CUDA events ms a call on the VO "
            f"run's final state (256x192): {json.dumps(times)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = {f"rgbd_{k}": v["counts"] for k, v in runs.items()}
    del runs
    torch.cuda.empty_cache()
    return counts


def phase_dr_debug(dev) -> dict:
    """The port's dr_debug_example CLI on the card over replica_traj with
    its GT poses (gt_tum.txt) at the CLI's default --limit 20: per frame
    the allocate, integrate and raycast ms (host clock, synchronized),
    the rendered-valid share, and the render against the frame's own GT
    depth: it must hit > 0.8 of the GT-depth pixels with a median |error|
    < 2 voxels. The mesh must not be empty."""
    import contextlib
    import io
    import shutil
    import tempfile

    from tandem_tpu_torch.cli import dr_debug_example as cli
    work = Path(tempfile.mkdtemp(prefix="dr_debug_"))
    try:
        args = cli.parser.parse_args([
            "--rgb", str(FIXTURE / "images"), "--depth",
            str(FIXTURE / "depths"), "--calib",
            str(FIXTURE / "camera_dso.txt"), "--poses",
            str(FIXTURE / "gt_tum.txt"), "--out", str(work)])
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.main(args)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        from tandem_tpu_torch.data.reader import RGBDReader
        reader = RGBDReader(str(FIXTURE / "images"),
                            depth_path=str(FIXTURE / "depths"),
                            depth_scale=res["depth_scale"])
        vs = res["cfg"].voxel_size
        rows = []
        for i, (r, t) in enumerate(zip(res["renders"], res["times"])):
            gt = reader.get_depth(i)
            both = (gt > 0) & (r > 0)
            hit = float(both.sum() / max((gt > 0).sum(), 1))
            med = float(np.median(np.abs(r[both] - gt[both])) / vs)
            rows.append((i, round(t["allocate"] * 1e3, 3),
                         round(t["integrate"] * 1e3, 3),
                         round(t["raycast"] * 1e3, 3),
                         round(float((r > 0).mean()), 4), round(hit, 4),
                         round(med, 3)))
            if not (hit > 0.8 and med < 2.0):
                raise AssertionError(f"dr_debug frame {i}: hit {hit:.4f}, "
                                     f"median |error| {med:.3f} voxels")
        lines = buf.getvalue().splitlines()
        log(f"[dr_debug] {card_label_once()} {len(rows)} frames in "
            f"{seconds:.3f} s (mesh and PNGs included); the CLI printed "
            f"{lines[0]!r} ... {lines[-1]!r}")
        log("[dr_debug] per frame (index, allocate ms, integrate ms, raycast "
            "ms, rendered-valid share, hit share of the GT-depth pixels, "
            f"median |error| in voxels), host clock synchronized: {rows}")
        log(f"[dr_debug] n_allocated {res['volume'].n_allocated}, mesh "
            f"{res['vertices']} vertices; kernel launches {counts}")
        if res["vertices"] == 0 or len(rows) != args.limit:
            raise AssertionError(f"dr_debug: an empty mesh or not "
                                 f"{args.limit} frames")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def _train_cli(dev, out_dir: Path, pretrained: str = None,
               *overrides) -> dict:
    """One run of the port's tandem_train CLI on the trajectory fixture
    (abl04 config, 640x480, B = 2, one epoch, on the card): its result and
    the kernel launches of the run."""
    import torch

    from tandem_tpu_torch.cli import tandem_train
    argv = [str(out_dir), "--config",
            str(REPO / "tandem_tpu_torch" / "configs"
                / "abl04_fewer_depth_planes.yaml"),
            *(["--pretrained", pretrained] if pretrained else []),
            "DATA.ROOT_DIR", str(TRAIN_ROOT), "TRAIN.EPOCHS", "1",
            "IO.LOG_INTERVAL", "1", *overrides]
    torch.cuda.synchronize()
    reset_counts()
    res = tandem_train.main(tandem_train.parser.parse_intermixed_args(argv))
    torch.cuda.synchronize()
    return {"res": res, "counts": read_counts()}


def _require_step_launches(path: str, counts: dict, steps: int,
                           per_step: int):
    """The forward sample and its backward kernel launched in every step:
    once a source view and stage each."""
    if counts["warp_sample_grad"] != per_step * steps \
            or counts["bilinear_sample"] < per_step * steps:
        raise AssertionError(f"{path}: {counts['bilinear_sample']} sample "
                             f"and {counts['warp_sample_grad']} backward "
                             f"launches in {steps} steps (want "
                             f"{per_step} each a step)")


def _recorded_step(step, state, batch):
    """One train step with every backward-kernel call's inputs and float32
    sums recorded: (state, metrics, the calls). The wrapper counts its
    launches on the module's name, the recorder's while it stands there;
    they are added to the wrapper's after the step."""
    from tandem_tpu_torch.ops import bilinear_sample as bs
    kernel, calls = bs.warp_sample_grad, []

    def recording(grad_out, ref_to_src, depth, min_depth_thres=0.001):
        acc = kernel(grad_out, ref_to_src, depth, min_depth_thres)
        calls.append((grad_out.clone(), ref_to_src.clone(), depth.clone(),
                      min_depth_thres, acc.clone()))
        return acc
    recording.launches = 0
    bs.warp_sample_grad = recording
    try:
        state, m = step(state, batch)
    finally:
        bs.warp_sample_grad = kernel
        kernel.launches += recording.launches
    return state, m, calls


def _recorded_times(calls) -> dict:
    """The backward kernel and grid_sample's backward
    (aten.grid_sampler_2d_backward: the input's gradient on the warp's
    grid) on each recorded call of a train step, timed with CUDA events
    (median of 10 back-to-back calls: the device's time, as the calls
    queue faster than they run), summed by stage shape (D, H, W, C) and in
    all, with the samples a touched source cell. CUDA events, not the
    profiler: late in a long run its sessions saw only part of the
    kernels, then none. These launches are measurements: the kernel's
    launch count is left as the step made it."""
    import torch

    from tandem_tpu_torch.experiments.grad_contention import cells
    from tandem_tpu_torch.ops.bilinear_sample import (sweep_positions,
                                                      warp_sample_grad)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    launches = warp_sample_grad.launches
    out = {}
    for g, mat, depth, thres, _ in calls:
        B, D, H, W, C = g.shape
        px, py, z = sweep_positions(mat, depth, H, W)
        feat = torch.zeros((B, H, W, C), device=g.device, dtype=g.dtype)
        nchw, grid = _grid_sample_args(feat, px, py, ~(z < thres), H, W)
        gnchw = g.reshape(B, D * H, W, C).permute(0, 3, 1, 2).contiguous()
        share = cells(mat, depth, H, W)
        r = out.setdefault((D, H, W, C), {"calls": 0, "kernel_ms": 0.0,
                                          "grid_sample_ms": 0.0, "kept": 0,
                                          "cells": 0})
        r["calls"] += 1
        r["kernel_ms"] += cuda_ms(
            lambda: warp_sample_grad(g, mat, depth, thres), iters=10)
        r["grid_sample_ms"] += cuda_ms(
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                gnchw, nchw, grid, 0, 0, True, [True, False]), iters=10)
        r["kept"] += share["kept"]
        r["cells"] += share["cells"]
    warp_sample_grad.launches = launches
    return out


def _times_line(times: dict) -> str:
    parts = [f"D={D} {W}x{H} C={C}: {r['calls']} calls, kernel "
             f"{r['kernel_ms']:.4f} ms, grid_sample backward "
             f"{r['grid_sample_ms']:.4f} ms, "
             f"{r['kept'] / max(r['cells'], 1):.2f} samples a touched cell"
             for (D, H, W, C), r in times.items()]
    k = sum(r["kernel_ms"] for r in times.values())
    lib = sum(r["grid_sample_ms"] for r in times.values())
    return (f"the first step's backward calls by CUDA events: kernel "
            f"{k:.4f} ms, grid_sample backward {lib:.4f} ms in all ("
            + "; ".join(parts) + ")")


def _curve(dev, config, batch, steps: int) -> dict:
    """``steps`` train steps on one batch from the seeded initialization:
    losses, stage-1 abs_rel, host-clock ms a step (synchronized), the
    first step's backward-kernel calls, each held to its plain version
    (``_grad_error``, every batch item) and timed (``_recorded_times``),
    and the peak device memory of the steps after it (the first holds the
    recorded calls)."""
    import torch

    from tandem_tpu_torch.train import trainer as pt
    model, state = pt.create_train_state(
        config, torch.Generator().manual_seed(0), 200, device=dev)
    step = pt.make_train_step(model, config)
    losses, absrel, ms = [], [], []
    torch.cuda.synchronize()
    for i in range(steps):
        t0 = time.perf_counter()
        if i == 0:
            state, m, calls = _recorded_step(step, state, batch)
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        absrel.append(float(m["stage1/abs_rel"]))
        if i == 0:
            errs = [_grad_error(f"train step's backward call {k} "
                                f"{tuple(g.shape)} {g.dtype}", acc, g, mat,
                                depth, thres)
                    for k, (g, mat, depth, thres, acc) in enumerate(calls)]
            n_calls = len(calls)
            times = _recorded_times(calls)
            del calls
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    return {"losses": losses, "absrel": absrel, "ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "grad_calls": n_calls, "grad_times": times,
            "grad_err": max(e / top for e, top in errs)}


def phase_train(dev) -> dict:
    """The training half on the card: tandem_train on replica_traj (abl04,
    640x480, B = 2, f32): one epoch (7 steps) with a checkpoint, then a
    resume from it with --pretrained (the state's step, optimizer and
    schedule come back: the next checkpoint is step 14); then the learning
    curve of tests/test_train_learns.py at abl04 640x480 (CURVE_STEPS steps
    on tuples 0 and 7 from the seeded initialization: finite, the mean of
    the last 5 losses under 0.5 x the mean of the first 5) and BF16_STEPS
    bf16 steps (finite, the last 3 below the first 3). Every step launches
    the forward sample and its backward kernel 18 times each (6 source
    views x 3 stages)."""
    import shutil
    import tempfile

    import torch

    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    from tandem_tpu_torch.train import trainer as pt
    work = Path(tempfile.mkdtemp(prefix="train_"))
    paths = {}
    per_step = 3 * 6
    try:
        first = _train_cli(dev, work / "epoch")
        r = first["res"]
        _require_step_launches("train epoch", first["counts"], r["steps"],
                               per_step)
        ckpt = r["checkpoints"][-1]
        if r["steps"] != 7 or not ckpt.endswith("step_00000007") \
                or not np.isfinite(r["losses"]).all():
            raise AssertionError(f"train epoch: {r['steps']} steps, "
                                 f"checkpoint {ckpt}, losses {r['losses']}")
        log(f"[train] {card_label_once()} tandem_train abl04 640x480 B=2 "
            f"f32, one epoch of replica_traj: {r['steps']} steps, losses "
            f"{[round(x, 4) for x in r['losses']]}, ms a step (host clock "
            f"from the decoded batch to the synchronized step, upload "
            f"included) {[round(x * 1e3, 1) for x in r['seconds']]}"
            f"; checkpoint {Path(ckpt).name}; launches {first['counts']}")
        paths["train_epoch"] = first["counts"]
        again = _train_cli(dev, work / "resume", ckpt)
        r2 = again["res"]
        _require_step_launches("train resume", again["counts"], r2["steps"],
                               per_step)
        if not r2["checkpoints"][-1].endswith("step_00000014") \
                or not np.isfinite(r2["losses"]).all():
            raise AssertionError(f"train resume: checkpoints "
                                 f"{r2['checkpoints']}, losses {r2['losses']}")
        log(f"[train] resumed with --pretrained {Path(ckpt).name}: "
            f"{r2['steps']} steps to {Path(r2['checkpoints'][-1]).name}, "
            f"losses {[round(x, 4) for x in r2['losses']]}")
        paths["train_resume"] = again["counts"]

        config = pcfg.default()
        pcfg.merge_from_file(config, str(REPO / "tandem_tpu_torch" / "configs"
                                         / "abl04_fewer_depth_planes.yaml"))
        ds = MVSDataset(str(TRAIN_ROOT), "val", height=480, width=640)
        batch = pt.batch_to_device(collate([ds[0], ds[7]]), dev)
        torch.cuda.synchronize()
        reset_counts()
        curve = _curve(dev, config, batch, CURVE_STEPS)
        counts = read_counts()
        _require_step_launches("train curve", counts, CURVE_STEPS, per_step)
        paths["train_curve"] = counts
        L = curve["losses"]
        log(f"[train] {card_label_once()} learning curve, abl04 640x480 "
            f"B=2 f32, {CURVE_STEPS} steps on tuples 0 and 7: loss "
            f"{L[0]:.4f} -> {L[-1]:.4f} (first 5 mean {np.mean(L[:5]):.4f}, "
            f"last 5 {np.mean(L[-5:]):.4f}), stage-1 abs_rel "
            f"{curve['absrel'][0]:.4f} -> {curve['absrel'][-1]:.4f}; step "
            f"ms (host clock, synchronized) first {curve['ms'][0]:.1f}, "
            f"median after it {np.median(curve['ms'][1:]):.2f} (min "
            f"{min(curve['ms'][1:]):.2f}, max {max(curve['ms'][1:]):.2f}); "
            f"peak memory (steps 2-{CURVE_STEPS}) {curve['peak_gb']:.2f} "
            f"GB; the first step's "
            f"{curve['grad_calls']} backward calls (B=2) within "
            f"{curve['grad_err']:.2e} of their plain gradient's max (bar "
            f"{GRAD_TOL:g}, each item); all losses "
            f"{[round(x, 4) for x in L]}")
        log(f"[train] f32 curve, {_times_line(curve['grad_times'])}")
        if not (np.isfinite(L).all() and np.mean(L[-5:])
                < 0.5 * np.mean(L[:5])):
            raise AssertionError(f"train curve: losses {L}")
        config["TRAIN.COMPUTE_DTYPE"] = "bfloat16"
        reset_counts()
        bf = _curve(dev, config, batch, BF16_STEPS)
        counts = read_counts()
        _require_step_launches("train bf16", counts, BF16_STEPS, per_step)
        paths["train_bf16"] = counts
        Lb = bf["losses"]
        log(f"[train] bf16, {BF16_STEPS} steps: losses "
            f"{[round(x, 4) for x in Lb]}; step ms median after the first "
            f"{np.median(bf['ms'][1:]):.2f}; peak memory "
            f"{bf['peak_gb']:.2f} GB; the first step's {bf['grad_calls']} "
            f"backward calls within {bf['grad_err']:.2e} of their plain "
            f"gradient's max")
        log(f"[train] bf16 curve, {_times_line(bf['grad_times'])}")
        if not (np.isfinite(Lb).all()
                and np.mean(Lb[-3:]) < np.mean(Lb[:3])):
            raise AssertionError(f"train bf16: losses {Lb}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return paths


# The parallel phase: view shards of one forward, and the tuples of the
# trajectory fixture that make the data-parallel global batch of 4.
SHARD_COUNTS = (2, 4)
# f32, against the eager runner. The shards' FeatureNets see fewer images
# and the volumes are summed in another order, so the depth moves by what
# f32 rounding moves this cascade. The phase measures that floor, what one
# ulp of the input image moves the eager forward's dense depth by, and
# holds the shards' depth within SHARD_FLOOR_X times it (the 5x of
# tests/test_torch_train.py's gradient bar), never tighter than the atol
# of tests/test_parallel.py:54-55's (rtol, atol); the pixels over those
# are counted. At 640x480 on the card that floor is above 1e-4 (2.685e-04
# against the shards' 3.182e-04 at n = 2 on an NVIDIA H100 80GB HBM3 at
# 700 W).
SHARD_FLOOR_X = 5
SHARD_DEPTH_TOL = (1e-4, 1e-4)
SHARD_CONF_TOL = (1e-3, 1e-3)
# The confidence reads the plane at the truncated expected index, and the
# filter keeps a rank of the edge values: where the last bits cross either
# cut, a pixel's confidence jumps or the pixel is kept by one runner only.
# At most this share of the pixels may (the CPU rehearsal at 512x320: 3
# and 2 of 163,840).
SHARD_FLIP_SHARE = 1e-4
SHARD_REPS = 3               # runner calls timed a runner, in turns
# bf16: the JAX dry run's bar (__graft_entry__.py:249) on the relative L1
# error, mean |d - d0| / mean |d0|. Its max |d - d0| / max |d0| is not
# held at 640x480 with the trained weights: there bf16 itself moves some
# pixels by ~25% (the CPU rehearsal at 512x320: the eager bf16 runner
# against the f32 one 2.4e-1 by max, 2.0e-2 by L1; the sums' order, the
# shards against the eager bf16 runner, 8.5e-2 and 6.2e-3).
SHARD_BF16_REL = 2e-2
DP_TUPLES = (0, 3, 7, 10)
DP_SIZE = (480, 640)
DP_STEPS = 3
DP_RTOL = 5e-3               # tests/test_train_learns.py:161, the JAX gate


def _all_counts(part: dict) -> dict:
    return {name: part.get(name, 0) for name in KERNELS}


def _runner_outputs(runner, pack) -> dict:
    """One runner call on the golden pack's window, as numpy."""
    bgrs, poses, _ = golden_window(pack)
    runner.call_async(bgrs, poses, pack["K3"][0],
                      float(pack["depth_min"][0]), float(pack["depth_max"][0]),
                      float(pack["discard_percentage"]))
    return runner.get_result()


def _view_shards(dev, dtype, paths: dict) -> None:
    """The trained unit's view-sharded runner on [cuda:0] * n against the
    eager runner on the golden window, with its launches and sums."""
    import torch

    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.parallel import collectives
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    dn = str(dtype).split(".")[-1]
    eager, pack = load_runner(dev, dtype)
    want = _runner_outputs(eager, pack)
    if dtype == torch.float32:
        base = _golden_forward(eager, pack, dev).stage3.depth_dense
        nudged = _golden_forward(eager, pack, dev,
                                 1 + 2 ** -23).stage3.depth_dense
        floor = float((nudged - base).abs().max())
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    variables = load_variables(UNIT / "model_variables.pkl")
    H, W, V = eager.height, eager.width, eager.view_num
    for n in SHARD_COUNTS:
        runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=dtype), variables, H, W,
                              view_num=V, devices=[dev] * n)
        torch.cuda.synchronize()
        reset_counts()
        calls = edge_calls()
        with collectives.record() as payloads:
            got = _runner_outputs(runner, pack)
        counts, calls = read_counts(), edge_calls() - calls
        paths[f"parallel_view_{dn}_n{n}"] = counts
        if counts["bilinear_sample"] != 18:
            raise AssertionError(f"view shards {dn} n={n}: warp_sample "
                                 f"launched {counts['bilinear_sample']} "
                                 "times, want 18")
        edge = require_edge_filter(f"view shards {dn} n={n}",
                                   counts["edge_kth"], calls, 1)
        link = collectives.link_bytes_per_card(payloads, n)
        ms = [], []
        for _ in range(SHARD_REPS):
            for r, out in ((eager, ms[0]), (runner, ms[1])):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _runner_outputs(r, pack)
                out.append((time.perf_counter() - t0) * 1e3)
        d, d0 = got["depth_dense"], want["depth_dense"]
        if dtype == torch.float32:
            def over(a, b, tol):
                return np.abs(a - b) > tol[1] + tol[0] * np.abs(b)
            kept, kept0 = got["depth"] > 0, want["depth"] > 0
            both = kept & kept0
            deep = over(d, d0, SHARD_DEPTH_TOL).sum() + over(
                got["depth"][both], want["depth"][both], SHARD_DEPTH_TOL).sum()
            gap = max(float(np.abs(d - d0).max()), float(np.abs(
                got["depth"][both] - want["depth"][both]).max()))
            bar = max(SHARD_DEPTH_TOL[1], SHARD_FLOOR_X * floor)
            cgap = np.abs(got["confidence_dense"] - want["confidence_dense"])
            flips = over(got["confidence_dense"], want["confidence_dense"],
                         SHARD_CONF_TOL)
            mae = {k: float(np.abs(got[k] - pack[f"out.stage3.{k}"]).mean())
                   for k in ("depth", "confidence", "depth_dense",
                             "confidence_dense")}
            worst = max(mae.values())
            verdict = (
                f"depth max {gap:.3e} (dense, and filtered where both keep "
                f"a pixel; bar {bar:.3e}: {SHARD_FLOOR_X} x the {floor:.3e} "
                f"that one ulp of the input moves the eager forward's by), "
                f"{int(deep)} px over rtol/atol {SHARD_DEPTH_TOL}; "
                f"confidence max {float(cgap.max()):.3e}, "
                f"{int(flips.sum())} px over {SHARD_CONF_TOL}; "
                f"{int((kept != kept0).sum())} px kept by one runner only; "
                f"golden worst MAE {worst:.3e} (bar {GOLDEN_TOL})")
            ok = (gap <= bar and flips.mean() <= SHARD_FLIP_SHARE
                  and (kept != kept0).mean() <= SHARD_FLIP_SHARE
                  and worst < GOLDEN_TOL)
        else:
            rel = float(np.abs(d - d0).mean() / np.abs(d0).mean())
            top = float(np.abs(d - d0).max() / np.abs(d0).max())
            verdict = (f"dense depth relative L1 error {rel:.3e} against "
                       f"the eager bf16 runner's (bar {SHARD_BF16_REL}; by "
                       f"max {top:.3e})")
            ok = rel < SHARD_BF16_REL
        log(f"[parallel] {card_label_once()} view shards {dn} abl04 {W}x{H} "
            f"V={V} over [cuda:0] x {n}: {verdict}; warp_sample 18 "
            f"launches, {edge}; {link['n_collectives']} sums, payload "
            f"{link['payload_bytes'] / 1e6:.3f} MB, ring "
            f"{link['link_bytes'] / 1e6:.3f} MB a card across {n} cards; "
            f"ms a runner call (host clock, in turns; {n} shards in turn on "
            f"one card, not a speed) eager {[round(x, 3) for x in ms[0]]}, "
            f"sharded {[round(x, 3) for x in ms[1]]}")
        if not ok:
            raise AssertionError(f"view shards {dn} n={n}: {verdict}")
        del runner
    del eager
    torch.cuda.empty_cache()


def phase_parallel(dev) -> dict:
    """The multi-card paths on the one card: the trained unit's
    view-sharded runner over [cuda:0] * 2 and * 4 against the eager runner
    (f32: depth within SHARD_FLOOR_X times the cascade's one-ulp floor,
    confidence within SHARD_CONF_TOL but for SHARD_FLIP_SHARE of the
    pixels, the golden MAE under GOLDEN_TOL;
    bf16: within SHARD_BF16_REL), with its launches and sums; 2 gloo ranks
    on cuda:0 (abl04 640x480 f32, 2 rows each of the trajectory fixture's
    tuples DP_TUPLES, DP_STEPS steps) against one process at world_size 2
    on the global batch of 4 (losses within DP_RTOL), each rank's steps
    launching the sample and its backward kernel 18 times a step; and
    tandem_train TRAIN.DEVICE mesh, an NCCL group of one, 2 steps with its
    checkpoint."""
    import shutil
    import tempfile

    import torch

    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.cli import tandem_train
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    from tandem_tpu_torch.parallel.dryrun import (run_ranks, train_rank,
                                                  train_steps)
    from tandem_tpu_torch.train import trainer as pt
    paths = {}
    for dtype in (torch.float32, torch.bfloat16):
        _view_shards(dev, dtype, paths)

    config = pcfg.default()
    pcfg.merge_from_file(config, str(REPO / "tandem_tpu_torch" / "configs"
                                     / "abl04_fewer_depth_planes.yaml"))
    ds = MVSDataset(str(TRAIN_ROOT), "val", height=DP_SIZE[0],
                    width=DP_SIZE[1])
    items = collate([ds[i] for i in DP_TUPLES])
    batch = {k: items[k] for k in pt.BATCH_KEYS}
    torch.cuda.synchronize()
    reset_counts()
    one = train_steps(config, batch, DP_STEPS, dev, world_size=2)
    paths["parallel_dp_one_process"] = read_counts()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="parallel_"))
    try:
        ranks = run_ranks(train_rank, 2, work / "dp",
                          (config, batch, DP_STEPS, str(dev),
                           "gloo"), timeout=600)
        for r, res in enumerate(ranks):
            paths[f"parallel_dp_rank{r}"] = _all_counts(res["launches"])
            _require_step_launches(f"parallel rank {r}",
                                   _all_counts(res["launches"]), DP_STEPS,
                                   18)
        gap = np.abs(np.array(ranks[0]["losses"]) / one["losses"] - 1)
        log(f"[parallel] {card_label_once()} data-parallel abl04 640x480 "
            f"f32, 2 gloo ranks on cuda:0 (B=2 each) vs one process at "
            f"world_size 2 (B=4), {DP_STEPS} steps: losses "
            f"{[round(x, 6) for x in ranks[0]['losses']]} (rank 1 "
            f"{[round(x, 6) for x in ranks[1]['losses']]}) vs "
            f"{[round(x, 6) for x in one['losses']]}, worst relative gap "
            f"{float(gap.max()):.2e} (bar {DP_RTOL}); each rank's steps "
            f"launched warp_sample and warp_sample_grad 18 times a step; ms "
            f"a step (host clock, synchronized) one process B=4 "
            f"{[round(x, 1) for x in one['ms']]}, rank 0 "
            f"{[round(x, 1) for x in ranks[0]['ms']]}, rank 1 "
            f"{[round(x, 1) for x in ranks[1]['ms']]} (two ranks sharing "
            "one card over gloo: not a speed)")
        if not gap.max() <= DP_RTOL:
            raise AssertionError(f"data-parallel losses {ranks[0]['losses']}"
                                 f" vs one process {one['losses']}")

        argv = [str(work / "mesh"), "--config",
                str(REPO / "tandem_tpu_torch" / "configs"
                    / "abl04_fewer_depth_planes.yaml"),
                "DATA.ROOT_DIR", str(TRAIN_ROOT), "TRAIN.EPOCHS", "1",
                "TRAIN.MAX_STEPS", "2", "IO.LOG_INTERVAL", "1",
                "TRAIN.DEVICE", "mesh"]
        t0 = time.perf_counter()
        res = tandem_train.main(tandem_train.parser.parse_intermixed_args(
            argv))
        secs = time.perf_counter() - t0
        ckpts = sorted(os.listdir(work / "mesh" / "ckpt"))
        log(f"[parallel] tandem_train TRAIN.DEVICE mesh (one rank a card: "
            f"{torch.cuda.device_count()}, NCCL) abl04 640x480 B=2: "
            f"{res['steps']} steps, losses "
            f"{[round(x, 4) for x in res['losses']]}, checkpoints {ckpts}, "
            f"{secs:.1f} s with the rank's start")
        if res["steps"] != 2 or ckpts != ["step_00000002"] \
                or not np.isfinite(res["losses"]).all():
            raise AssertionError(f"tandem_train mesh: {res}, {ckpts}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def phase_eval(dev) -> dict:
    """The port's tandem_eval CLI on replica_mini with the trained
    512x320 unit at 512x320, tuple 0, at both architectures: stage abs_rel
    within EVAL_TOL of the reference's (tests/test_eval_fixture.py), the
    report and the errors written, the forward sample launched."""
    import shutil
    import tempfile

    import torch

    from tandem_tpu_torch.cli import tandem_eval
    work = Path(tempfile.mkdtemp(prefix="eval_"))
    paths = {}
    try:
        for depth_num, ref in REF_ABS_REL.items():
            ckpt = work / f"trained_{depth_num.replace(',', '_')}.pkl"
            shutil.copy(EVAL_UNIT / "model_variables.pkl", ckpt)
            torch.cuda.synchronize()
            reset_counts()
            errors = tandem_eval.main(tandem_eval.parser.parse_args([
                "--ckpt", str(ckpt), "--data-root", str(EVAL_ROOT),
                "--width", "512", "--height", "320", "--limit", "1",
                "--depth-num", depth_num]))
            torch.cuda.synchronize()
            counts = read_counts()
            require_launched(f"eval {depth_num}", counts,
                             ("bilinear_sample",))
            paths[f"eval_{depth_num}"] = counts
            got = {s: errors[s]["abs_rel"] for s in ref}
            log(f"[eval] tandem_eval replica_mini 512x320 planes "
                f"{depth_num}: abs_rel {got} (reference {ref}, tolerance "
                f"{EVAL_TOL}); report {Path(str(ckpt) + '.txt').exists()}")
            if not all(abs(got[s] - ref[s]) < EVAL_TOL for s in ref):
                raise AssertionError(f"eval {depth_num}: abs_rel {got} vs "
                                     f"{ref}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return paths


def card_label_once() -> str:
    from tandem_tpu_torch.utils.cuda_timing import card_label
    if not hasattr(card_label_once, "label"):
        card_label_once.label = card_label()
    return card_label_once.label


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="also profile one keyframe per dtype and one "
                         "track_frame; write the traces here")
    profile_dir = ap.parse_args().profile_dir
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not ((REPO / "tandem_tpu_torch" / "csrc").is_dir()
            and (UNIT / "model_variables.pkl").exists()):
        print("chip_smoke: run from a checkout of the repository "
              "(tandem_tpu_torch/ and exported/tandem/ beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    laps = {}
    t_lap = [t_start]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    kind = phase_device()
    phase_build()
    lap("device+build")
    measured = phase_kernels(dev)
    lap("kernels")
    phase_track_kernels(dev, measured)
    lap("track kernels")
    phase_track_lm(dev, measured)
    lap("track lm")
    paths = {"probes": phase_probes()}
    lap("probes")
    paths["casmvsnet_1152x864"] = phase_casmvsnet(dev)
    lap("casmvsnet")
    for dtype, tol in ((torch.float32, GOLDEN_TOL),
                       (torch.bfloat16, BF16_TOL)):
        runner, pack = load_runner(dev, dtype)
        phase_golden(runner, pack, dev, tol)
        dn = str(dtype).split(".")[-1]
        paths[f"{dn}_slice"], backend = phase_slice(runner, pack, dev,
                                                    profile_dir)
        lap(f"{dn} golden+slice")
        if dtype == torch.float32:
            paths["track_640x480"] = phase_track_640(dev, backend, pack,
                                                     profile_dir)
            lap("track 640x480")
            phase_culled(dev, backend, pack)
            lap("culled")
            paths["sensor_640x480"] = phase_sensor_640(dev, backend, pack)
            lap("sensor 640x480")
        del runner, backend
        torch.cuda.empty_cache()
    phase_wall(dev)
    lap("wall")
    paths["track_gt"] = phase_track_gt(dev)
    lap("track gt")
    paths["track_mvs"] = phase_track_mvs(dev)
    lap("track mvs")
    slam_paths, pkl_ate = phase_slam(dev)
    paths.update(slam_paths)
    lap("slam")
    paths.update(phase_export(dev, pkl_ate))
    lap("export")
    paths["runtime_640x480"] = phase_runtime_640(dev)
    lap("runtime 640x480")
    phase_decode()
    lap("decode")
    paths.update(phase_demo(dev))
    lap("demo")
    paths.update(phase_rgbd(dev))
    lap("rgbd")
    paths["dr_debug"] = phase_dr_debug(dev)
    lap("dr_debug")
    paths.update(phase_train(dev))
    lap("train")
    paths.update(phase_parallel(dev))
    lap("parallel")
    paths.update(phase_eval(dev))
    lap("eval")
    log(f"[time] seconds a phase (host clock): {laps}")
    log(f"[paths] launches by path: {paths} "
        f"({time.perf_counter() - t_start:.1f} s in all)")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c[name] for c in paths.values()),
                        **measured[name]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
