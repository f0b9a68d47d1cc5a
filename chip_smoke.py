#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (acezero_tpu_torch).

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --phases build,kernels   # a subset, in the order below

Needs one NVIDIA card (Hopper, for the sm_90a kernels) and nvcc; exits
non-zero without a result when CUDA is absent or the port is not beside
this script. Every phase prints a flushed JSON line when it starts and when
it ends, with its wall seconds; the first failure raises and ends the run.
Phases 6, 7 and 9-16 run as PARALLEL_GROUPS, each group in a child process
of this script, the groups at once on the card (phase `parallel`, with the
groups' wall seconds; a child's lines are relayed as they come); the other
phases run in this process, alone.

Phases:
  0 device    the card, its power limit, the torch/CUDA versions
  1 build     nvcc builds every kernel of the paths from csrc/, in parallel,
              and c++ the host libraries, the JPEG codec (io/csrc/jpeg.cpp),
              the canvas pass (data/csrc/canvas.cpp), the TIFF and BMP
              codecs (io/csrc/tiff.cpp), the WebP codec (io/csrc/webp.cpp),
              the GIF codec (io/csrc/gif.cpp), the JPEG 2000 codec
              (io/csrc/jpeg2000.cpp) and the TGA, SGI, PCX, Sun raster and
              QOI codecs (io/csrc/raster.cpp), with the compiler's version
              and seconds
  2 kernels   each kernel against its plain PyTorch version on the card, at
              the main paths' shapes and the tile edges, with times (CUDA
              events, median) and resources: K1 (head chain forward) and K2
              (its backward), and the autograd Function's weight gradients
              against autograd of the plain chain
  3 registrar ground-truth scene coordinates of the 60 chesslike_a frames
              (shipped depth + pose) -> the port's estimate_poses_batch
              recovers the shipped poses
  4 slice     the register CLI end to end on the 60 frames at 480x640 with
              the shipped encoder and head; kernel launch counts are zeroed
              just before and read just after
  5 formats   TIFF, BMP and Netpbm/PFM (io/tiff.py, io/bmp.py, io/pnm.py
              and the host codecs of io/csrc/tiff.cpp): the committed
              fixtures (every kind the port reads) decode to PIL's arrays and
              modes (tests/data/formats/pil_digests.json), read_rgb to PIL's
              convert("RGB"), decode_to_canvas over all of them to the JAX
              package's canvases (default and cropped), load_depth_file of
              the depth fixtures to the JAX package's; then the 60 frames as
              TIFF (FORMAT_TIFF_KINDS in turn) and their depth as 16-bit
              PNG, TIFF and PGM: the canvases and depth maps equal the PNG
              glob's, the register CLI (K1) gives the PNG glob's poses
              (phase slice's run, where it ran) and a FORMAT_TRAIN run of the train CLI (K1, K2) the same map bits,
              counts zeroed just before each run and read just after; then
              FORMAT_PHOTO_FRAMES frames of JPEG_PHOTO_HW as raw and as
              Deflate + predictor 2 TIFFs: read_tiff's ms, decode_to_canvas
              with each of JPEG_WORKERS, the four runs in turn in one fresh
              process (ms per image, peak RSS growth; the same canvases for
              both kinds); then WebP (io/webp.py, io/csrc/webp.cpp): the
              committed fixtures of every kind (tests/data/webp) against
              PIL's digests, the 60 frames as lossless WebP that the port's
              encoder writes, whose canvases must be the PNG glob's and
              whose register CLI run (K1, counts zeroed just before and
              read just after) must give the PNG glob's poses; read_webp's
              ms and MP/s on the committed lossy photo and on a lossless
              frame of JPEG_PHOTO_HW, and decode_to_canvas of
              FORMAT_PHOTO_FRAMES such frames in the same fresh process as
              the TIFF runs (the canvases equal the TIFF frames'); then GIF
              (io/gif.py, io/csrc/gif.cpp): the committed fixtures
              (tests/data/gif) against PIL's digests (indices, mode, size,
              palette, transparency, convert("RGB"); the refused ones
              must raise), decode_to_canvas over them against the JAX
              package's canvases (default and cropped) and load_depth_file
              of the depth ones against the JAX package's; the 60 frames as
              interlaced P GIFs of a permuted grey palette (write_gif),
              whose canvases must be the PNG glob's and whose register CLI
              run (K1 as many as the TIFF glob's, K2 none; counts zeroed
              just before and read just after) must give the PNG glob's
              poses; read_gif's ms and MP/s on a frame of JPEG_PHOTO_HW and
              decode_to_canvas of FORMAT_PHOTO_FRAMES such frames in the
              same fresh process as the TIFF and WebP runs; then JPEG 2000
              (io/jpeg2000.py, io/csrc/jpeg2000.cpp): the committed fixtures
              (tests/data/jpeg2000: every mode, both wavelets, precincts,
              tiles, layers, the five progressions, JP2 boxes; the refused
              ones must raise) against PIL's digests, decode_to_canvas over
              them and load_depth_file of the depth ones against the JAX
              package's; the 60 frames as lossless JPEG 2000
              (write_jpeg2000, JP2 and bare codestreams), whose canvases
              must be the PNG glob's and whose register CLI run (K1 as many
              as the TIFF glob's, K2 none; counts zeroed just before and
              read just after) must give the PNG glob's poses; read_jpeg2000's
              ms and MP/s on the committed lossy photo of JPEG_PHOTO_HW
              (JPEG2000_PHOTO) against PIL's digest; then TGA, SGI, PCX,
              DCX, Sun raster and QOI (io/tga.py, io/sgi.py, io/pcx.py,
              io/dcx.py, io/sun.py, io/qoi.py, io/csrc/raster.cpp): the
              committed fixtures (tests/data/raster; the refused ones must
              raise, with PIL's mode and size where PIL opens them) against
              PIL's digests, decode_to_canvas over them and load_depth_file
              of the depth ones against the JAX package's; the 60 frames as
              gray RASTER_GLOB_KINDS in turn (the port's writers), whose
              canvases must be the PNG glob's and whose register CLI run (K1
              as many as the TIFF glob's, K2 none; counts zeroed just
              before and read just after) must give the PNG glob's poses;
              read_tga (run-length), read_sgi, read_pcx and read_qoi's ms
              and MP/s on a frame of JPEG_PHOTO_HW each, written by the
              port's writers from the tinted enlargement
  6 mapping   the train CLI end to end on the 60 frames and their shipped
              poses at full width (batch 5,120, 614,400 buffer rows): the
              pipeline's mapping recipe, then the same schedule with the
              poses held fixed, counts zeroed just before each run and read
              just after; then the register CLI relocalizes the 60 frames
              against the fixed-pose map
  7 loopclose loop closure (loop_close_entries) at full width on the 60
              frames at their shipped poses against the fixed-pose map of
              phase mapping (a shorter one is trained when mapping did not
              run): coordinate maps and features (K1), the pairwise Sim(3)
              fits, the pose graph, sub-pixel refinement and the track BA,
              each timed; counts zeroed just before and read just after;
              the call repeated must give the same bits (the BA's sums do
              not depend on thread order); then loop_close_core on the
              card and on the CPU, on exact
              drifted maps of 16 frames (every fit and correction must
              agree) and on the card's maps and features of a 16-frame
              subgraph (the same edges; LOOPCLOSE_TOL_*)
  8 profile   where a mapping step's time goes, for each mapping run's
              configuration: host ms per step over 30 unprofiled steps, then
              device ms, kernels and the top device ops per step over 30
              steps under torch.profiler
  9 pipeline  the reconstruction CLI (acezero_tpu_torch.cli.ace_zero_cli,
              loop closure on) end to end on the 60 frames with their depth
              files at full width and cut budgets (PIPELINE_CUTS): seed
              stage, mapping and registration rounds, loop closure, final
              refit and adaptive refit cycles; counts zeroed just before and
              read just after; every loop-closure call's diagnostics;
              poses_final.txt scored against the shipped poses after a
              Sim(3) alignment
 10 seeddepth the learned seed-depth estimator (v4 head, v6 encoder) on
              the 10 chesslike_a frames scripts/depth_probe.py picks:
              raw_rel, shape_rel, scale_cv within SEEDDEPTH_TOL of the JAX
              package's (SEEDDEPTH_JAX), ms per frame, and one frame on the
              card against the port's CPU path (max |d log-depth|)
 11 bare      the reconstruction CLI as a user runs it on a bare image glob:
              JPEG copies of the 60 frames (write_jpeg at BARE_JPEG, tinted
              by JPEG_TINT to three components) with a calibration file
              beside each; no depth files (the learned seed-depth head),
              loop closure on, --export_point_cloud and
              --render_visualization, at full width and phase pipeline's cut
              budgets; counts zeroed just before and read just after; the
              rate at confidence 500 must reach BARE_SHARE, pc_final.ply
              must hold points coloured from the JPEGs, the video's frames
              (12 relocalization frames a registration, the mapping frames,
              the 150-frame sweep) must decode to 720 x 1280 x 3 and show
              the scene; each frame's pan camera, device render, overlays
              and PNG write are timed; scene_load decodes the JPEGs cold
 12 render    the outputs of phase bare's folder (which it brings along):
              the renderer on the card against the CPU on the last
              visualizer state (RENDER_PIXEL_SHARE, and the same bits twice),
              the final-sweep CLI, export_cli point_cloud from the
              visualizer buffer (the pickle's cloud bit for bit) and from
              the network (K1), export_cli cameras, the Nerfstudio
              transforms.json of the JPEG frames, the runner's missing-CLI
              error and its JPEG downscale, the runner's downscale of one
              source of each kind PIL opens (RUNNER_SOURCES) against PIL's
              results (tests/data/runner/pil_digests.json), and
              Regressor.forward against the export's predict_coords bit for
              bit; counts zeroed just before each main-path call and read
              just after
 13 jpeg      the host JPEG codec: the committed fixtures (every kind the
              decoder reads: baseline, progressive, any sampling factors,
              CMYK and YCCK, arithmetic coding, lossless) decode to PIL's
              arrays (sha256, tests/data/jpeg/pil_digests.json), read_rgb
              gives PIL's convert("RGB") of the four-component ones,
              decode_to_canvas over all of them gives the JAX package's
              canvases at the default canvas and at one smaller than the
              content (the crop), write_jpeg writes PIL's bytes for the
              JPEG_ROUNDTRIP frames, then
              JPEG_PHOTO_FRAMES frames of JPEG_PHOTO_HW: read_jpeg's ms and
              MP/s, threads against one thread, the canvas pass on each
              frame alone against its plain numpy version (equal sha256,
              ms of each), decode_to_canvas at a 480 short side with each
              of JPEG_WORKERS (each in a fresh process: ms per image, MP/s,
              the peak RSS growth; the canvases must be the plain
              version's), and the
              warm read of the decode cache on phase bare's JPEG glob (a
              hit)
 14 spill     MappingTrainer on the shipped poses at full width, the device
              buffer against the host-spill buffer (--training_buffer_cpu)
              from one seed: equal fills and bit-equal parameters after
              SPILL_STEPS[0] steps, then SPILL_STEPS[1] steps of each timed
 15 mesh      the data mesh (parallel/mesh.py) on a logical mesh of
              MESH_SHARDS shards on cuda:0, and on every card when there are
              several: MappingTrainer's fill sharded (the same rows as one
              device's), gather_rows at full width bit-equal to indexing,
              MESH_STEPS[0] steps of the pipeline's mapping recipe against
              one device from one generator state, MESH_STEPS[1] steps of
              each timed, the 60 frames registered on the mesh against one
              device, K1 and K2 launches counted per device (every mesh
              device launches both), counts zeroed just before each run and
              read just after; the devices' overlap under torch.profiler
 16 pretrain  the pretraining slice: the encoder pretraining CLI at its
              default widths with the v6 recipe's contrastive weight (steps
              cut, PRETRAIN_ARGS; K1 and K2 once an image a step, counts
              zeroed just before and read just after), steps past its
              warm-up on the card against the CPU (terms within
              PRETRAIN_CPU_RTOL, updates within PRETRAIN_UPDATE_TOL),
              match_score of the shipped encoder against the JAX package's
              (MATCH_JAX_V6) and of the new one (MATCH_TRAINED), the short
              map fit of the shipped encoder (SHORTFIT_ITERATIONS, at least
              SHORTFIT_MIN_INLIER10), then the seed-depth pretraining CLI on
              the v4 corpus (cut, DEPTH_PRETRAIN) and its first steps on the
              card against the CPU
 17 report    one JSON line describing every kernel, then the card's
              nvidia-smi line, then the final status line

Phase `device` always runs (it turns TF32 off for the comparisons), in each
child too, and phase `render` brings phase `bare`, whose output it reads. With a
subset the report carries null for what the skipped phases measure, and the
status line is printed all the same.
"""

from __future__ import annotations

import argparse
import atexit
import concurrent.futures
import contextlib
import glob
import hashlib
import json
import logging
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCENE = ROOT / "results" / "heldout" / "scenes" / "chesslike_a"
ENCODER = ROOT / "weights" / "tpu_encoder_v6.pt"
HEAD = ROOT / "results" / "heldout" / "sweep_a_warmstart" / "iteration2.pt"
FOCAL = 520.0

PHASES = ("device", "build", "kernels", "registrar", "slice", "formats", "mapping", "loopclose", "profile",
          "pipeline", "seeddepth", "bare", "render", "jpeg", "spill", "mesh", "pretrain", "report")
# The phases after `formats` but `profile` run as these groups, each group in
# a child process of this script (--phases GROUP --handoff FILE), all the
# groups at once on the one card. Each phase is bound by its host (the card
# is busy an eighth of a mapping step: phase profile), so the groups share
# the card and the host's cores and the run takes about its longest group
# instead of the sum. A group keeps together the phases that read another's
# output: mapping's fixed-pose map (loopclose, mesh) and bare's folder and
# JPEG glob (render, jpeg). The phases before them and `profile` after them
# run alone, so the kernels' times, the decoders' times and the mapping
# step's host and device times share the card and the host with no other
# process; the groups' own seconds and rates are taken beside one another.
PARALLEL_GROUPS = (("mapping", "loopclose", "mesh"), ("pipeline", "seeddepth", "spill"),
                   ("bare", "render", "jpeg"), ("pretrain",))

# H100 SXM published peaks (dense bf16 tensor cores; HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

K1_TOL = 1e-2  # relative Frobenius error of the bf16 chain output
ONE_BLOCK_TAGS = (0, 0, 1, 0, 0, 1, 0, 0)
# the pretraining's head launch: one 192 x 256 image (24 x 32 cells), head_blocks 0
PRETRAIN_ROWS, PRETRAIN_TAGS = 24 * 32, (0, 0, 1, 0, 0)
H100_SMS = 132
# (case, rows B, residual tags): the registration shape (60x80 cells x 64
# frames, num_head_blocks=1), a ragged B, num_head_blocks 0 and 2, the
# mapping shape; the tile edges (one row, one full tile, one row past it);
# one layer with and without the residual add; a full card (one 64-row tile
# per SM of an H100); and a persistent grid whose tile count is no multiple
# of the SMs (2 x 132 + 1 full tiles and a ragged one)
K1_CASES = [("registration", 307_200, ONE_BLOCK_TAGS), ("ragged", 3 * 4800 + 37, ONE_BLOCK_TAGS),
            ("blocks0", 4800 * 4, (0, 0, 1, 0, 0)),
            ("blocks2", 4800 * 4, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
            ("mapping", 5120, ONE_BLOCK_TAGS),
            ("B1", 1, ONE_BLOCK_TAGS), ("B64", 64, ONE_BLOCK_TAGS), ("B65", 65, ONE_BLOCK_TAGS),
            ("L1", 5120, (0,)), ("L1res", 5120 + 37, (1,)), ("fill132", H100_SMS * 64, ONE_BLOCK_TAGS),
            ("persistent", (2 * H100_SMS + 1) * 64 + 37, ONE_BLOCK_TAGS),
            ("pretrain", PRETRAIN_ROWS, PRETRAIN_TAGS)]
# the main paths' shapes, and one tile and a full card to tell the fill from
# the per-tile pipeline
K1_TIMED = ("registration", "mapping", "B64", "fill132", "pretrain")
# K2 (the chain's backward): dx, gpre and acts_in against the plain version,
# relative Frobenius. Both round to bf16 at the same points, but a tensor-core
# sum and an IEEE f32 sum flip single bf16 roundings and, rarely, ReLU masks,
# and the walk back compounds them over the layers. On these inputs, on an
# H100, the plain version itself is 0.3-0.8% from the exact chain (f64 sums,
# the same rounding points), and K2, bit-identical to the cuBLAS chain, is
# 0.5-1.2% from it and 0.6-1.2% from the plain version, the most at L = 11.
# A wrong kernel (transpose, mask, residual, ragged edge) is off by O(1).
K2_TOL = 2e-2
K2_GRAD_TOL = 2e-2  # dW, db of the autograd Function against autograd of the plain chain
# the mapping shape (batch 5,120, num_head_blocks=1), a ragged B, and
# num_head_blocks 0 and 2
# num_head_blocks 0 and 2; the tile edges (one row, one full tile, one row
# past it); one layer with and without the residual join (the walk back
# starts on a residual layer only there); and a full card (one 64-row tile
# per SM of an H100), timed with B = 64 to tell the fill from the per-tile
# pipeline
K2_CASES = [("mapping", 5120, ONE_BLOCK_TAGS), ("ragged", 5120 + 37, ONE_BLOCK_TAGS),
            ("blocks0", 5120, (0, 0, 1, 0, 0)), ("blocks2", 5120, (0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0)),
            ("B1", 1, ONE_BLOCK_TAGS), ("B64", 64, ONE_BLOCK_TAGS), ("B65", 65, ONE_BLOCK_TAGS),
            ("L1", 5120, (0,)), ("L1res", 5120 + 37, (1,)), ("fill132", H100_SMS * 64, ONE_BLOCK_TAGS),
            ("pretrain", PRETRAIN_ROWS, PRETRAIN_TAGS)]
# kernel_ms of each; plain and library at the mapping and pretraining shapes
K2_TIMED = ("mapping", "B64", "fill132", "pretrain")
# phase mapping, two runs of the train CLI: the pipeline's mapping recipe
# (AceZeroPipeline._base_train_cfg: 1cyclepoly at 0.003, tanh, MLP pose and
# focal refinement), then the same schedule on the frames' fixed poses for the
# map that must relocalize them (pose refinement moves and rescales the map's
# frame as a whole, so a refined map is not in the shipped poses' frame).
# Iteration budgets, warm-up and cooldown are cut to fit the phase.
MAPPING_SCHEDULE = ["--learning_rate_schedule", "1cyclepoly", "--learning_rate_max", "0.003",
                    "--repro_loss_type", "tanh"]
MAPPING_RUNS = {
    "recipe": MAPPING_SCHEDULE + ["--pose_refinement", "mlp", "--refine_calibration", "true",
                                  "--iterations", "2000", "--learning_rate_warmup_iterations", "300",
                                  "--learning_rate_cooldown_iterations", "500", "--iterations_output", "300"],
    "fixed_poses": MAPPING_SCHEDULE + ["--iterations", "9000", "--learning_rate_warmup_iterations", "500",
                                       "--learning_rate_cooldown_iterations", "1500", "--iterations_output", "1000"],
}
RELOC_SHARE = 0.5  # frames the fixed-pose map must relocalize within 5 cm / 5 deg
# phase loopclose: the map when phase mapping did not run (its fixed-pose
# run, cut to 3,000 iterations); the card against the CPU, float32 on both
# (cuSOLVER's eigensolves and cuBLAS's sums, TF32 off, round otherwise than
# the CPU's), through loop_close_core on this many frames:
# - exact maps (drifted_chesslike at 60 x 80 cells): the same selected pairs
#   and edges, and every pairwise Sim(3) fit and every frame's correction
#   within LOOPCLOSE_TOL_DIAG of the scene diagonal and LOOPCLOSE_TOL_DEG,
#   scales within LOOPCLOSE_TOL_SCALE;
# - the card's learned maps and features of an evenly strided subgraph: the
#   same edge count. Their fits and corrections are printed beside the CPU's
#   own spread under 1e-6 relative noise on the maps, not held: on a learned
#   map near-tied cosine matches flip between the devices, and the pose graph
#   is ill-conditioned (that noise alone moves the median frame by 4 mm /
#   0.031 deg and a tenth of the frames by 0.8 m / 16 deg on a scene of
#   11.3 m, in the JAX package as in the port; scripts/loopclose_parity.py).
LOOPCLOSE_MAP = MAPPING_SCHEDULE + ["--iterations", "3000", "--learning_rate_warmup_iterations", "300",
                                    "--learning_rate_cooldown_iterations", "500", "--iterations_output", "1000"]
LOOPCLOSE_CPU_FRAMES = 16
LOOPCLOSE_TOL_DIAG = 1e-3
LOOPCLOSE_TOL_DEG = 0.05
LOOPCLOSE_TOL_SCALE = 1e-3
# phase profile: warm-up and profiled steps at the mapping runs' full-size
# configuration (TrainConfig / BufferConfig overrides, canvas short side)
PROFILE_STEPS = (20, 30)
PROFILE_TRAIN, PROFILE_BUFFER, PROFILE_SHORT_SIDE = {}, {}, 480
# phase pipeline: the reconstruction CLI at full width (480-pixel short side,
# batch 5,120, the 512-wide head with one extra block, the default buffer)
# with the budgets cut to fit the phase; the warm-up has no CLI flag and is
# set on the config that config_from_args built
PIPELINE_CUTS = {"try_seeds": 3, "seed_iterations": 1000, "iterations": 2000, "cooldown_iterations": 500,
                 "refit_iterations": 2000, "final_refit_posewait": 500, "iterations_max": 4}
PIPELINE_OVERRIDES = {"learning_rate_warmup_iterations": 200}
# The floor of frames registered at confidence 500 by the loop. At these
# budgets neither package reaches RELOC_SHARE: the JAX package registers
# 30.0% on this configuration (scripts/pipeline_parity.py, on the CPU) and
# the port 30.0-33.3% over three base seeds on the card, where the same loop
# at the full default budgets reaches 76.7% in five rounds. The floor sits
# three frames under the reference; a loop whose rounds do not train stays
# at the seed map's 3-12%.
PIPELINE_SHARE = 0.25
# phase seeddepth: the learned estimator on every SEEDDEPTH_STRIDE-th frame
# (scripts/depth_probe.py's choice), its statistics within SEEDDEPTH_TOL of
# the JAX package's on the CPU (scripts/depth_probe.py --scenes chesslike_a,
# JAX_PLATFORMS=cpu); the TPU record (results/heldout/DEPTH_PROBE.jsonl,
# line 1) is printed beside them for reference only
DEPTH_HEAD = ROOT / "weights" / "tpu_depth_v4.pt"
SEEDDEPTH_STRIDE = 6
SEEDDEPTH_JAX = {"raw_rel": 0.10833161348231829, "shape_rel": 0.0638548779545724, "scale_cv": 0.11647150721114985}
SEEDDEPTH_TPU_RECORD = {"raw_rel": 0.1074432695248704, "shape_rel": 0.0631153339142815,
                        "scale_cv": 0.11822965491705718}
SEEDDEPTH_TOL = 0.01
# the card against the port's CPU path on one frame: max |log d_card - log
# d_cpu| over the pixels. Both round the convolutions' bf16 outputs, but
# cuDNN and the CPU sum in other orders, so single roundings flip and the
# four depth convolutions carry them to the log-depth, a bf16 output itself
# (the port's CPU path against the JAX package's: 0.018, and the same
# tolerance, in tests/test_torch_depth.py)
SEEDDEPTH_CPU_TOL = 0.03
# phase bare: the floor of frames registered at confidence 500. The JAX
# package registers 19 of the 60 frames with learned seed depth and loop
# closure at these budgets (scripts/pipeline_parity.py --packages jax --size
# full --learned_depth --loop_closure, seed 2089, on the CPU: 6.7, 18.3,
# 21.7, 31.7, 31.7, 30.0, 31.7% over six rounds); the floor sits three
# frames under it
BARE_JAX_RATE = 19 / 60
BARE_SHARE = 16 / 60
# the video of phase bare: 12 relocalization frames a registration round
# (of at least 12 frames), the final orbit, frames at the visualizer's size
RELOC_FRAMES = 12
SWEEP_FRAMES = 150
FRAME_SHAPE = (720, 1280, 3)
# phase render: the card's frame against the CPU's, the share of pixels that
# may differ (a projection rounded differently moves a point at a pixel
# edge by one pixel; tests/test_torch_viz.py holds the CPU to the JAX
# package at the same share), and the frames Regressor.forward runs
RENDER_PIXEL_SHARE = 1e-3
REGRESSOR_FRAMES = 8
EXPORT_CONF = 500  # export_cli --network takes the frames registered at the pipeline's confidence bar
# phase spill: steps held bit for bit, then steps timed with each buffer
SPILL_STEPS = (200, 500)
# phase mesh: the data mesh (parallel/mesh.py) as a logical mesh of
# MESH_SHARDS shards on cuda:0, and over every card when there are several.
# MappingTrainer with the recipe of phase profile from one generator state,
# mesh against one device: MESH_STEPS[0] steps held to the bounds of
# tests/test_torch_mesh.py. `_apply_step` is hooked, so the first step's
# reduced loss, inlier count and gradients are held: the loss within
# MESH_LOSS0_RTOL, the inlier count exactly, each gradient leaf within
# MESH_GRAD_RTOL relative Frobenius (fc3's weight within MESH_GRAD_FC3_RTOL:
# a bf16 product rounded per part); only the order of the sums differs.
# Over the steps every loss within MESH_LOSS_RTOL, and the update of the
# parameters (after - start, not the parameters, which the update moves by
# only a few per cent) within MESH_UPDATE_RTOL relative Frobenius: the bf16
# chain and AdamW's early, nearly sign-like steps let any other summation
# order drift that far (one H100, the logical mesh: 0.124; fc3's weight
# gradient 3.2e-3, every other leaf within 5.3e-6). Two controls from the
# same start and draws must fail these checks: no update (the update's
# error is then 1), and the gradients of the first part alone (the losses
# and counts still reduced in full: 0.98 on the card, its gradients 0.85
# apart). Then MESH_STEPS[1] steps of each timed. The
# gather at full width bit-equal to plain indexing at batch MESH_GATHER_B.
# The 60 frames registered on the mesh against one device: the same frames
# valid, and for the frames registered at confidence MESH_REG_CONF or more
# on either, inliers within max(1, 1%), at least MESH_REG_SHARE of them
# within MESH_REG_M and MESH_REG_DEG (tests/test_torch_registration.py:
# 127-130) and every one within MESH_REG_M_MAX and MESH_REG_DEG_MAX. A
# device registers a batch of 60 / N frames, and cuDNN and the registrar's
# batched solves round otherwise at another batch size: the mesh registers
# every frame bit-equal to one device registering chunks of a lane's length
# with the same draws (checked in the phase), and one device in chunks of
# 30 moves one of the 45 confident frames by 9.9 mm / 0.104 deg from its
# chunk of 60, as the 2-shard mesh does (PERF.md section 6). The generator's
# draws are those of one device whenever the chunk is. Below the bar a
# frame's few inliers come from near-tied hypotheses: such frames are
# counted, not held.
MESH_SHARDS = 2
MESH_STEPS = (10, 500)
MESH_PROFILE_STEPS = 20  # steps under torch.profiler for the devices' overlap
MESH_GATHER_B = 5120
MESH_LOSS0_RTOL = 1e-6
MESH_GRAD_RTOL = 1e-5
MESH_GRAD_FC3_RTOL = 1e-2
MESH_LOSS_RTOL = 2e-2
MESH_UPDATE_RTOL = 0.25
MESH_REG_M = 1e-3
MESH_REG_DEG = 0.05
MESH_REG_SHARE = 0.9
MESH_REG_M_MAX = 0.02
MESH_REG_DEG_MAX = 0.25
MESH_REG_CONF = 1000.0
# phase pretrain: the encoder pretraining CLI at its default widths (8 scenes
# x 24 views at 192 x 256, batch 8, head_blocks 0, exact supervision) with the
# v6 recipe's contrastive weight and steps cut from 4,000 to 1,200 (the
# coordinate loss sits on a plateau for the first 800 steps at any schedule
# length, 13.2 -> 13.0 over 600 steps, and falls 20% by step 1,200: PERF.md
# section 6, the pretraining findings); the depth
# pretraining CLI on the v4 corpus at 240 x 320 and batch 32, scenes cut from
# 64 to 8 and steps from 8,000 to 500; the short map fit of the shipped
# encoder cut from 6,000 iterations to 1,000 (its warm-up 500 and cooldown
# 1,000 as in the JAX package: cut in proportion, the fit scores lower)
PRETRAIN_STEPS = 1200
PRETRAIN_ARGS = ["--contrastive_weight", "0.2", "--steps", str(PRETRAIN_STEPS)]
DEPTH_PRETRAIN = {"corpus": "v4", "num_scenes": 8, "steps": 500}
SHORTFIT_ITERATIONS = 1000
# v6's short fit at that cut must place at least this share of cells within
# 10 px: the card gives 14.74% (the same bits in four calls), an untrained
# encoder 0.05% and v6's uncut probe 43.1% (scripts/shortfit_probe.py, PERF.md
# section 6, PR 13), so a fit or a score that is broken lands far below
SHORTFIT_MIN_INLIER10 = 7.0
# the freshly trained encoder's match_score is only printed; at a quarter of
# the default pixels (24 views at 240 x 320) it costs a quarter of the time
MATCH_TRAINED = {"h": 240, "w": 320}
# the JAX package's match_score of tpu_encoder_v6.pt at its defaults (2 scenes
# x 24 views at 480 x 640) on the CPU, from
#   JAX_PLATFORMS=cpu python -c "import jax, jax.numpy as jnp;
#   from acezero_tpu.models.torch_io import load_encoder;
#   from acezero_tpu.pretrain.encoder_eval import match_score;
#   print(match_score(jax.tree.map(jnp.asarray, load_encoder('weights/tpu_encoder_v6.pt'))))"
# (the port's CPU path gives 80.0548); the card must be within MATCH_TOL_PP
MATCH_JAX_V6 = 80.0383528112198
MATCH_TOL_PP = 1.0
# the first steps of each pretraining on the card and on the CPU from the same
# parameters and draws: every loss term within PRETRAIN_CPU_RTOL relative. Both
# round the convolutions' bf16 outputs, but cuDNN and the CPU sum in other
# orders, so single roundings flip (on the CPU, oneDNN against the JAX
# package's XLA moves the terms by up to 2e-4, tests/test_torch_pretrain.py and
# test_torch_depth_pretrain.py), and the card's head chain rounds as K1 does.
# The encoder's steps start at PRETRAIN_CPU_STEP0, its warm-up's end, so they
# run at the full rate (from step 0 the rate is 0, then 1e-5, and the terms
# would see only the forward pass): each step's parameters come from the
# previous step's gradients. The update of every tree after the steps (after -
# before) is also held against the CPU's, within PRETRAIN_UPDATE_TOL relative
# Frobenius: Adam's first steps move a weight by about lr * sign(g), so weights
# whose gradient is within rounding of zero flip their step (2-7% of the
# update against the JAX package on the CPU, tests/test_torch_pretrain.py); a
# wrong gradient is O(1).
PRETRAIN_CPU_STEPS = 3
PRETRAIN_CPU_STEP0 = 200
PRETRAIN_CPU_RTOL = 5e-3
PRETRAIN_UPDATE_TOL = 0.15
# the JPEG codec (io/csrc/jpeg.cpp): phase bare reads the frames as JPEGs
# written by write_jpeg at BARE_JPEG (quality, subsampling); phase jpeg
# decodes the committed fixtures (tests/data/jpeg, scripts/make_jpeg_fixtures.py)
# and writes the JPEG_ROUNDTRIP frames (jpeg_roundtrip_frame), each decode
# held to PIL's by sha256 (pil_digests.json), as are read_rgb of the
# four-component fixtures and decode_to_canvas over all of them (to the JAX
# package's canvas_digest), then times decode_to_canvas on
# JPEG_PHOTO_FRAMES frames of JPEG_PHOTO_HW (Mip-NeRF 360's full size, the
# chesslike frames enlarged by pil_resize_bilinear) at JPEG_PHOTO_QUALITY,
# with each of JPEG_WORKERS
BARE_JPEG = (90, "4:2:0")
# the chesslike frames are gray; each JPEG copy adds this constant tint to
# the gray value of R, G and B (clipped), so the files are three-component
# 4:2:0 JPEGs and the point cloud's colours show where they came from. Its
# luma is 0.299 * 12 - 0.587 * 4 - 0.114 * 11 = -0.014 of a level
JPEG_TINT = (12, -4, -11)
JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
FORMAT_FIXTURES = ROOT / "tests" / "data" / "formats"
WEBP_FIXTURES = ROOT / "tests" / "data" / "webp"
WEBP_PHOTO = "photo_lossy_q80.webp"  # the committed lossy photo read_webp is timed on
GIF_FIXTURES = ROOT / "tests" / "data" / "gif"
JPEG2000_FIXTURES = ROOT / "tests" / "data" / "jpeg2000"
RASTER_FIXTURES = ROOT / "tests" / "data" / "raster"  # TGA, SGI, PCX, DCX, Sun raster, QOI
# phase formats: the 60 frames as these in turn (frame i as kind i % 4)
RASTER_GLOB_KINDS = ("tga_rle", "tga_raw", "sgi", "pcx")
RASTER_PHOTO_KINDS = ("tga_rle", "sgi", "pcx", "qoi")  # one photo-size frame each, read and timed
JPEG2000_PHOTO = JPEG2000_FIXTURES / "photo.jp2"  # JPEG_PHOTO_HW, lossy (scripts/make_jpeg2000_fixtures.py)
JPEG_ROUNDTRIP = ((75, "4:2:0"), (90, "4:2:0"), (95, "4:4:4"), (75, "4:2:0"))
JPEG_PHOTO_HW = (3286, 4946)
JPEG_PHOTO_FRAMES = 8
JPEG_PHOTO_QUALITY = 95
JPEG_WORKERS = (1, 16)
# phase formats: TIFF, BMP and Netpbm/PFM (io/tiff.py, io/bmp.py,
# io/pnm.py). (a) the fixtures of FORMAT_FIXTURES
# (scripts/make_format_fixtures.py) against PIL's and the JAX package's
# digests; (b) the 60 frames as TIFF, each FORMAT_TIFF_KINDS[i % 6], their
# depth (the .npy maps in millimetres) as 16-bit PNG, TIFF and PGM, and the
# register CLI (K1) and FORMAT_TRAIN (K1, K2) on the TIFF and on the PNG
# globs; (c) FORMAT_PHOTO_FRAMES frames of JPEG_PHOTO_HW as each of
# FORMAT_PHOTO_KINDS, read_tiff alone and decode_to_canvas with each of
# JPEG_WORKERS
FORMAT_TIFF_KINDS = ("raw", "packbits", "deflate_pred2", "mm", "tiled", "planar")
FORMAT_TRAIN = MAPPING_SCHEDULE + ["--iterations", "200", "--learning_rate_warmup_iterations", "50",
                                   "--learning_rate_cooldown_iterations", "50"]
FORMAT_PHOTO_FRAMES = 8
FORMAT_PHOTO_KINDS = ("raw", "deflate_pred2")
GIF_PALETTE_SEED = 7  # the permutation of the grey palette the GIF frames are written with
# the Nerfstudio runner's downscale in phase render: one source of each kind
# of image PIL opens, wider than the runner's 640-pixel bound, name: (kind,
# (h, w)); the kind is PIL's mode, or ";16" for 16-bit colour. The port
# writes them (runner_source, write_runner_sources), but for the palette and
# 1-bit ones and the GIFs: those are PIL's own files, committed (the GIF of
# mode L a grey ramp of every level, which PIL's GIF save keeps as L, and a
# P GIF with a transparency index, as `transparency` below gives it).
# PIL's results (the JAX runner's resize and save) are in
# tests/data/runner/pil_digests.json, made by scripts/make_runner_fixtures.py
RUNNER_FIXTURES = ROOT / "tests" / "data" / "runner"
RUNNER_SOURCES = {
    "gray.png": ("L", (40, 700)),
    "rgb.png": ("RGB", (33, 901)),
    "gray_alpha.png": ("LA", (37, 1000)),
    "rgba.png": ("RGBA", (29, 777)),
    "gray16.png": ("I;16", (41, 1283)),
    "rgb16.png": ("RGB;16", (23, 650)),
    "rgba16.png": ("RGBA;16", (31, 943)),
    "gray_alpha16.png": ("LA;16", (27, 710)),
    "palette.png": ("P", (24, 900)),
    "bilevel.png": ("1", (20, 1000)),
    "gray.jpg": ("L", (35, 800)),
    "rgb.jpg": ("RGB", (43, 1111)),
    "cmyk.jpg": ("CMYK", (30, 960)),
    "palette.gif": ("P", (26, 900)),
    "gray.gif": ("L", (20, 660)),
    "palette_transparency.gif": ("P", (22, 960)),
    "rgb.jp2": ("RGB", (34, 870)),
    "gray16.j2k": ("I;16", (25, 700)),
    "cmyk.jpx": ("CMYK", (21, 650)),
    "rgba_rle.tga": ("RGBA", (26, 700)),
    "gray.sgi": ("L", (30, 760)),
    "rgb.pcx": ("RGB", (22, 690)),
    "rgba.qoi": ("RGBA", (28, 720)),
}
# the TGA source's own coding, row order and ID section, which PIL's save
# of its resize keeps (the runner passes them on)
RUNNER_TGA_INFO = {"compression": "tga_rle", "orientation": 1, "id_section": b"acezero"}
RUNNER_BYTES_SUFFIXES = (".jpg", ".tga", ".sgi", ".pcx", ".qoi")  # outputs held to PIL's bytes
RUNNER_GIF_TRANSPARENCY = {"palette_transparency.gif": 5}  # the GIF sources' transparency index
RUNNER_PALETTE = [(i * 37 % 256, i * 91 % 256, 255 - i * 16) for i in range(16)]  # palette.png's colours
FRAMES = "frame_*.png"
N_FRAMES = 60
DEVICE = "cuda"


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


@contextlib.contextmanager
def phase(name: str, record: dict):
    emit(phase=name, event="start")
    t0 = time.perf_counter()
    try:
        yield record
    except BaseException as exc:
        emit(phase=name, event="failed", seconds=time.perf_counter() - t0,
             error=f"{type(exc).__name__}: {exc}"[:2000], **record)
        raise
    emit(phase=name, event="end", seconds=time.perf_counter() - t0, **record)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unavailable"


def time_ms(fn, torch, warmup: int = 3, reps: int = 10) -> float:
    """Median of `reps` CUDA-event timings of one call each, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(fn, torch, launches: int = 20, reps: int = 5) -> float:
    """Median over `reps` of the CUDA-event time of `launches` back-to-back
    calls, per call: the device's time with the host's launch cost hidden
    (time_ms, one call between two events, counts the host's time to launch
    where the device waits for it)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def k1_inputs(torch, B: int, tags, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    L = len(tags)
    x = torch.from_numpy((rng.normal(size=(B, 512)) * 0.5).astype(np.float32)).to(DEVICE, torch.bfloat16)
    w = torch.from_numpy((rng.uniform(-1, 1, (L, 512, 512)) / 512**0.5).astype(np.float32))
    b = torch.from_numpy((rng.uniform(-1, 1, (L, 512)) / 512**0.5).astype(np.float32))
    return x, w.to(DEVICE, torch.bfloat16), b.to(DEVICE)


def chain(torch, x, tags, pre):
    """The residual chain with `pre(h, l)` as layer l's f32 pre-activation."""
    res = h = x
    for l, is_res in enumerate(tags):
        a = torch.relu(pre(h, l)).to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    return h


def library_chain(torch, x, w, b, tags):
    """The same function as unfused cuBLAS calls: bf16 tensor-core GEMMs
    with f32 output (torch.mm out_dtype), then bias, ReLU and bf16 rounding.
    A yardstick only, never called by the port."""
    return chain(torch, x, tags, lambda h, l: torch.mm(h, w[l], out_dtype=torch.float32) + b[l])


def exact_chain(torch, x, w, b, tags):
    """The chain with f64 sums and the kernel's bf16 rounding points."""
    return chain(torch, x, tags, lambda h, l: (h.double() @ w[l].double() + b[l].double()).float())


def k2_inputs(torch, B: int, tags, seed: int):
    import numpy as np

    x, w, b = k1_inputs(torch, B, tags, seed)
    g = np.random.default_rng(seed + 100).normal(size=(B, 512)) * 1e-2
    return x, w, b, torch.from_numpy(g.astype(np.float32)).to(DEVICE, torch.bfloat16)


def chain_backward(torch, x, w, b, g, tags, pre, back):
    """The chain's recompute-backward with `pre(h, l)` as layer l's f32
    pre-activation and `back(gpre, l)` as the f32 product gpre @ W[l]^T:
    (dx, gpre, acts_in) at the kernel's rounding points."""
    acts, masks = [], []
    res = h = x
    for l, is_res in enumerate(tags):
        acts.append(h)
        p = pre(h, l)
        masks.append(p > 0)
        a = torch.relu(p).float().to(torch.bfloat16)
        if is_res:
            res = res + a
            h = res
        else:
            h = a
    g = g.to(torch.bfloat16)
    g_res = torch.zeros_like(g)
    gpre = [None] * len(tags)
    for l in reversed(range(len(tags))):
        if tags[l]:
            g = g + g_res
            g_res = g
        gpre[l] = torch.where(masks[l], g, torch.zeros_like(g))
        g = back(gpre[l], l).float().to(torch.bfloat16)
    return g + g_res, torch.stack(gpre), torch.stack(acts)


def library_chain_backward(torch, x, w, b, g, tags):
    """K2's function as cuBLAS calls (bf16 tensor-core GEMMs with f32 output)
    plus rounding, mask and residual bookkeeping. A yardstick only."""
    return chain_backward(torch, x, w, b, g, tags,
                          lambda h, l: torch.mm(h, w[l], out_dtype=torch.float32) + b[l],
                          lambda gp, l: torch.mm(gp, w[l].t(), out_dtype=torch.float32))


def exact_chain_backward(torch, x, w, b, g, tags):
    """K2's function with f64 sums and the same bf16 rounding points."""
    return chain_backward(torch, x, w, b, g, tags,
                          lambda h, l: h.double() @ w[l].double() + b[l].double(),
                          lambda gp, l: gp.double() @ w[l].double().t())


def rel_err(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def k2_bound(B: int, L: int):
    """Recompute forward + walk back: 4 B C^2 L operations; bytes: x, g, dx,
    gpre and acts_in once each, W once (dW runs outside the kernel)."""
    flops = 4.0 * B * 512 * 512 * L
    nbytes = (3 * B * 512 + 2 * L * B * 512) * 2 + L * 512 * 512 * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k1_bound(B: int, L: int):
    flops = 2.0 * B * 512 * 512 * L
    nbytes = 2 * B * 512 * 2 + L * 512 * 512 * 2 + L * 512 * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def synced_clock(torch) -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def compare_entries(np, got, want) -> dict:
    """Two registrations of the same frames, entry by entry: frames bit-equal,
    frames valid on one side only, frames more than max(1, 1%) inliers apart
    (and those of them at confidence MESH_REG_CONF or more on either side),
    and, over the frames at that confidence, how many are bit-equal, how
    many lie within MESH_REG_M and MESH_REG_DEG, and the pose gaps."""
    same = [a.confidence == b.confidence and np.array_equal(a.pose_w2c, b.pose_w2c) for a, b in zip(got, want)]
    conf = [max(a.confidence, b.confidence) >= MESH_REG_CONF for a, b in zip(got, want)]
    apart = [abs(a.confidence - b.confidence) > max(1.0, 0.01 * b.confidence) for a, b in zip(got, want)]
    pairs = [(a, b) for a, b, c in zip(got, want, conf) if c]
    dt = [float(np.linalg.norm(a.pose_c2w[:3, 3] - b.pose_c2w[:3, 3])) for a, b in pairs]
    dr = [float(angle_deg(np, a.pose_c2w[:3, :3], b.pose_c2w[:3, :3])) for a, b in pairs]
    return {"frames": len(got), "bit_equal": sum(same),
            "validity_differs": sum((a.confidence > 0) != (b.confidence > 0) for a, b in zip(got, want)),
            "inliers_apart": sum(apart),
            "inliers_apart_confident": [(Path(a.rgb_file).name, a.confidence, b.confidence)
                                        for a, b, c, x in zip(got, want, conf, apart) if c and x][:10],
            "confident_frames": len(pairs), "confident_bit_equal": sum(x for x, c in zip(same, conf) if c),
            "confident_within": sum(t <= MESH_REG_M and r <= MESH_REG_DEG for t, r in zip(dt, dr)),
            "max_trans_m": max(dt, default=0.0), "median_trans_m": statistics.median(dt) if dt else 0.0,
            "max_rot_deg": max(dr, default=0.0), "median_rot_deg": statistics.median(dr) if dr else 0.0,
            "confidence_median": statistics.median(e.confidence for e in got) if got else None}


def device_busy(DeviceType, prof) -> dict:
    """Each device's kernel-busy ms in a profiled window, the busy ms of
    their union, and how far the devices overlapped: 1 when the union is no
    longer than the busiest device (all ran at once), 0 when it is the sum
    (one after another); null with one device."""
    spans: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append((e.time_range.start, e.time_range.end))

    def union(iv):
        total, end = 0.0, float("-inf")
        for a, b in sorted(iv):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    busy = {int(d): union(iv) / 1e3 for d, iv in spans.items()}
    whole = union([x for iv in spans.values() for x in iv]) / 1e3
    total, top = sum(busy.values()), max(busy.values(), default=0.0)
    return {"busy_ms_by_device": busy, "union_ms": whole,
            "overlap": (total - whole) / (total - top) if len(busy) > 1 and total > top else None}


@contextlib.contextmanager
def k1_shapes(fh, into: list):
    """Appends [B, L] of every K1 launch made inside the block to `into`,
    read off the wrapper's own calls (the launch count stays the
    wrapper's)."""
    real = fh.fused_head_chain

    def recorded(x, w_stack, b_stack, res_after):
        out = real(x, w_stack, b_stack, res_after)
        if x.device.type == "cuda":
            into.append([int(x.shape[0]), len(res_after)])
        return out

    fh.fused_head_chain = recorded
    try:
        yield into
    finally:
        fh.fused_head_chain = real


def mapping_frames(iterations: int, chunk: int, every: int) -> int:
    """The mapping frames of a round that ran `iterations` steps: the
    trainer calls its frame callback at a chunk boundary `every` steps past
    its last call, and at the end."""
    it = last = frames = 0
    while it < iterations:
        it = min(it + chunk, iterations)
        if it - last >= every or it >= iterations:
            frames, last = frames + 1, it
    return frames


def ply_header_counts(path) -> dict:
    """{element: count} of a PLY file's header."""
    counts = {}
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"element "):
                _, name, n = line.split()
                counts[name.decode()] = int(n)
            if line.strip() == b"end_header":
                break
    return counts


def rot_err_deg(np, Ra, Rb) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1))))


def angle_deg(np, Ra, Rb):
    """Angles in degrees of Ra Rb^T over stacks of rotations, through scipy's
    rotation vectors (float32 matrices are orthonormal only to 1e-7, which an
    arccos of the trace turns into hundredths of a degree)."""
    from scipy.spatial.transform import Rotation

    rel = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64), -1, -2)
    return np.degrees(np.linalg.norm(Rotation.from_matrix(rel).as_rotvec(), axis=-1))


def drifted_chesslike(np, frames: int, stride: int = 16):
    """Exact coordinate maps of `frames` evenly strided chesslike_a frames
    from their shipped depth and poses at cell pitch `stride` of the 480 x
    640 images (a 240 x 320 canvas at stride 16), Random-Fourier features of
    the true points, and a smooth per-frame Sim(3) drift injected into the
    maps and the poses (tests/test_loopclose.py's recipe, in numpy).
    Returns (maps, feats, w2c, focals, canvas_hw)."""
    from scipy.spatial.transform import Rotation

    idx = np.round(np.linspace(0, 59, frames)).astype(int)
    scale = 8 / stride
    f = FOCAL * scale
    H, W = int(480 * scale), int(640 * scale)
    rng = np.random.default_rng(17)
    freqs = rng.normal(size=(3, 96)) * rng.uniform(1.0, 6.0, 96)
    phase = rng.uniform(0, 2 * np.pi, 96)
    maps, feats, w2c = [], [], []
    for k, i in enumerate(idx):
        depth = np.load(SCENE / f"frame_{i:04d}_depth.npy")[stride // 2 :: stride, stride // 2 :: stride]
        c2w = np.loadtxt(SCENE / f"frame_{i:04d}_pose.txt")
        v, u = np.mgrid[: depth.shape[0], : depth.shape[1]] * 8.0 + 4.0
        cam = np.stack([(u - W / 2) / f * depth, (v - H / 2) / f * depth, depth], -1)
        X = cam @ c2w[:3, :3].T + c2w[:3, 3]
        fe = np.sin(X @ freqs + phase)
        feats.append(fe / np.linalg.norm(fe, axis=-1, keepdims=True))
        a = np.sin(np.pi * k / frames) ** 2
        R = Rotation.from_rotvec(rng.normal(size=3) / np.sqrt(3) * np.radians(3.0) * a).as_matrix()
        t = rng.normal(size=3) / np.sqrt(3) * 0.1 * a
        maps.append(X @ R.T + t)
        c2w_d = np.eye(4)
        c2w_d[:3, :3] = R @ c2w[:3, :3]
        c2w_d[:3, 3] = R @ c2w[:3, 3] + t
        w2c.append(np.linalg.inv(c2w_d))
    return (np.stack(maps).astype(np.float32), np.stack(feats).astype(np.float32), np.stack(w2c),
            np.full(frames, f, np.float32), (H, W))


def core_with_fits(np, lc, *args):
    """lc.loop_close_core(*args) and the pairwise Sim(3) fits it made, read
    off its own calls: (s, R, t, diag, fits), fits mapping each selected
    pair of graph frames (i, j) to (R, t, n_inliers) on the host."""
    selected, results = [], []
    real_select, real_fit = lc.select_pairs, lc.pairwise_sim3

    def select(*a, **k):
        selected.append(real_select(*a, **k))
        return selected[-1]

    def fit(*a, **k):
        res = real_fit(*a, **k)
        results.append([res[key].cpu().numpy() for key in ("R", "t", "n_inliers")])
        return res

    lc.select_pairs, lc.pairwise_sim3 = select, fit
    try:
        s, R, t, diag = lc.loop_close_core(*args)
    finally:
        lc.select_pairs, lc.pairwise_sim3 = real_select, real_fit
    fits = {}
    if results:
        Rs, ts, ns = (np.concatenate(part) for part in zip(*results))
        fits = {(int(i), int(j)): (Rs[e], ts[e], int(ns[e])) for e, (i, j) in enumerate(selected[0])}
    return s, R, t, diag, fits


def card_vs_cpu(np, card, cpu):
    """The differences between two core_with_fits results: edge counts, the
    selected pairs, every common pair's fit and every frame's correction
    (translations in the scene's units, angles in degrees; p50, p90, max)."""
    (s_g, R_g, t_g, d_g, f_g), (s_c, R_c, t_c, d_c, f_c) = card, cpu

    def quantiles(a):
        return dict(zip(("p50", "p90", "max"), np.quantile(a, [0.5, 0.9, 1.0]).tolist()))

    common = sorted(set(f_g) & set(f_c))
    fits = None
    if common:
        fits = {"trans": quantiles([np.linalg.norm(f_g[p][1] - f_c[p][1]) for p in common]),
                "rot_deg": quantiles(angle_deg(np, np.stack([f_g[p][0] for p in common]),
                                               np.stack([f_c[p][0] for p in common]))),
                "inliers_equal": float(np.mean([f_g[p][2] == f_c[p][2] for p in common]))}
    return {"edges_card": d_g.get("edges"), "edges_cpu": d_c.get("edges"), "scene_diag": d_c.get("scene_diag"),
            "pairs_card": len(f_g), "pairs_cpu": len(f_c), "pairs_equal": sorted(f_g) == sorted(f_c),
            "edge_fits": fits,
            "frame_corrections": {"trans": quantiles(np.linalg.norm(t_g - t_c, axis=1)),
                                  "rot_deg": quantiles(angle_deg(np, R_g, R_c)),
                                  "scale_max": float(np.abs(s_g - s_c).max())}}


def pretrain_draws(torch, tep, cfg, n_total: int, steps: int, seed: int) -> list:
    """`steps` steps' draws for `pretrain_chunk` from a CPU generator: the
    batch rows and the augmentation (`data/augment.draw_aug_params`)."""
    from acezero_tpu_torch.data.augment import draw_aug_params

    gen = torch.Generator().manual_seed(seed)
    return [{"batch_idx": tep.sample_batch(cfg, n_total, gen, "cpu"),
             "aug": draw_aug_params(gen, cfg.batch_images, tep.AUG_ROTATION_DEG, tep.AUG_SCALE_MIN,
                                    tep.AUG_SCALE_MAX)}
            for _ in range(steps)]


def named_leaves(tree, path: str = "") -> list:
    """(path, leaf) of a tree of dicts, lists and tuples, dicts in sorted key
    order (the order of training.optim.tree_leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{path}/{i}")]
    return [(path, tree)]


def rel_update(torch, tree_leaves, after, before, want_after) -> float:
    """How far one device's update of a tree (after - before) is from
    another's (want_after - before): the relative Frobenius difference over
    all leaves, on the CPU."""
    def flat(tree):
        return torch.cat([t.detach().float().cpu().reshape(-1) for t in tree_leaves(tree)])

    a, b, w = flat(after), flat(before), flat(want_after)
    return float((a - w).norm() / (w - b).norm())


def jpeg_roundtrip_frame(np, i: int):
    """The i-th frame phase jpeg writes with write_jpeg: integer ramps and a
    hashed texture, no random draws, so every numpy gives the same pixels;
    frames 0-2 RGB, frame 3 gray, odd frames at a size off the MCU grid."""
    h, w = (48, 64) if i % 2 == 0 else (37, 53)
    y, x = np.mgrid[:h, :w].astype(np.int64)
    r = (x * (3 + i) + y * 2 + (x * y * 7919 + i * 104729) % 47) % 256
    g = (y * (5 + i) + (x * 31 + y * 17 * (i + 1)) % 29) % 256
    b = ((x + y) * 4 + (x ^ y) * (i + 1)) % 256
    img = np.stack([r, g, b], -1).astype(np.uint8)
    return img[..., 1].copy() if i == 3 else img


def runner_source(np, name: str):
    """The pixels of runner source `name`: integer ramps, a hashed texture
    and an alpha that is 0, 255 and a ramp between, no random draws, so
    every numpy gives the same pixels. uint8 but for the 16-bit kinds
    (uint16); palette.png gives its palette indices (into RUNNER_PALETTE),
    bilevel.png booleans."""
    kind, (h, w) = RUNNER_SOURCES[name]
    i = list(RUNNER_SOURCES).index(name)
    y, x = np.mgrid[:h, :w].astype(np.int64)
    r = (x * (3 + i) // 4 + y * 5 + (x * y * 7919 + i * 104729) % 37) % 256
    g = (y * 11 + x // 3 + (x * 31 + y * 17 * (i + 1)) % 23) % 256
    b = ((x + y) * 2 + (x ^ y) * (i + 1)) % 256
    a = np.clip((x * 7 + y * 13) % 383 - 64, 0, 255)
    if kind == "P":
        return ((x // 9 + y // 4) % len(RUNNER_PALETTE)).astype(np.uint8)
    if kind == "1":
        return (x // 7 + y // 3) % 3 == 0
    if kind.endswith(";16"):
        r, g, b, a = r * 256 + g, g * 256 + b, b * 256 + r, a * 257
    planes = {"L": [r], "I;16": [r], "RGB": [r, g, b], "RGB;16": [r, g, b], "LA": [r, a], "LA;16": [r, a],
              "RGBA": [r, g, b, a], "RGBA;16": [r, g, b, a], "CMYK": [r, g, b, 255 - a]}[kind]
    out = np.stack(planes, -1).astype(np.uint16 if kind.endswith("16") else np.uint8)
    return out[..., 0] if len(planes) == 1 else out


def write_runner_sources(np, out: Path) -> list[str]:
    """Write the runner sources into `out` with the port's writers, the
    palette, 1-bit and GIF ones copied from RUNNER_FIXTURES; their paths."""
    from acezero_tpu_torch.io.jpeg import write_jpeg
    from acezero_tpu_torch.io.jpeg2000 import write_jpeg2000
    from acezero_tpu_torch.io.pcx import write_pcx
    from acezero_tpu_torch.io.png import write_png
    from acezero_tpu_torch.io.qoi import write_qoi
    from acezero_tpu_torch.io.sgi import write_sgi
    from acezero_tpu_torch.io.tga import write_tga

    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, (kind, _) in RUNNER_SOURCES.items():
        dst = out / name
        if kind in ("P", "1") or name.endswith(".gif"):
            shutil.copyfile(RUNNER_FIXTURES / name, dst)
        elif name.endswith(".jpg"):
            write_jpeg(dst, runner_source(np, name))
        elif name.endswith((".jp2", ".j2k", ".jpx")):
            write_jpeg2000(dst, runner_source(np, name), kind)
        elif name.endswith(".tga"):
            write_tga(dst, runner_source(np, name), kind, **RUNNER_TGA_INFO)
        elif name.endswith(".sgi"):
            write_sgi(dst, runner_source(np, name), kind)
        elif name.endswith(".pcx"):
            write_pcx(dst, runner_source(np, name), kind)
        elif name.endswith(".qoi"):
            write_qoi(dst, runner_source(np, name), kind)
        else:
            write_png(dst, runner_source(np, name))
        paths.append(str(dst))
    return paths


def runner_downscale(runner, paths: list[str], work: Path) -> dict:
    """A Nerfstudio runner's `_downscale_images` over a transforms.json of
    one frame a source (focal 500, the principal point in the middle):
    source name -> the frame it rewrote."""
    work.mkdir(parents=True, exist_ok=True)
    frames = []
    for p in paths:
        h, w = RUNNER_SOURCES[Path(p).name][1]
        frames.append({"file_path": p, "fl_x": 500.0, "fl_y": 500.0, "cx": w / 2, "cy": h / 2, "w": w, "h": h})
    transforms = work / "transforms.json"
    transforms.write_text(json.dumps({"frames": frames, "train_filenames": list(paths), "test_filenames": []}))
    runner._downscale_images(transforms, work)
    return {Path(p).name: f for p, f in zip(paths, json.loads(transforms.read_text())["frames"])}


def runner_kinds_check(np, runner, work: Path) -> dict:
    """The runner's downscale of every runner source, written into `work`,
    against PIL's results (RUNNER_FIXTURES/pil_digests.json): for each
    source, whether its pixels, the frame's new size, focal and principal
    point, and the output's bytes (a JPEG, TGA, SGI, PCX or QOI) or mode,
    pixels and RGB pixels (a PNG, a TIFF, a JPEG 2000 ...; and a GIF's
    palette and transparency index) equal PIL's, and all of them together
    (`equal_to_pil`)."""
    from acezero_tpu_torch.data.images import pil_array, read_image, read_rgb
    from acezero_tpu_torch.io.formats import pil_mode
    from acezero_tpu_torch.io.gif import read_gif

    want = json.loads((RUNNER_FIXTURES / "pil_digests.json").read_text())
    frames = runner_downscale(runner, write_runner_sources(np, work / "sources"), work / "out")
    kinds = {}
    for name, fr in frames.items():
        w, path = want[name], Path(fr["file_path"])
        check = {"kind": RUNNER_SOURCES[name][0], "hw": [fr["h"], fr["w"]],
                 "source_equal": array_digest(runner_source(np, name)) == w["source_sha256"],
                 "frame_equal": path.name == name and all(fr[k] == w[k] for k in ("w", "h", "fl_x", "fl_y", "cx", "cy"))}
        if name.endswith(RUNNER_BYTES_SUFFIXES):
            check["bytes_equal"] = hashlib.sha256(path.read_bytes()).hexdigest() == w["bytes_sha256"]
        if not name.endswith(".jpg"):
            check["mode"] = pil_mode(path)
            check["pixels_equal"] = (check["mode"] == w["mode"] and array_digest(pil_array(read_image(path))) == w["sha256"]
                                     and array_digest(read_rgb(path)) == w["rgb_sha256"])
            if name.endswith(".gif"):
                r = read_gif(path)
                check["palette_equal"] = (r.transparency == w["transparency"]
                                          and palette_digest(np, r.palette) == w["palette"])
        check["equal_to_pil"] = all(v for k, v in check.items() if k.endswith("_equal"))
        kinds[name] = check
    return kinds


def canvas_pass_check(np, files: list[str], short_size: int):
    """The canvas pass (data/csrc/canvas.cpp) on each image file alone, one
    thread, against its plain numpy version (images.gray_resize), at the
    size decode_to_canvas gives it for `short_size`: a record (each sha256
    equal or not, ms of each) and the canvases built from the plain
    version, which decode_to_canvas must give. The files share one size."""
    from acezero_tpu_torch.data import native
    from acezero_tpu_torch.data.images import canvas_input, gray_resize, read_image

    img = canvas_input(read_image(files[0]))
    orig = np.array([img.shape[:2]], np.int32)  # decode_to_canvas's arithmetic
    out_h, out_w = (int(v) for v in np.round(orig * (short_size / orig.min(axis=1).astype(np.float32))[:, None])
                    .astype(np.int32)[0])
    hc, wc = (-(-v // 8) * 8 for v in (out_h, out_w))
    plain_canvases = np.zeros((len(files), hc, wc), np.uint8)
    got = np.zeros((out_h, out_w), np.uint8)
    native.gray_resize_center(got[:1, :1], np.zeros((1, 1), np.uint8), 1, 1)  # load the library first
    pass_s, plain_s, equal = [], [], []
    for i, f in enumerate(files):
        img = canvas_input(read_image(f))
        t0 = time.perf_counter()
        native.gray_resize_center(img, got, out_h, out_w, f)
        pass_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        plain = gray_resize(img, out_h, out_w)
        plain_s.append(time.perf_counter() - t0)
        equal.append(array_digest(got) == array_digest(plain))
        plain_canvases[i, (hc - out_h) // 2:(hc - out_h) // 2 + out_h, (wc - out_w) // 2:(wc - out_w) // 2 + out_w] = plain
    return {"out_hw": [out_h, out_w], "equal_to_plain": f"{sum(equal)}/{len(equal)}", "equal": all(equal),
            "pass_ms": statistics.median(pass_s) * 1e3, "pass_ms_each": [t * 1e3 for t in pass_s],
            "plain_ms": statistics.median(plain_s) * 1e3}, plain_canvases


def tinted(np, img):
    """(h, w, 3) uint8: a gray (or RGB) frame with JPEG_TINT added to its
    channels."""
    base = img.astype(np.int16) if img.ndim == 3 else img.astype(np.int16)[..., None]
    return np.clip(base + np.asarray(JPEG_TINT, np.int16), 0, 255).astype(np.uint8)


def palette_digest(np, palette) -> list | None:
    """[colours, sha256 of the RGB bytes] of a palette (PIL's `getpalette()`
    list, or an (n, 3) array), None for none."""
    if palette is None:
        return None
    flat = np.asarray(palette, np.uint8).reshape(-1)
    return [len(flat) // 3, array_digest(flat)]


def gif_grey_frame(np, gray, tint: bool = False):
    """(indices, palette) of a gray (h, w) uint8 frame as a mode-P image of
    a permuted palette: entry perm[g] is the grey g, or with `tint` the
    grey g tinted by JPEG_TINT, so that the palette gives the frame's (or
    the tinted frame's) colours exactly."""
    perm = np.random.default_rng(GIF_PALETTE_SEED).permutation(256).astype(np.uint8)
    levels = np.arange(256, dtype=np.uint8)
    palette = np.empty((256, 3), np.uint8)
    palette[perm] = tinted(np, levels[None, :])[0] if tint else np.repeat(levels[:, None], 3, axis=1)
    return perm[gray], palette


def array_digest(arr) -> str:
    """sha256 of a decoded image's bytes (C order); a boolean array as bytes
    of 0 and 1 (the array of PIL's mode-1 image holds 0 and 255)."""
    if arr.dtype.kind == "b":
        arr = (arr != 0).view("u1")
    return hashlib.sha256(arr.tobytes()).hexdigest()


def canvas_digest(out) -> str:
    """sha256 of decode_to_canvas's result: the canvases, then the sizes,
    the original sizes (int32) and the scale factors (float32)."""
    h = hashlib.sha256()
    for arr, dtype in ((out.canvases, "uint8"), (out.sizes, "int32"), (out.orig_sizes, "int32"),
                       (out.scale_factors, "float32")):
        h.update(arr.astype(dtype).tobytes())
    return h.hexdigest()


def write_format_frame(np, path: Path, img, kind: str) -> None:
    """Write a gray (h, w) or RGB (h, w, 3) uint8 frame as a TIFF of `kind`
    (FORMAT_TIFF_KINDS, FORMAT_PHOTO_KINDS): "raw" with the port's
    write_tiff, the others with the numpy writer of scripts/tiff_encode.py
    (PackBits in strips of 16 rows, Deflate with predictor 2 in
    strips of 8, big-endian in strips of 32, Deflate in 64 x 64 tiles,
    planar configuration 2 in strips of 24)."""
    from acezero_tpu_torch.io.tiff import write_tiff

    if kind == "raw":
        write_tiff(path, img, "L" if img.ndim == 2 else "RGB")
        return
    if str(ROOT / "scripts") not in sys.path:
        sys.path.insert(0, str(ROOT / "scripts"))
    from tiff_encode import tiff_bytes

    opts = {"packbits": {"compression": 32773, "rows_per_strip": 16},
            "deflate_pred2": {"compression": 8, "predictor": 2, "rows_per_strip": 8},
            "mm": {"big": True, "rows_per_strip": 32}, "tiled": {"compression": 8, "tile": (64, 64)},
            "planar": {"planar": 2, "rows_per_strip": 24}}[kind]
    bits = (8,) * (1 if img.ndim == 2 else img.shape[2])
    path.write_bytes(tiff_bytes(img, bits=bits, photometric=1 if img.ndim == 2 else 2, **opts))


def photo_decode_runs(root: Path, runs: list) -> list[dict]:
    """decode_to_canvas of image globs at a 480 short side in one fresh
    process, one run a (pattern, workers) pair in turn: seconds, a digest
    of the canvases, and the growth of the resident set over the call
    (VmRSS sampled every 2 ms from just before it, after a garbage
    collection and glibc's malloc_trim hand the last run's memory back;
    the process's peak, ru_maxrss, is the import's or an earlier run's)."""
    code = (
        "import ctypes, gc, glob, hashlib, json, resource, sys, threading, time\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "from acezero_tpu_torch.data.images import decode_to_canvas\n"
        "def rss_kib():\n"
        "    with open('/proc/self/status') as f:\n"
        "        return next(int(ln.split()[1]) for ln in f if ln.startswith('VmRSS:'))\n"
        "results = []\n"
        f"for pattern, workers in {[(str(p_), int(w)) for p_, w in runs]!r}:\n"
        "    gc.collect()\n"
        "    try:\n"
        "        ctypes.CDLL(None).malloc_trim(0)\n"
        "    except (OSError, AttributeError):\n"
        "        pass\n"
        "    peak, done = [rss_kib()], threading.Event()\n"
        "    def sample():\n"
        "        while not done.wait(0.002):\n"
        "            peak.append(rss_kib())\n"
        "    paths = sorted(glob.glob(pattern))\n"
        "    r0, m0 = peak[0], resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "    t = threading.Thread(target=sample)\n"
        "    t.start()\n"
        "    t0 = time.perf_counter()\n"
        "    out = decode_to_canvas(paths, short_size=480, num_workers=workers)\n"
        "    dt = time.perf_counter() - t0\n"
        "    done.set()\n"
        "    t.join()\n"
        "    m1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "    results.append({'seconds': dt, 'frames': len(paths), 'rss_growth_mib': (max(peak) - r0) / 1024,"
        " 'rss_samples': len(peak), 'maxrss_growth_mib': (m1 - m0) / 1024, 'canvas_shape': list(out.canvases.shape),"
        " 'sha256': hashlib.sha256(out.canvases.tobytes()).hexdigest()})\n"
        "    del out\n"
        "print(json.dumps(results))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"decode_to_canvas runs {runs} failed: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def photo_decode_child(root: Path, pattern: str, workers: int) -> dict:
    """decode_to_canvas of an image glob at a 480 short side with `workers`
    workers, alone in a fresh process (photo_decode_runs)."""
    return photo_decode_runs(root, [(pattern, workers)])[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="On-card smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    ap.add_argument("--handoff", default=None,
                    help="run the phases in this process, write their launch counts to this JSON "
                         "file and print no report or status line (the children of PARALLEL_GROUPS)")
    return ap


def parse_phases(argv) -> list[str]:
    """The phases to run, in PHASES order, `device` always among them and
    `bare` whenever `render` is (it reads bare's output). An unknown name
    is an error (argparse exits with status 2)."""
    ap = parser()
    args = ap.parse_args(argv)
    names = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = sorted(names - set(PHASES))
    if unknown or not names:
        ap.error(f"unknown phase(s) {unknown}; choose from {','.join(PHASES)}")
    if "render" in names:
        names.add("bare")
    return [p for p in PHASES if p in names or p == "device"]


def parallel_groups(phases: list[str]) -> list[list[str]]:
    """The groups of PARALLEL_GROUPS that hold a phase of `phases`, each cut
    to those phases; none where fewer than two do (the phases then run in
    this process)."""
    groups = [[p for p in g if p in phases] for g in PARALLEL_GROUPS]
    groups = [g for g in groups if g]
    return groups if len(groups) > 1 else []


def _die_with_parent() -> None:
    """In a child, before exec: the kernel sends it SIGKILL when the parent
    ends, however the parent ends."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def run_groups(groups: list[list[str]], work: str) -> dict:
    """Run each group of phases in a child process of this script, all at
    once, relaying their lines as they come (their standard error is this
    process's), and return the launch counts they hand back by name. When
    a child fails the others are stopped and this raises."""
    procs = []
    for i, group in enumerate(groups):
        out = Path(work) / f"handoff_{i}.json"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--phases", ",".join(group), "--handoff", str(out)]
        procs.append((group, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                                   preexec_fn=_die_with_parent)))
    lock = threading.Lock()

    def relay(stream):
        for line in stream:
            with lock:
                sys.stdout.write(line)
                sys.stdout.flush()

    relays = [threading.Thread(target=relay, args=(p.stdout,), daemon=True) for _, _, p in procs]
    for t in relays:
        t.start()
    try:
        codes = [p.poll() for _, _, p in procs]
        while None in codes and not any(codes):
            time.sleep(0.2)
            codes = [p.poll() for _, _, p in procs]
    finally:
        for _, _, p in procs:
            if p.poll() is None:
                p.terminate()
        for _, _, p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in relays:
            t.join(timeout=20)
    failed = [(g, p.returncode) for g, _, p in procs if p.returncode != 0]
    if failed:
        raise RuntimeError(f"phase group(s) failed (group, exit code): {failed}")
    handed = {}
    for group, out, _ in procs:
        for name, value in json.loads(out.read_text()).items():
            if value is not None:
                handed[name] = value
    return handed


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    phases = parse_phases(argv)
    handoff = parser().parse_args(argv).handoff
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "acezero_tpu_torch" / "ops" / "csrc").is_dir():
        print(f"chip_smoke: the acezero_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from acezero_tpu_torch.cli import ace_zero_cli, register_cli, train_ace_cli
    from acezero_tpu_torch.evalpose import estimate_alignment, evaluate_poses
    from acezero_tpu_torch.geometry import backproject_depth, get_pixel_grid
    from acezero_tpu_torch.io.pose_files import read_pose_file, registration_rates
    from acezero_tpu_torch.models import torch_io
    from acezero_tpu_torch.models.encoder import encoder_apply
    from acezero_tpu_torch.models.head import HeadConfig, head_apply_flat, head_epilogue
    from acezero_tpu_torch.io.pose_files import PoseFileEntry
    from acezero_tpu_torch.reconstruct import loopclose as lc
    from acezero_tpu_torch.reconstruct import pipeline as tpipe
    from acezero_tpu_torch.reconstruct.config import AceZeroConfig
    from acezero_tpu_torch.ops import build
    from acezero_tpu_torch.ops import fused_head as fh
    from acezero_tpu_torch.registration.driver import _canvas_prologue
    from acezero_tpu_torch.registration.ransac import RansacConfig, estimate_poses_batch
    from acezero_tpu_torch.data.depth import learned_depth_estimator
    from acezero_tpu_torch.data import native as tnative
    from acezero_tpu_torch.data.images import decode_to_canvas, pil_resize_bilinear, read_png, read_rgb
    from acezero_tpu_torch.io import jpeg as tjpeg
    from acezero_tpu_torch.io import tiff as ttiff
    from acezero_tpu_torch.io import webp as twebp
    from acezero_tpu_torch.io import gif as tgif
    from acezero_tpu_torch.io import jpeg2000 as tj2k
    from acezero_tpu_torch.io import pcx as tpcx
    from acezero_tpu_torch.io import qoi as tqoi
    from acezero_tpu_torch.io import raster as traster
    from acezero_tpu_torch.io import sgi as tsgi
    from acezero_tpu_torch.io import tga as ttga
    from acezero_tpu_torch.io.jpeg import read_jpeg, write_jpeg
    from acezero_tpu_torch.io.pose_files import write_pose_file
    from acezero_tpu_torch.data.augment import normalize_images
    from acezero_tpu_torch.cli import export_cli, render_final_sweep_cli
    from acezero_tpu_torch.export import nerf, nerfstudio_runner
    from acezero_tpu_torch.export.point_cloud import predict_coords
    from acezero_tpu_torch.models import Regressor
    from acezero_tpu_torch.viz import ReconstructionVisualizer, VizConfig
    from acezero_tpu_torch.viz.renderer import composite_frame, render_cameras, render_point_cloud
    from acezero_tpu_torch.data.scene import load_scene
    from acezero_tpu_torch.io.ply import read_ply_points
    from acezero_tpu_torch.training.optim import tree_leaves
    from acezero_tpu_torch.training import BufferConfig, MappingTrainer, ReproLossConfig, ScheduleConfig, TrainConfig
    from acezero_tpu_torch.training.trainer import train_hp, train_steps
    from acezero_tpu_torch.utils import profiling

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")  # outputs that one phase hands to a later one
    atexit.register(shutil.rmtree, work, True)
    with phase("device", {}) as rec:
        rec.update(kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
                   torch=torch.__version__, cuda=torch.version.cuda,
                   capability=list(torch.cuda.get_device_capability(0)), python=sys.version.split()[0])
        require(torch.version.cuda is not None, "torch is not built for CUDA")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if "build" in phases:
        with phase("build", {}) as rec:
            t0 = time.perf_counter()
            # the host libraries (c++: the JPEG codec, the canvas pass, the
            # TIFF and BMP codecs, the WebP, GIF, JPEG 2000 and raster
            # codecs) build while nvcc builds the kernels
            host_sources = (tjpeg.SOURCE, tnative.SOURCE, ttiff.SOURCE, twebp.SOURCE, tgif.SOURCE, tj2k.SOURCE,
                            traster.SOURCE)
            with concurrent.futures.ThreadPoolExecutor(max_workers=len(host_sources)) as ex:
                hosts = [ex.submit(build.build_host, src) for src in host_sources]
                build.build([fh.KERNEL, fh.KERNEL_BWD])
                rec["seconds_nvcc"] = time.perf_counter() - t0
                for h in hosts:
                    h.result()
            rec["host"] = {}
            for src in host_sources:
                info = build.build_info[src.stem]
                rec["host"][src.stem] = {"seconds": info["seconds"], "compiler": info.get("compiler"),
                                         "library": build.host_target(src).name, "log": info["log"][-500:]}
            for name in (fh.KERNEL, fh.KERNEL_BWD):
                log = build.build_info[name]["log"]
                rec[f"ptxas_{name}"] = [ln.strip() for ln in log.splitlines()
                                        if "registers" in ln or "spill" in ln or "warpgroup" in ln or "wgmma" in ln][:8]

    k1, k2 = {}, {}  # timed cases, by name
    launches = map_launches = lc_launches = None  # launch counts of phases slice, mapping, loopclose
    format_launches = None  # launch counts of phase formats, by run
    slice_poses = None  # phase slice's register_cli poses of the PNG glob, file names dropped
    lc_shapes = None  # [B, L] of each K1 launch of phase loopclose
    map_head = None  # (HeadConfig, params) of phase mapping's fixed-pose run
    pipe_launches = None  # launch counts of phase pipeline
    bare_launches = None  # launch counts of phase bare
    render_launches = None  # launch counts of phase render's main-path calls
    spill_launches = None  # launch counts of phase spill
    mesh_launches = None  # launch counts of phase mesh, in all and by mesh and run
    pretrain_launches = None  # launch counts of phase pretrain, by run
    if "kernels" in phases:
        with phase("kernels", {}) as rec:
            results = []
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            info = fh.forward_kernel_info()
            rec["k1_resources"] = {**info, "sms": sms}
            require(info["local_bytes"] == 0, f"K1 uses {info['local_bytes']} bytes of stack or spill a thread")
            for i, (name, B, tags) in enumerate(K1_CASES):
                x, w, b = k1_inputs(torch, B, tags, seed=i)
                out = fh.fused_head_chain(x, w, b, tags)
                torch.cuda.synchronize()
                ref = fh.fused_head_chain_plain(x, w, b, tags).float()
                diff = out.float() - ref
                rel = float(diff.norm() / ref.norm())
                entry = {"case": name, "B": B, "L": len(tags), "rel_err": rel,
                         "max_abs_err": float(diff.abs().max()),
                         "finite": bool(torch.isfinite(out.float()).all())}
                results.append(entry)
                require(entry["finite"] and rel <= K1_TOL, f"K1 {name}: rel err {rel} > {K1_TOL}")
                if name in K1_TIMED:
                    entry["rel_err_vs_library"] = rel_err(out, library_chain(torch, x, w, b, tags))
                    entry["kernel_ms"] = time_ms(lambda: fh.fused_head_chain(x, w, b, tags), torch)
                    entry["kernel_ms_stream"] = stream_ms(lambda: fh.fused_head_chain(x, w, b, tags), torch)
                    # the host's launch cost where the device waits for it
                    entry["launch_overhead_ms"] = entry["kernel_ms"] - entry["kernel_ms_stream"]
                    entry["plain_ms"] = time_ms(lambda: fh.fused_head_chain_plain(x, w, b, tags), torch)
                    entry["library_ms"] = time_ms(lambda: library_chain(torch, x, w, b, tags), torch)
                    entry["bound_ms"], entry["bound_by"] = k1_bound(B, len(tags))
                    tiles = -(-B // info["tile_rows"])
                    flops = 2.0 * B * 512**2 * len(tags)
                    entry.update(tflops=flops / (entry["kernel_ms"] * 1e-3) / 1e12,
                                 tflops_stream=flops / (entry["kernel_ms_stream"] * 1e-3) / 1e12,
                                 tiles=tiles, sm_fill=tiles / sms)
                    k1[name] = entry
                del x, w, b, out, ref, diff
            rec["cases"] = results

            results = []
            info = fh.backward_kernel_info()
            rec["k2_resources"] = {**info, "sms": sms}
            for i, (name, B, tags) in enumerate(K2_CASES):
                x, w, b, g = k2_inputs(torch, B, tags, seed=10 + i)
                out = fh.fused_head_chain_backward(x, w, b, g, tags)
                torch.cuda.synchronize()
                ref = fh.fused_head_chain_backward_plain(x, w, b, g, tags)
                exact = exact_chain_backward(torch, x, w, b, g, tags)
                entry = {"case": name, "B": B, "L": len(tags),
                         "finite": all(bool(torch.isfinite(t.float()).all()) for t in out)}
                for k, o, r, e in zip(("dx", "gpre", "acts_in"), out, ref, exact):
                    entry[f"rel_err_{k}"] = rel_err(o, r)
                    entry[f"rel_err_{k}_vs_exact"] = rel_err(o, e)
                    entry[f"plain_rel_err_{k}_vs_exact"] = rel_err(r, e)
                entry["max_abs_err"] = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
                entry["rel_err"] = max(entry[f"rel_err_{k}"] for k in ("dx", "gpre", "acts_in"))
                # the autograd Function's dW, db against autograd of the plain chain
                grads = []
                for fn in (lambda *a: fh.FusedHeadChain.apply(*a, tags), lambda *a: fh.fused_head_chain_plain(*a, tags)):
                    wf = w.float().requires_grad_(True)
                    bf = b.clone().requires_grad_(True)
                    (fn(x, wf, bf).float() * g.float()).sum().backward()
                    grads.append((wf.grad, bf.grad))
                entry["rel_err_dW"] = rel_err(grads[0][0], grads[1][0])
                entry["rel_err_db"] = rel_err(grads[0][1], grads[1][1])
                results.append(entry)
                require(entry["finite"] and entry["rel_err"] <= K2_TOL,
                        f"K2 {name}: rel err {entry['rel_err']} > {K2_TOL}")
                require(entry["rel_err_dW"] <= K2_GRAD_TOL and entry["rel_err_db"] <= K2_GRAD_TOL,
                        f"K2 {name}: dW/db rel err {entry['rel_err_dW']}/{entry['rel_err_db']} > {K2_GRAD_TOL}")
                if name in K2_TIMED:
                    entry["kernel_ms"] = time_ms(lambda: fh.fused_head_chain_backward(x, w, b, g, tags), torch)
                    entry["kernel_ms_stream"] = stream_ms(lambda: fh.fused_head_chain_backward(x, w, b, g, tags), torch)
                    entry["bound_ms"], entry["bound_by"] = k2_bound(B, len(tags))
                    tiles = -(-B // info["tile_rows"])
                    entry.update(tflops=4.0 * B * 512**2 * len(tags) / (entry["kernel_ms"] * 1e-3) / 1e12,
                                 tflops_stream=4.0 * B * 512**2 * len(tags) / (entry["kernel_ms_stream"] * 1e-3) / 1e12,
                                 smem_bytes=info["smem_bytes"], tiles=tiles, sm_fill=tiles / sms,
                                 ms_per_tile_wave=entry["kernel_ms"] / -(-tiles // sms))
                    k2[name] = entry
                if name in ("mapping", "pretrain"):
                    lib = library_chain_backward(torch, x, w, b, g, tags)
                    entry["rel_err_dx_vs_library"] = rel_err(out[0], lib[0])
                    entry["plain_ms"] = time_ms(lambda: fh.fused_head_chain_backward_plain(x, w, b, g, tags), torch)
                    entry["library_ms"] = time_ms(lambda: library_chain_backward(torch, x, w, b, g, tags), torch)
                    entry["weight_grads_ms"] = time_ms(lambda: fh.chain_weight_grads(out[1], out[2]), torch)
                    del lib
                del x, w, b, g, out, ref, exact, grads
            rec["k2_cases"] = results
            torch.cuda.empty_cache()

    if "registrar" in phases:
        with phase("registrar", {}) as rec:
            frames = sorted(glob.glob(str(SCENE / FRAMES)))
            require(len(frames) == N_FRAMES, f"expected {N_FRAMES} chesslike_a frames, found {len(frames)}")
            grid = get_pixel_grid(60, 80, 8, device=DEVICE)
            coords, masks, gts = [], [], []
            for f in frames:
                stem = f[: -len(".png")]
                depth = torch.from_numpy(np.load(stem + "_depth.npy")[4::8, 4::8].astype(np.float32)).to(DEVICE)
                gt = np.loadtxt(stem + "_pose.txt")
                gts.append(gt)
                pose = torch.from_numpy(gt.astype(np.float32)).to(DEVICE)
                coords.append(backproject_depth(depth, FOCAL, 320.0, 240.0, pose, grid))
                masks.append((depth > 0) & (depth <= 1000.0))
            n = len(frames)
            t0 = time.perf_counter()
            out = estimate_poses_batch(
                torch.stack(coords), torch.stack(masks), grid, torch.full((n,), FOCAL, device=DEVICE),
                torch.full((n,), 320.0, device=DEVICE), torch.full((n,), 240.0, device=DEVICE),
                RansacConfig(), generator=torch.Generator(device=DEVICE).manual_seed(1305))
            torch.cuda.synchronize()
            rec["estimate_seconds"] = time.perf_counter() - t0
            poses = out["pose_c2w"].double().cpu().numpy()
            r_err = [rot_err_deg(np, poses[i, :3, :3], gts[i][:3, :3]) for i in range(n)]
            t_err = [float(np.linalg.norm(poses[i, :3, 3] - gts[i][:3, 3])) for i in range(n)]
            rec.update(frames=n, valid=int(out["valid"].sum()), median_rot_deg=statistics.median(r_err),
                       median_trans_mm=statistics.median(t_err) * 1e3, max_rot_deg=max(r_err),
                       max_trans_mm=max(t_err) * 1e3)
            require(bool(out["valid"].all()), "a frame had no valid hypothesis")
            require(rec["median_rot_deg"] <= 0.1, f"median rotation error {rec['median_rot_deg']} deg")
            require(rec["median_trans_mm"] <= 2.0, f"median translation error {rec['median_trans_mm']} mm")

    if "slice" in phases:
        with phase("slice", {}) as rec:
            class Capture(logging.Handler):
                def __init__(self):
                    super().__init__()
                    self.registered = None

                def emit(self, record):
                    if record.msg.startswith("Registered %d frames in"):
                        self.registered = record.args

            cap = Capture()
            logging.getLogger("acezero_tpu_torch.registration.driver").addHandler(cap)
            with tempfile.TemporaryDirectory() as tmp:
                net = Path(tmp) / "iteration2.pt"
                shutil.copy(HEAD, net)
                argv = [str(SCENE / FRAMES), str(net), "--encoder_path", str(ENCODER),
                        "--use_external_focal_length", str(FOCAL), "--session", "smoke", "--device", DEVICE]
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                rc = register_cli.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = fh.LAUNCHES
                require(fh.LAUNCHES_BWD == 0, "registration launched the backward kernel")
                require(rc == 0, f"register_cli returned {rc}")
                lines = (Path(tmp) / "poses_smoke.txt").read_text().splitlines()
                entries = read_pose_file(Path(tmp) / "poses_smoke.txt")
            slice_poses = [ln.split()[1:] for ln in lines]
            require(launches > 0, "the main path never launched fused_head_fwd")
            require(len(lines) == N_FRAMES and all(len(ln.split()) == 10 for ln in lines),
                    f"pose file is not {N_FRAMES} lines of 10 tokens")
            require(all(np.isfinite(e.pose_w2c).all() for e in entries), "non-finite pose")
            reg_seconds = cap.registered[1] if cap.registered else float("nan")
            rec.update(cli_seconds=wall, register_seconds=reg_seconds, frames=len(entries),
                       frames_per_s=len(entries) / reg_seconds, cli_frames_per_s=len(entries) / wall,
                       fused_head_fwd_launches=launches, kind=kind, nvidia_smi=smi,
                       inliers_median=statistics.median(e.confidence for e in entries))

            # Scene coordinates of the same features through K1, the plain chain,
            # cuBLAS (yardstick) and the exact chain (f64 sums, the same bf16
            # rounding points). Tensor cores accumulate in f32 with truncation, so
            # K1 and cuBLAS flip a bf16 rounding in about 2% of the cells where an
            # IEEE f32 sum flips in under 1%; a flip moves a cell by millimetres.
            # The checks: K1 equals the exact chain in at least 95% of the cells,
            # and its coordinates are within 2^-9 (bf16's unit roundoff) of the
            # exact ones, relative Frobenius. A wrong kernel changes nearly every
            # cell.
            scene = load_scene(str(SCENE / FRAMES), external_focal_length=FOCAL)
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            head_cfg, head = torch_io.load_head(HEAD, DEVICE)
            with torch.inference_mode():
                t0 = synced_clock(torch)
                images, mask_lr, grid, ppx, ppy = _canvas_prologue(
                    torch.from_numpy(scene.images.canvases).to(DEVICE),
                    torch.from_numpy(scene.images.sizes.astype(np.int64)).to(DEVICE), 8)
                feats = encoder_apply(enc, images).reshape(-1, 512).to(torch.bfloat16)
                t1 = synced_clock(torch)
                w, b, tags = fh.head_params_to_stack(head, head_cfg)
                hidden = {"k1": fh.fused_head_chain(feats, w, b, tags),
                          "plain": fh.fused_head_chain_plain(feats, w, b, tags),
                          "library": library_chain(torch, feats, w, b, tags),
                          "exact": exact_chain(torch, feats, w, b, tags)}
                coords = {k: head_epilogue(head, head_cfg, v) for k, v in hidden.items()}
                t2 = synced_clock(torch)
                via_k1 = head_apply_flat(head, head_cfg, feats)
                t3 = synced_clock(torch)
            # time split of one pass over the 60 frames (pass-1 refit cap)
            n = len(scene)
            estimate_poses_batch(via_k1.reshape(n, *mask_lr.shape[1:], 3), mask_lr, grid,
                                 torch.as_tensor(scene.focals_canvas, device=DEVICE), ppx, ppy,
                                 RansacConfig(), max_refine_steps=16,
                                 generator=torch.Generator(device=DEVICE).manual_seed(1305))
            t4 = synced_clock(torch)
            rec["split_seconds"] = {"encoder": t1 - t0, "head": t3 - t2, "registrar": t4 - t3}
            require(bool(torch.equal(via_k1, coords["k1"])), "head_apply_flat does not go through K1")
            require(bool(torch.isfinite(via_k1).all()), "non-finite scene coordinates")
            stats = {}
            for a, bb in (("k1", "plain"), ("k1", "exact"), ("plain", "exact"), ("library", "exact"),
                          ("k1", "library")):
                d = torch.linalg.vector_norm(coords[a] - coords[bb], dim=-1).float()
                q = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99, 0.999], device=d.device)).tolist()
                stats[f"{a}_vs_{bb}"] = {
                    "p50_mm": q[0] * 1e3, "p90_mm": q[1] * 1e3, "p99_mm": q[2] * 1e3, "p999_mm": q[3] * 1e3,
                    "max_mm": float(d.max()) * 1e3, "cells_differing": float((d > 0).float().mean()),
                    "hidden_elems_differing": float((hidden[a] != hidden[bb]).float().mean()),
                    "rel_err": float((coords[a] - coords[bb]).norm() / coords[bb].norm()),
                }
            rec["coords"] = stats
            rec["coords_abs_m_p50"] = float(torch.quantile(torch.linalg.vector_norm(coords["exact"], dim=-1), 0.5))
            k1_exact = stats["k1_vs_exact"]
            require(k1_exact["cells_differing"] <= 0.05,
                    f"K1 coordinates differ from the exact chain in {k1_exact['cells_differing']:.2%} of cells")
            require(k1_exact["rel_err"] <= 2**-9, f"K1 coordinates: relative error {k1_exact['rel_err']}")

    if "formats" in phases:
        with phase("formats", {}) as rec:
            from acezero_tpu_torch.data.depth import load_depth_file
            from acezero_tpu_torch.data.images import pil_array, read_image
            from acezero_tpu_torch.io import formats as tformats
            from acezero_tpu_torch.io.png import write_png
            from acezero_tpu_torch.io.pnm import write_pnm
            from acezero_tpu_torch.io.tiff import write_tiff

            rec.update(kind=kind, nvidia_smi=smi, tiff_library=build.host_target(ttiff.SOURCE).name)
            # (a) the committed fixtures decode to PIL's arrays and modes, and
            # their canvases and depth maps are the JAX package's
            t0 = time.perf_counter()
            digests = json.loads((FORMAT_FIXTURES / "pil_digests.json").read_text())
            checks = {}
            for name, want in sorted(digests["files"].items()):
                path = FORMAT_FIXTURES / name
                arr = pil_array(read_image(path))
                checks[name] = {"pixels": arr.dtype.str == want["dtype"] and list(arr.shape) == want["shape"]
                                and array_digest(arr) == want["sha256"],
                                "mode": tformats.pil_mode(path) == want["mode"],
                                "rgb": array_digest(read_rgb(path)) == want["rgb_sha256"]}
            bad = sorted(n for n, c in checks.items() if not all(c.values()))
            rec["fixtures_equal_to_pil"] = f"{len(checks) - len(bad)}/{len(checks)}"
            require(checks and not bad, f"fixtures not decoded as PIL decodes them: { {n: checks[n] for n in bad} }")
            paths = sorted(str(FORMAT_FIXTURES / n) for n in digests["files"])
            canvas = []
            for entry in digests["canvas"]:
                hw = None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
                out = decode_to_canvas(paths, short_size=entry["short_size"], canvas_hw=hw, num_workers=4)
                canvas.append({"short_size": entry["short_size"], "canvas_hw": entry["canvas_hw"],
                               "shape": list(out.canvases.shape),
                               "equal_to_jax": canvas_digest(out) == entry["sha256"]})
            rec["canvas"] = canvas
            require(len(canvas) == 2 and all(c["equal_to_jax"] for c in canvas),
                    f"decode_to_canvas over the fixtures is not the JAX package's: {canvas}")
            depth = {n: array_digest(load_depth_file(FORMAT_FIXTURES / n)) == want
                     for n, want in digests["depth"].items()}
            rec["depth_equal_to_jax"] = f"{sum(depth.values())}/{len(depth)}"
            require(depth and all(depth.values()), f"load_depth_file is not the JAX package's: {depth}")
            rec["fixtures_seconds"] = time.perf_counter() - t0

            # (b) the 60 frames as TIFF (FORMAT_TIFF_KINDS in turn), their
            # depth in millimetres as 16-bit PNG, TIFF (II and MM) and PGM
            tmp = Path(work) / "formats"
            for sub in ("tif", "depth_png", "depth_tif", "depth_pgm"):
                (tmp / sub).mkdir(parents=True)
            frames = sorted(glob.glob(str(SCENE / FRAMES)))
            t0 = time.perf_counter()
            for i, f in enumerate(frames):
                stem = Path(f).stem
                write_format_frame(np, tmp / "tif" / f"{stem}.tif", read_png(f), FORMAT_TIFF_KINDS[i % 6])
                mm = np.clip(np.round(np.load(f[: -len(".png")] + "_depth.npy") * 1000), 0, 65535).astype(np.uint16)
                write_png(tmp / "depth_png" / f"{stem}_depth.png", mm)
                write_tiff(tmp / "depth_tif" / f"{stem}_depth.tif", mm, "I;16B" if i % 2 else "I;16")
                write_pnm(tmp / "depth_pgm" / f"{stem}_depth.pgm", mm, "I;16")
            rec["write_seconds"] = time.perf_counter() - t0
            png_glob, tif_glob = str(SCENE / FRAMES), str(tmp / "tif" / "frame_*.tif")
            rec["tiff_kinds"] = {k: sum(1 for i in range(len(frames)) if FORMAT_TIFF_KINDS[i % 6] == k)
                                 for k in FORMAT_TIFF_KINDS}
            t0 = time.perf_counter()
            want_canvas = canvas_digest(decode_to_canvas(frames, short_size=480))
            rec["canvases_equal_to_png"] = canvas_digest(decode_to_canvas(sorted(glob.glob(tif_glob)),
                                                                          short_size=480)) == want_canvas
            depth_equal = []
            for f in frames:
                stem = Path(f).stem
                ref = load_depth_file(tmp / "depth_png" / f"{stem}_depth.png")
                depth_equal.append(all(np.array_equal(load_depth_file(tmp / sub / f"{stem}_depth.{ext}"), ref)
                                       for sub, ext in (("depth_tif", "tif"), ("depth_pgm", "pgm"))))
            rec["depth_equal_to_png"] = f"{sum(depth_equal)}/{len(depth_equal)}"
            rec["decode_seconds"] = time.perf_counter() - t0
            require(rec["canvases_equal_to_png"], "the TIFF glob's canvases differ from the PNG glob's")
            require(all(depth_equal), f"the TIFF and PGM depth maps differ from the PNGs: {rec['depth_equal_to_png']}")

            # the register CLI (K1) on each glob with the shipped head; the
            # PNG glob's poses are phase slice's run where it ran
            format_launches = {}
            poses = {"png": slice_poses} if slice_poses is not None else {}
            for name, pattern in (("png", png_glob), ("tiff", tif_glob)):
                if name in poses:
                    format_launches[f"register_{name}"] = "phase slice"
                    continue
                net = tmp / f"head_{name}.pt"
                shutil.copy(HEAD, net)
                argv = [pattern, str(net), "--encoder_path", str(ENCODER), "--use_external_focal_length", str(FOCAL),
                        "--session", name, "--device", DEVICE]
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                require(register_cli.main(argv) == 0, f"register_cli failed on the {name} glob")
                torch.cuda.synchronize()
                format_launches[f"register_{name}"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                                       "seconds": time.perf_counter() - t0}
                poses[name] = [ln.split()[1:] for ln in (tmp / f"poses_{name}.txt").read_text().splitlines()]
            rec["register_poses_equal"] = poses["png"] == poses["tiff"] and len(poses["tiff"]) == N_FRAMES
            require(rec["register_poses_equal"], "register_cli gives other poses on the TIFF glob")
            require(format_launches["register_tiff"]["fwd"] > 0 and format_launches["register_tiff"]["bwd"] == 0,
                    f"register_cli on the TIFF glob: launches {format_launches['register_tiff']}")

            # a short train CLI run (K1, K2) on each glob, depth from the PNGs
            # and from the TIFFs, one seed: the same map
            maps = {}
            for name, pattern, depth_glob in (("png", png_glob, tmp / "depth_png" / "*_depth.png"),
                                              ("tiff", tif_glob, tmp / "depth_tif" / "*_depth.tif")):
                net = tmp / f"map_{name}.pt"
                argv = [pattern, str(net), "--pose_files", str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                        "--depth_files", str(depth_glob), "--use_external_focal_length", str(FOCAL),
                        "--encoder_path", str(ENCODER), "--device", DEVICE, *FORMAT_TRAIN]
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                result = train_ace_cli.main(argv)
                torch.cuda.synchronize()
                format_launches[f"train_{name}"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                                    "steps": result["steps"], "seconds": time.perf_counter() - t0}
                maps[name] = tree_leaves(torch_io.load_head(net, "cpu")[1])
            rec["train_map_bit_equal"] = len(maps["png"]) == len(maps["tiff"]) and all(
                torch.equal(a, b) for a, b in zip(maps["png"], maps["tiff"]))
            rec["launches"] = format_launches
            require(rec["train_map_bit_equal"], "train_ace_cli gives another map on the TIFF glob")
            t = format_launches["train_tiff"]
            require(t["bwd"] == t["steps"] and t["fwd"] >= t["steps"] > 0,
                    f"train_ace_cli on the TIFF glob: launches {t}")

            # WebP: the committed fixtures against PIL's digests; the 60
            # frames as lossless WebP (the port's encoder; the gray frames
            # as RGB, whose float32 luma at the frames' own size rounds back
            # to the gray level): the PNG glob's canvases, and the register
            # CLI (K1) the PNG glob's poses
            t0 = time.perf_counter()
            wdigests = json.loads((WEBP_FIXTURES / "pil_digests.json").read_text())["files"]
            wchecks = {}
            for name, want in sorted(wdigests.items()):
                path = WEBP_FIXTURES / name
                r = twebp.read_webp(path)
                width, height, mode = tformats.header(path)
                wchecks[name] = (r.mode == mode == want["mode"] and [width, height] == want["size"]
                                 and list(r.pixels.shape) == want["shape"] and array_digest(r.pixels) == want["sha256"])
            wbad = sorted(n for n, ok in wchecks.items() if not ok)
            rec["webp_library"] = build.host_target(twebp.SOURCE).name
            rec["webp_build_seconds"] = build.build_info[twebp.SOURCE.stem]["seconds"]
            rec["webp_fixtures_equal_to_pil"] = f"{len(wchecks) - len(wbad)}/{len(wchecks)}"
            require(wchecks and not wbad, f"WebP fixtures not decoded as PIL decodes them: {wbad}")
            lossy = WEBP_FIXTURES / WEBP_PHOTO
            read_s = []
            for _ in range(5):
                t1 = time.perf_counter()
                img = twebp.read_webp(lossy).pixels
                read_s.append(time.perf_counter() - t1)
            rec["webp_lossy_photo"] = {"file": WEBP_PHOTO, "hw": list(img.shape[:2]), "bytes": lossy.stat().st_size,
                                       "read_webp_ms": statistics.median(read_s) * 1e3,
                                       "read_webp_mp_per_s": img.shape[0] * img.shape[1] / 1e6 / statistics.median(read_s)}
            (tmp / "webp").mkdir()
            for f in frames:
                img = read_png(f)
                twebp.write_webp(tmp / "webp" / f"{Path(f).stem}.webp", np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img)
            webp_glob = str(tmp / "webp" / "frame_*.webp")
            rec["webp_canvases_equal_to_png"] = canvas_digest(decode_to_canvas(sorted(glob.glob(webp_glob)),
                                                                               short_size=480)) == want_canvas
            require(rec["webp_canvases_equal_to_png"], "the lossless WebP glob's canvases differ from the PNG glob's")
            net = tmp / "head_webp.pt"
            shutil.copy(HEAD, net)
            argv = [webp_glob, str(net), "--encoder_path", str(ENCODER), "--use_external_focal_length", str(FOCAL),
                    "--session", "webp", "--device", DEVICE]
            fh.LAUNCHES = fh.LAUNCHES_BWD = 0
            t1 = time.perf_counter()
            require(register_cli.main(argv) == 0, "register_cli failed on the WebP glob")
            torch.cuda.synchronize()
            format_launches["register_webp"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                                "seconds": time.perf_counter() - t1}
            webp_poses = [ln.split()[1:] for ln in (tmp / "poses_webp.txt").read_text().splitlines()]
            rec["webp_register_poses_equal"] = webp_poses == poses["png"] and len(webp_poses) == N_FRAMES
            require(rec["webp_register_poses_equal"], "register_cli gives other poses on the WebP glob")
            require(format_launches["register_webp"]["fwd"] > 0 and format_launches["register_webp"]["bwd"] == 0,
                    f"register_cli on the WebP glob: launches {format_launches['register_webp']}")
            webp_seconds = time.perf_counter() - t0

            # GIF: (a) the committed fixtures against PIL's digests (the
            # refused ones must raise); (b) their canvases and depth maps
            # against the JAX package's; (c) the BMP and PPM kinds read since
            # are among the fixtures of FORMAT_FIXTURES above; (d) the 60
            # frames as interlaced P GIFs of a permuted grey palette: the PNG
            # glob's canvases; (e) the register CLI (K1) the PNG glob's poses
            t0 = time.perf_counter()
            gdigests = json.loads((GIF_FIXTURES / "pil_digests.json").read_text())
            gchecks = {}
            for name, want in sorted(gdigests["files"].items()):
                path = GIF_FIXTURES / name
                if want.get("raises"):
                    try:
                        tgif.read_gif(path)
                        gchecks[name] = False
                    except ValueError as e:
                        gchecks[name] = str(path) in str(e)
                    continue
                r = tgif.read_gif(path)
                width, height, mode, transparency = tgif.gif_header(path)
                gchecks[name] = (r.mode == mode == want["mode"] and [width, height] == want["size"]
                                 and list(r.pixels.shape) == want["shape"] and array_digest(r.pixels) == want["sha256"]
                                 and palette_digest(np, r.palette) == want["palette"]
                                 and r.transparency == transparency == want["transparency"]
                                 and array_digest(read_rgb(path)) == want["rgb_sha256"])
            gbad = sorted(n for n, ok in gchecks.items() if not ok)
            rec["gif_library"] = build.host_target(tgif.SOURCE).name
            rec["gif_build_seconds"] = build.build_info[tgif.SOURCE.stem]["seconds"]
            rec["gif_fixtures_equal_to_pil"] = f"{len(gchecks) - len(gbad)}/{len(gchecks)}"
            require(gchecks and not gbad, f"GIF fixtures not decoded as PIL decodes them: {gbad}")
            gpaths = sorted(str(GIF_FIXTURES / n) for n, want in gdigests["files"].items() if not want.get("raises"))
            gcanvas = []
            for entry in gdigests["canvas"]:
                hw = None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
                out = decode_to_canvas(gpaths, short_size=entry["short_size"], canvas_hw=hw, num_workers=4)
                gcanvas.append({"short_size": entry["short_size"], "canvas_hw": entry["canvas_hw"],
                                "equal_to_jax": canvas_digest(out) == entry["sha256"]})
            gdepth = {n: array_digest(load_depth_file(GIF_FIXTURES / n)) == want for n, want in gdigests["depth"].items()}
            rec["gif_canvas"] = gcanvas
            rec["gif_depth_equal_to_jax"] = f"{sum(gdepth.values())}/{len(gdepth)}"
            require(len(gcanvas) == 2 and all(c["equal_to_jax"] for c in gcanvas) and gdepth and all(gdepth.values()),
                    f"the GIF fixtures' canvases or depth maps are not the JAX package's: {gcanvas}, {gdepth}")
            (tmp / "gif").mkdir()
            for f in frames:
                gray = read_png(f)
                require(gray.ndim == 2, f"{f} is not a gray frame")
                idx, pal = gif_grey_frame(np, gray)
                tgif.write_gif(tmp / "gif" / f"{Path(f).stem}.gif", idx, "P", pal)
            gif_glob = str(tmp / "gif" / "frame_*.gif")
            gif_modes = {tformats.pil_mode(p_) for p_ in glob.glob(gif_glob)}
            rec["gif_canvases_equal_to_png"] = gif_modes == {"P"} and canvas_digest(
                decode_to_canvas(sorted(glob.glob(gif_glob)), short_size=480)) == want_canvas
            require(rec["gif_canvases_equal_to_png"], f"the GIF glob's canvases differ from the PNG glob's ({gif_modes})")
            net = tmp / "head_gif.pt"
            shutil.copy(HEAD, net)
            argv = [gif_glob, str(net), "--encoder_path", str(ENCODER), "--use_external_focal_length", str(FOCAL),
                    "--session", "gif", "--device", DEVICE]
            fh.LAUNCHES = fh.LAUNCHES_BWD = 0
            t1 = time.perf_counter()
            require(register_cli.main(argv) == 0, "register_cli failed on the GIF glob")
            torch.cuda.synchronize()
            format_launches["register_gif"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                               "seconds": time.perf_counter() - t1}
            gif_poses = [ln.split()[1:] for ln in (tmp / "poses_gif.txt").read_text().splitlines()]
            rec["gif_register_poses_equal"] = gif_poses == poses["png"] and len(gif_poses) == N_FRAMES
            require(rec["gif_register_poses_equal"], "register_cli gives other poses on the GIF glob")
            g = format_launches["register_gif"]
            require(g["fwd"] == format_launches["register_tiff"]["fwd"] > 0 and g["bwd"] == 0,
                    f"register_cli on the GIF glob: launches {g} (the TIFF glob's {format_launches['register_tiff']})")
            gif_seconds = time.perf_counter() - t0

            # JPEG 2000: (a) the committed fixtures against PIL's digests
            # (the refused ones must raise); (b) their canvases and depth
            # maps against the JAX package's; (c) the 60 frames as lossless
            # JPEG 2000 (write_jpeg2000, JP2 boxes and bare codestreams in
            # turn): the PNG glob's canvases; (d) the register CLI (K1) the
            # PNG glob's poses; (e) read_jpeg2000 on the committed lossy
            # photo of JPEG_PHOTO_HW, against PIL's digest
            t0 = time.perf_counter()
            jdigests = json.loads((JPEG2000_FIXTURES / "pil_digests.json").read_text())
            jchecks = {}
            for name, want in sorted(jdigests["files"].items()):
                path = JPEG2000_FIXTURES / name
                if want.get("raises"):
                    try:
                        read_image(path)
                        jchecks[name] = False
                    except ValueError as e:
                        jchecks[name] = str(path) in str(e)
                    continue
                img = read_image(path)
                arr = pil_array(img)
                jchecks[name] = (tformats.pil_mode(path) == want["mode"]
                                 and list(tformats.image_size(path)) == want["size"]
                                 and arr.dtype.str == want["dtype"] and list(arr.shape) == want["shape"]
                                 and array_digest(arr) == want["sha256"]
                                 and palette_digest(np, getattr(img, "palette", None)) == want["palette"]
                                 and array_digest(read_rgb(path)) == want["rgb_sha256"])
            jbad = sorted(n for n, ok in jchecks.items() if not ok)
            rec["jpeg2000_library"] = build.host_target(tj2k.SOURCE).name
            rec["jpeg2000_build_seconds"] = build.build_info[tj2k.SOURCE.stem]["seconds"]
            rec["jpeg2000_fixtures_equal_to_pil"] = f"{len(jchecks) - len(jbad)}/{len(jchecks)}"
            require(jchecks and not jbad, f"JPEG 2000 fixtures not decoded as PIL decodes them: {jbad}")
            jpaths = sorted(str(JPEG2000_FIXTURES / n) for n, want in jdigests["files"].items() if not want.get("raises"))
            jcanvas = []
            for entry in jdigests["canvas"]:
                hw = None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
                out = decode_to_canvas(jpaths, short_size=entry["short_size"], canvas_hw=hw, num_workers=4)
                jcanvas.append({"short_size": entry["short_size"], "canvas_hw": entry["canvas_hw"],
                                "equal_to_jax": canvas_digest(out) == entry["sha256"]})
            jdepth = {n: array_digest(load_depth_file(JPEG2000_FIXTURES / n)) == want
                      for n, want in jdigests["depth"].items()}
            rec["jpeg2000_canvas"] = jcanvas
            rec["jpeg2000_depth_equal_to_jax"] = f"{sum(jdepth.values())}/{len(jdepth)}"
            require(len(jcanvas) == 2 and all(c["equal_to_jax"] for c in jcanvas) and jdepth and all(jdepth.values()),
                    f"the JPEG 2000 fixtures' canvases or depth maps are not the JAX package's: {jcanvas}, {jdepth}")
            (tmp / "jpeg2000").mkdir()

            def make_j2k(i_f):
                i, f = i_f
                gray = read_png(f)
                t1 = time.perf_counter()
                tj2k.write_jpeg2000(tmp / "jpeg2000" / f"{Path(f).stem}.{('jp2', 'j2k')[i % 2]}", gray, "L")
                return time.perf_counter() - t1

            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                write_s = list(ex.map(make_j2k, enumerate(frames)))
            j2k_files = sorted(glob.glob(str(tmp / "jpeg2000" / "frame_*")))
            j2k_modes = {tformats.pil_mode(p_) for p_ in j2k_files}
            rec["jpeg2000_glob"] = {"frames": len(j2k_files), "mean_bytes": statistics.mean(
                Path(p_).stat().st_size for p_ in j2k_files), "write_ms": statistics.median(write_s) * 1e3}
            rec["jpeg2000_canvases_equal_to_png"] = j2k_modes == {"L"} and len(j2k_files) == N_FRAMES and canvas_digest(
                decode_to_canvas(j2k_files, short_size=480)) == want_canvas
            require(rec["jpeg2000_canvases_equal_to_png"],
                    f"the JPEG 2000 glob's canvases differ from the PNG glob's ({j2k_modes})")
            net = tmp / "head_jpeg2000.pt"
            shutil.copy(HEAD, net)
            argv = [str(tmp / "jpeg2000" / "frame_*"), str(net), "--encoder_path", str(ENCODER),
                    "--use_external_focal_length", str(FOCAL), "--session", "jpeg2000", "--device", DEVICE]
            fh.LAUNCHES = fh.LAUNCHES_BWD = 0
            t1 = time.perf_counter()
            require(register_cli.main(argv) == 0, "register_cli failed on the JPEG 2000 glob")
            torch.cuda.synchronize()
            format_launches["register_jpeg2000"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                                    "seconds": time.perf_counter() - t1}
            j2k_poses = [ln.split()[1:] for ln in (tmp / "poses_jpeg2000.txt").read_text().splitlines()]
            rec["jpeg2000_register_poses_equal"] = j2k_poses == poses["png"] and len(j2k_poses) == N_FRAMES
            require(rec["jpeg2000_register_poses_equal"], "register_cli gives other poses on the JPEG 2000 glob")
            j = format_launches["register_jpeg2000"]
            require(j["fwd"] == format_launches["register_tiff"]["fwd"] > 0 and j["bwd"] == 0,
                    f"register_cli on the JPEG 2000 glob: launches {j} (the TIFF glob's {format_launches['register_tiff']})")
            t1 = time.perf_counter()
            r = tj2k.read_jpeg2000(JPEG2000_PHOTO)
            read_s = time.perf_counter() - t1
            mp = r.pixels.shape[0] * r.pixels.shape[1] / 1e6
            rec["jpeg2000_photo"] = {"bytes": JPEG2000_PHOTO.stat().st_size, "hw": list(r.pixels.shape[:2]),
                                     "read_jpeg2000_ms": read_s * 1e3, "read_jpeg2000_mp_per_s": mp / read_s,
                                     "equal_to_pil": r.mode == jdigests["photo"]["mode"]
                                     and array_digest(r.pixels) == jdigests["photo"]["sha256"]}
            del r
            require(rec["jpeg2000_photo"]["equal_to_pil"], "the JPEG 2000 photo does not decode to PIL's pixels")
            rec["jpeg2000_seconds"] = time.perf_counter() - t0

            # TGA, SGI, PCX, DCX, Sun raster and QOI: (a) the committed
            # fixtures against PIL's digests (the refused ones must raise,
            # their header answering PIL's mode and size where PIL opens
            # them); (b) their canvases and depth maps against the JAX
            # package's; (c) the 60 frames as gray RASTER_GLOB_KINDS in
            # turn (the port's writers): the PNG glob's canvases; (d) the
            # register CLI (K1) the PNG glob's poses
            t0 = time.perf_counter()
            rdigests = json.loads((RASTER_FIXTURES / "pil_digests.json").read_text())
            rchecks = {}
            for name, want in sorted(rdigests["files"].items()):
                path = RASTER_FIXTURES / name
                try:
                    header_ok = [*tformats.header(path)] == [*want["size"], want["mode"]]
                except ValueError:
                    header_ok = False
                if want.get("raises"):
                    try:
                        read_image(path)
                        rchecks[name] = False
                    except ValueError as e:
                        rchecks[name] = str(path) in str(e) and header_ok
                    continue
                img = read_image(path)
                arr = pil_array(img)
                rchecks[name] = (header_ok and arr.dtype.str == want["dtype"] and list(arr.shape) == want["shape"]
                                 and array_digest(arr) == want["sha256"]
                                 and palette_digest(np, getattr(img, "palette", None)) == want["palette"]
                                 and array_digest(read_rgb(path)) == want["rgb_sha256"])
            rbad = sorted(n for n, ok in rchecks.items() if not ok)
            rec["raster_library"] = build.host_target(traster.SOURCE).name
            rec["raster_build_seconds"] = build.build_info[traster.SOURCE.stem]["seconds"]
            rec["raster_fixtures_equal_to_pil"] = f"{len(rchecks) - len(rbad)}/{len(rchecks)}"
            require(rchecks and not rbad, f"raster fixtures not decoded as PIL decodes them: {rbad}")
            rpaths = sorted(str(RASTER_FIXTURES / n) for n, want in rdigests["files"].items() if not want.get("raises"))
            rcanvas = []
            for entry in rdigests["canvas"]:
                hw = None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
                out = decode_to_canvas(rpaths, short_size=entry["short_size"], canvas_hw=hw, num_workers=4)
                rcanvas.append({"short_size": entry["short_size"], "canvas_hw": entry["canvas_hw"],
                                "equal_to_jax": canvas_digest(out) == entry["sha256"]})
            rdepth = {n: array_digest(load_depth_file(RASTER_FIXTURES / n)) == want
                      for n, want in rdigests["depth"].items()}
            rec["raster_canvas"] = rcanvas
            rec["raster_depth_equal_to_jax"] = f"{sum(rdepth.values())}/{len(rdepth)}"
            require(len(rcanvas) == 2 and all(c["equal_to_jax"] for c in rcanvas) and rdepth and all(rdepth.values()),
                    f"the raster fixtures' canvases or depth maps are not the JAX package's: {rcanvas}, {rdepth}")
            (tmp / "raster").mkdir()

            def write_raster(dst: Path, img, kind_: str):
                if kind_.startswith("tga"):
                    ttga.write_tga(dst.with_suffix(".tga"), img, "RGB" if img.ndim == 3 else "L",
                                   compression="tga_rle" if kind_ == "tga_rle" else None)
                elif kind_ == "sgi":
                    tsgi.write_sgi(dst.with_suffix(".sgi"), img, "RGB" if img.ndim == 3 else "L")
                elif kind_ == "pcx":
                    tpcx.write_pcx(dst.with_suffix(".pcx"), img, "RGB" if img.ndim == 3 else "L")
                else:
                    tqoi.write_qoi(dst.with_suffix(".qoi"), img, "RGB")

            def make_raster(i_f):
                i, f = i_f
                gray = read_png(f)
                t1 = time.perf_counter()
                write_raster(tmp / "raster" / Path(f).stem, gray, RASTER_GLOB_KINDS[i % len(RASTER_GLOB_KINDS)])
                return time.perf_counter() - t1

            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                write_s = list(ex.map(make_raster, enumerate(frames)))
            raster_files = sorted(glob.glob(str(tmp / "raster" / "frame_*")))
            raster_kinds = sorted({tformats.file_kind(p_) for p_ in raster_files})
            raster_modes = {tformats.pil_mode(p_) for p_ in raster_files}
            rec["raster_glob"] = {"frames": len(raster_files), "kinds": raster_kinds,
                                  "mean_bytes": statistics.mean(Path(p_).stat().st_size for p_ in raster_files),
                                  "write_ms": statistics.median(write_s) * 1e3}
            rec["raster_canvases_equal_to_png"] = (raster_modes == {"L"} and len(raster_files) == N_FRAMES
                                                   and raster_kinds == ["pcx", "sgi", "tga"] and canvas_digest(
                                                       decode_to_canvas(raster_files, short_size=480)) == want_canvas)
            require(rec["raster_canvases_equal_to_png"],
                    f"the raster glob's canvases differ from the PNG glob's ({raster_kinds}, {raster_modes})")
            net = tmp / "head_raster.pt"
            shutil.copy(HEAD, net)
            argv = [str(tmp / "raster" / "frame_*"), str(net), "--encoder_path", str(ENCODER),
                    "--use_external_focal_length", str(FOCAL), "--session", "raster", "--device", DEVICE]
            fh.LAUNCHES = fh.LAUNCHES_BWD = 0
            t1 = time.perf_counter()
            require(register_cli.main(argv) == 0, "register_cli failed on the raster glob")
            torch.cuda.synchronize()
            format_launches["register_raster"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                                  "seconds": time.perf_counter() - t1}
            raster_poses = [ln.split()[1:] for ln in (tmp / "poses_raster.txt").read_text().splitlines()]
            rec["raster_register_poses_equal"] = raster_poses == poses["png"] and len(raster_poses) == N_FRAMES
            require(rec["raster_register_poses_equal"], "register_cli gives other poses on the raster glob")
            r_ = format_launches["register_raster"]
            require(r_["fwd"] == format_launches["register_tiff"]["fwd"] > 0 and r_["bwd"] == 0,
                    f"register_cli on the raster glob: launches {r_} (the TIFF glob's {format_launches['register_tiff']})")
            raster_seconds = time.perf_counter() - t0

            # (c) photo-size frames: the chesslike frames enlarged to
            # JPEG_PHOTO_HW and tinted, as each of FORMAT_PHOTO_KINDS, as
            # lossless WebP, and as P GIFs whose palette gives the same
            # colours (the tint of each grey level)
            photo = tmp / "photo"
            srcs = frames[:: N_FRAMES // FORMAT_PHOTO_FRAMES][:FORMAT_PHOTO_FRAMES]

            def make_photo(i_f):
                i, f = i_f
                gray = pil_resize_bilinear(read_png(f), *JPEG_PHOTO_HW)
                big = tinted(np, gray)
                for k in FORMAT_PHOTO_KINDS:
                    write_format_frame(np, photo / k / f"photo_{i:02d}.tif", big, k)
                t0 = time.perf_counter()
                twebp.write_webp(photo / "webp" / f"photo_{i:02d}.webp", big)
                return gray, time.perf_counter() - t0

            def make_gif(i_gray):
                i, gray = i_gray
                t0 = time.perf_counter()
                idx, pal = gif_grey_frame(np, gray, tint=True)
                tgif.write_gif(photo / "gif" / f"photo_{i:02d}.gif", idx, "P", pal)
                return time.perf_counter() - t0

            for k in FORMAT_PHOTO_KINDS + ("webp", "gif"):
                (photo / k).mkdir(parents=True)
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=FORMAT_PHOTO_FRAMES) as ex:
                made = list(ex.map(make_photo, enumerate(srcs)))
                t1 = time.perf_counter()
                gif_write_s = list(ex.map(make_gif, enumerate(g_ for g_, _ in made)))
            mp = JPEG_PHOTO_HW[0] * JPEG_PHOTO_HW[1] / 1e6
            rec["photo"] = {"frames": len(srcs), "hw": list(JPEG_PHOTO_HW), "megapixels": mp,
                            "make_seconds": t1 - t0, "make_gif_seconds": time.perf_counter() - t1,
                            "write_webp_ms": statistics.median(w_ for _, w_ in made) * 1e3,
                            "write_gif_ms": statistics.median(gif_write_s) * 1e3}
            raster_photo = tinted(np, made[0][0])
            del made
            gif_seconds += rec["photo"]["make_gif_seconds"]
            for k in FORMAT_PHOTO_KINDS:
                files = sorted(str(p_) for p_ in (photo / k).glob("*.tif"))
                read_s = []
                for f in files[:3]:
                    t0 = time.perf_counter()
                    img = ttiff.read_tiff(f).pixels
                    read_s.append(time.perf_counter() - t0)
                require(img.shape == (*JPEG_PHOTO_HW, 3), f"a {k} photo frame decodes to {img.shape}")
                del img
                rec["photo"][k] = {"mean_bytes": statistics.mean(Path(f).stat().st_size for f in files),
                                   "read_tiff_ms": statistics.median(read_s) * 1e3,
                                   "read_tiff_mp_per_s": mp / statistics.median(read_s)}
            t0 = time.perf_counter()
            files = sorted(str(p_) for p_ in (photo / "webp").glob("*.webp"))
            read_s = []
            for f in files[:3]:
                t1 = time.perf_counter()
                img = twebp.read_webp(f).pixels
                read_s.append(time.perf_counter() - t1)
            require(img.shape == (*JPEG_PHOTO_HW, 3), f"a lossless WebP photo frame decodes to {img.shape}")
            del img
            rec["photo"]["webp"] = {"mean_bytes": statistics.mean(Path(f).stat().st_size for f in files),
                                    "read_webp_ms": statistics.median(read_s) * 1e3,
                                    "read_webp_mp_per_s": mp / statistics.median(read_s)}
            webp_seconds += time.perf_counter() - t0
            t0 = time.perf_counter()
            files = sorted(str(p_) for p_ in (photo / "gif").glob("*.gif"))
            read_s = []
            for f in files[:3]:
                t1 = time.perf_counter()
                r = tgif.read_gif(f)
                read_s.append(time.perf_counter() - t1)
            require(r.mode == "P" and r.pixels.shape == JPEG_PHOTO_HW, f"a GIF photo frame decodes to {r.mode} {r.pixels.shape}")
            del r
            rec["photo"]["gif"] = {"mean_bytes": statistics.mean(Path(f).stat().st_size for f in files),
                                   "read_gif_ms": statistics.median(read_s) * 1e3,
                                   "read_gif_mp_per_s": mp / statistics.median(read_s)}
            gif_seconds += time.perf_counter() - t0
            # decode_to_canvas of each kind with each worker count, in turn
            # in one fresh process (its import is paid once)
            suffix = {"webp": "*.webp", "gif": "*.gif"}
            pairs = [(k, w) for k in FORMAT_PHOTO_KINDS + ("webp", "gif") for w in JPEG_WORKERS]
            runs = photo_decode_runs(ROOT, [(str(photo / k / suffix.get(k, "*.tif")), w) for k, w in pairs])
            for (k, w), r in zip(pairs, runs):
                r.update(ms_per_image=r["seconds"] / r["frames"] * 1e3, mp_per_s=r["frames"] * mp / r["seconds"])
                rec["photo"][k].setdefault("decode_to_canvas", {})[str(w)] = r
            require(all(r["frames"] == FORMAT_PHOTO_FRAMES for r in runs), f"decode_to_canvas of the photo frames: {runs}")
            require(len({r["sha256"] for r in runs}) == 1,
                    "the photo frames' canvases differ between kinds or worker counts")
            webp_seconds += sum(r["seconds"] for (k, _), r in zip(pairs, runs) if k == "webp")
            gif_seconds += sum(r["seconds"] for (k, _), r in zip(pairs, runs) if k == "gif")
            rec["webp_seconds"] = webp_seconds
            rec["gif_seconds"] = gif_seconds

            # the raster readers at photo size: one tinted enlargement of
            # JPEG_PHOTO_HW as each of RASTER_PHOTO_KINDS (the port's
            # writers), read back whole and timed (median of 3)
            t0 = time.perf_counter()
            readers = {"tga_rle": ttga.read_tga, "sgi": tsgi.read_sgi, "pcx": tpcx.read_pcx, "qoi": tqoi.read_qoi}
            (photo / "raster").mkdir(parents=True)
            for k in RASTER_PHOTO_KINDS:
                t1 = time.perf_counter()
                write_raster(photo / "raster" / f"photo_{k}", raster_photo, k)
                write_ms = (time.perf_counter() - t1) * 1e3
                path = next((photo / "raster").glob(f"photo_{k}.*"))
                read_s = []
                for _ in range(3):
                    t1 = time.perf_counter()
                    r = readers[k](path)
                    read_s.append(time.perf_counter() - t1)
                equal = r.mode == "RGB" and np.array_equal(r.pixels, raster_photo)
                del r
                rec["photo"][k] = {"bytes": path.stat().st_size, "write_ms": write_ms,
                                   f"read_{k.split('_')[0]}_ms": statistics.median(read_s) * 1e3,
                                   f"read_{k.split('_')[0]}_mp_per_s": mp / statistics.median(read_s),
                                   "equal_to_source": equal}
                require(equal, f"the {k} photo frame does not read back to its pixels")
            shutil.rmtree(photo)
            del raster_photo
            rec["raster_seconds"] = raster_seconds + time.perf_counter() - t0

    groups = parallel_groups(phases) if handoff is None else []
    if groups:
        with phase("parallel", {"groups": groups}):
            handed = run_groups(groups, work)
        map_launches, lc_launches, lc_shapes = (handed.get(k) for k in ("map_launches", "lc_launches", "lc_shapes"))
        pipe_launches, bare_launches, render_launches = (handed.get(k) for k in ("pipe_launches", "bare_launches",
                                                                                 "render_launches"))
        spill_launches, mesh_launches, pretrain_launches = (handed.get(k) for k in ("spill_launches", "mesh_launches",
                                                                                    "pretrain_launches"))
        phases = [p for p in phases if not any(p in g for g in groups)]

    if "mapping" in phases:
        with phase("mapping", {}) as rec:
            gts = {f: np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in sorted(glob.glob(str(SCENE / FRAMES)))}

            def pose_errors(entries):
                r = [rot_err_deg(np, e.pose_c2w[:3, :3], gts[e.rgb_file][:3, :3]) for e in entries]
                t = [float(np.linalg.norm(e.pose_c2w[:3, 3] - gts[e.rgb_file][:3, 3])) for e in entries]
                return r, t

            map_launches = {"fwd": 0, "bwd": 0}
            rec.update(kind=kind, nvidia_smi=smi)
            with tempfile.TemporaryDirectory() as tmp:
                for name, extra in MAPPING_RUNS.items():
                    net = Path(tmp) / f"{name}.pt"
                    argv = [str(SCENE / FRAMES), str(net), "--pose_files", str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                            "--use_external_focal_length", str(FOCAL), "--encoder_path", str(ENCODER),
                            "--device", DEVICE, *extra]
                    fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                    t0 = time.perf_counter()
                    result = train_ace_cli.main(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    fwd, bwd = fh.LAUNCHES, fh.LAUNCHES_BWD
                    map_launches["fwd"] += fwd
                    map_launches["bwd"] += bwd
                    prelim_path = Path(tmp) / f"poses_{name}_preliminary.txt"
                    prelim = prelim_path.read_text().splitlines()
                    prelim_entries = read_pose_file(prelim_path)
                    prelim_r, prelim_t = pose_errors(prelim_entries)
                    # after a Sim(3) alignment onto the shipped poses, since
                    # pose refinement moves the map's frame as a whole
                    aligned = evaluate_poses(prelim_entries, [gts[f] for f in sorted(gts)])
                    log = result["log"]
                    steps = result["steps"]
                    rec[name] = {
                        "cli_seconds": wall, "fill_seconds": result["fill_time"], "train_seconds": result["train_time"],
                        "steps": steps, "iterations": result["iterations"], "steps_per_s": steps / result["train_time"],
                        "buffer_rows": result["buffer_rows"], "fused_head_fwd_launches": fwd,
                        "fused_head_bwd_launches": bwd, "first_log": log[0] if log else None,
                        "last_log": log[-1] if log else None, "log": log, "focal_refined": result["focal_orig"],
                        "prelim_median_rot_deg": statistics.median(prelim_r),
                        "prelim_median_trans_mm": statistics.median(prelim_t) * 1e3,
                        "aligned_within_5cm_5deg_pct": aligned.accuracy,
                        "aligned_median_rot_deg": aligned.median_rot_deg,
                        "aligned_median_trans_cm": aligned.median_trans_cm, "aligned": aligned.aligned,
                    }
                    require(bwd == steps, f"{name}: K2 launched {bwd} times for {steps} steps")
                    require(fwd >= steps, f"{name}: K1 launched {fwd} times for {steps} steps")
                    require(len(log) >= 2 and all(np.isfinite(e["loss"]) for e in log), f"{name}: missing or non-finite losses")
                    require(log[-1]["loss"] < log[0]["loss"], f"{name}: loss did not fall: {log[0]['loss']} -> {log[-1]['loss']}")
                    require(len(prelim) == N_FRAMES and all(len(ln.split()) == 10 for ln in prelim),
                            f"{name}: preliminary pose file is not {N_FRAMES} lines of 10 tokens")

                map_head = torch_io.load_head(Path(tmp) / "fixed_poses.pt", DEVICE)  # for phase loopclose
                # relocalize the 60 frames against the map trained on their poses
                argv = [str(SCENE / FRAMES), str(Path(tmp) / "fixed_poses.pt"), "--encoder_path", str(ENCODER),
                        "--use_external_focal_length", str(FOCAL), "--session", "reloc", "--device", DEVICE]
                t0 = time.perf_counter()
                require(register_cli.main(argv) == 0, "register_cli failed on the trained map")
                entries = read_pose_file(Path(tmp) / "poses_reloc.txt")
                rec["reloc_seconds"] = time.perf_counter() - t0
            r_err, t_err = pose_errors(entries)
            good = sum(1 for a, t in zip(r_err, t_err) if a <= 5.0 and t <= 0.05)
            rec.update(reloc_frames=len(entries), reloc_within_5cm_5deg=good,
                       reloc_median_rot_deg=statistics.median(r_err), reloc_median_trans_mm=statistics.median(t_err) * 1e3,
                       reloc_inliers_median=statistics.median(e.confidence for e in entries))
            require(len(entries) == N_FRAMES, f"registered {len(entries)} of {N_FRAMES} frames")
            require(good >= RELOC_SHARE * N_FRAMES,
                    f"the trained map relocalizes {good} of {N_FRAMES} frames within 5 cm / 5 deg")

    if "loopclose" in phases:
        with phase("loopclose", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi)
            gt_files = sorted(glob.glob(str(SCENE / FRAMES)))
            if map_head is None:
                with tempfile.TemporaryDirectory() as tmp:
                    train_ace_cli.main([str(SCENE / FRAMES), str(Path(tmp) / "map.pt"), "--pose_files",
                                        str(SCENE / FRAMES.replace(".png", "_pose.txt")), "--use_external_focal_length",
                                        str(FOCAL), "--encoder_path", str(ENCODER), "--device", DEVICE, *LOOPCLOSE_MAP])
                    map_head = torch_io.load_head(Path(tmp) / "map.pt", DEVICE)
                rec["map"] = "LOOPCLOSE_MAP, trained in this phase"
            else:
                rec["map"] = "phase mapping, run fixed_poses"
            head_cfg_m, head_m = map_head
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            scene = load_scene(str(SCENE / FRAMES), external_focal_length=FOCAL)
            gts = {f: np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in gt_files}
            entries = [PoseFileEntry(f, np.linalg.inv(gts[f]), FOCAL, 2000.0) for f in scene.rgb_files]
            # every sub-stage timed (the card synchronized around each call)
            # and the coordinate maps and features kept for the CPU check
            seconds, calls, kept, pairs_fit = {}, {}, [], []
            names = {"coords_feats": "coords_feats_chunk", "pairwise_fits": "pairwise_sim3",
                     "graph_solve": "solve_pose_graph", "subpix": "refine_matches_photometric",
                     "ba": "refine_poses_ba"}
            originals = {attr: getattr(lc, attr) for attr in names.values()}

            def timed(name, fn):
                def wrapped(*a, **k):
                    t0 = synced_clock(torch)
                    out = fn(*a, **k)
                    seconds[name] = seconds.get(name, 0.0) + synced_clock(torch) - t0
                    calls[name] = calls.get(name, 0) + 1
                    if name == "coords_feats":
                        kept.append(out)
                    if name == "pairwise_fits":
                        pairs_fit.append(len(a[0]))
                    return out
                return wrapped

            for name, attr in names.items():
                setattr(lc, attr, timed(name, originals[attr]))
            try:
                lc_shapes = []
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = synced_clock(torch)
                with k1_shapes(fh, lc_shapes):
                    corrected, diag = lc.loop_close_entries(enc, head_m, head_cfg_m, scene, entries,
                                                            conf_threshold=500.0, device=DEVICE)
                wall = synced_clock(torch) - t0
                lc_launches = fh.LAUNCHES
                lc_bwd = fh.LAUNCHES_BWD
            finally:
                for attr, fn in originals.items():
                    setattr(lc, attr, fn)
            require("skipped" not in diag, f"loop closure skipped: {diag.get('skipped')}")
            require(lc_launches > 0, "loop closure never launched fused_head_fwd")
            # the same call again must give the same bits: no sum on the path
            # depends on thread order (the BA's normal equations included)
            again, diag2 = lc.loop_close_entries(enc, head_m, head_cfg_m, scene, entries, conf_threshold=500.0,
                                                 device=DEVICE)
            same = [bool(np.array_equal(a.pose_w2c, b.pose_w2c)) for a, b in zip(corrected, again)]
            rec["repeat_bit_equal_frames"] = sum(same)
            rec["repeat_ba_bit_equal"] = diag.get("ba") == diag2.get("ba")
            require(all(same) and len(again) == len(corrected),
                    f"loop_close_entries twice on one input: {len(same) - sum(same)} corrections differ")
            require(rec["repeat_ba_bit_equal"], f"the BA's diagnostics differ between two calls: {diag.get('ba')} "
                                                f"against {diag2.get('ba')}")
            require(lc_bwd == 0, "loop closure launched the backward kernel")
            moved = [float(np.linalg.norm(e.pose_c2w[:3, 3] - gts[e.rgb_file][:3, 3])) for e in corrected]
            aligned = evaluate_poses(corrected, [gts[f] for f in gt_files])
            rec.update(
                call_seconds=wall, stage_seconds=seconds, stage_calls=calls, pairs=sum(pairs_fit),
                fused_head_fwd_launches=lc_launches, fused_head_fwd_shapes=lc_shapes,
                diagnostics={k: diag.get(k) for k in ("edges", "median_edge_rms", "median_corr_t", "median_corr_rot_deg",
                                                     "scene_diag", "graph_residual_rot_deg", "graph_residual_t")},
                subpix=diag.get("subpix"), ba=diag.get("ba"),
                drift_detected=tpipe.AceZeroPipeline._drift_detected(None, diag),
                median_correction_cm=statistics.median(moved) * 100,
                corrected_within_5cm_5deg_pct=aligned.accuracy, corrected_median_rot_deg=aligned.median_rot_deg,
                corrected_median_trans_cm=aligned.median_trans_cm)
            require(len(corrected) == N_FRAMES and all(np.isfinite(e.pose_w2c).all() for e in corrected),
                    "non-finite corrected pose")

            # the card against the CPU (float32 on both), on exact maps held
            # edge by edge and frame by frame, on the card's learned maps
            # held to the same edges (LOOPCLOSE_TOL_*)
            maps, fts, w2c_x, foc_x, hw_x = drifted_chesslike(np, LOOPCLOSE_CPU_FRAMES, stride=8)
            cores = {}
            for dev in (DEVICE, "cpu"):
                t0 = synced_clock(torch)
                cores[dev] = core_with_fits(np, lc, torch.from_numpy(maps).to(dev), torch.from_numpy(fts).to(dev),
                                            torch.ones(maps.shape[:3], dtype=torch.bool, device=dev), w2c_x,
                                            np.full(len(maps), 2000.0), foc_x, hw_x, 500.0)
                rec[f"exact_{dev}_seconds"] = synced_clock(torch) - t0
            exact = rec["card_vs_cpu_exact_maps"] = {"frames": len(maps), "cells": list(maps.shape[1:3]),
                                                     **card_vs_cpu(np, cores[DEVICE], cores["cpu"])}
            rec["tolerance"] = {"of_scene_diag": LOOPCLOSE_TOL_DIAG, "deg": LOOPCLOSE_TOL_DEG,
                                "scale": LOOPCLOSE_TOL_SCALE}
            require("skipped" not in cores[DEVICE][3] and "skipped" not in cores["cpu"][3],
                    f"exact maps skipped: card {cores[DEVICE][3].get('skipped')}, cpu {cores['cpu'][3].get('skipped')}")
            tol_t = LOOPCLOSE_TOL_DIAG * exact["scene_diag"]
            require(exact["pairs_equal"] and exact["edges_card"] == exact["edges_cpu"],
                    f"card and CPU select other pairs or keep other edges on exact maps: {exact}")
            fits = exact["edge_fits"]
            require(fits["trans"]["max"] <= tol_t and fits["rot_deg"]["max"] <= LOOPCLOSE_TOL_DEG,
                    f"card and CPU pairwise fits differ on exact maps: {fits}")
            frames = exact["frame_corrections"]
            require(frames["trans"]["max"] <= tol_t and frames["rot_deg"]["max"] <= LOOPCLOSE_TOL_DEG
                    and frames["scale_max"] <= LOOPCLOSE_TOL_SCALE,
                    f"card and CPU corrections differ on exact maps: {frames}")

            coords, mask_lr, feats = (torch.cat([k[i] for k in kept]) for i in range(3))
            sel = np.round(np.linspace(0, len(scene) - 1, LOOPCLOSE_CPU_FRAMES)).astype(int)
            w2c = np.stack([e.pose_w2c for e in entries])[sel]
            sub_args = (w2c, np.full(len(sel), 2000.0), scene.focals_canvas[sel], scene.canvas_hw, 500.0)
            for dev in (DEVICE, "cpu"):
                t0 = synced_clock(torch)
                cores[dev] = core_with_fits(np, lc, coords[sel].to(dev), feats[sel].to(dev), mask_lr[sel].to(dev),
                                            *sub_args)
                rec[f"subgraph_{dev}_seconds"] = synced_clock(torch) - t0
            # the CPU's own spread: the same subgraph, maps times (1 + 1e-6 noise)
            c_cpu = coords[sel].cpu().double()
            noisy = (c_cpu * (1 + 1e-6 * torch.randn(c_cpu.shape, generator=torch.Generator().manual_seed(0),
                                                     dtype=torch.float64))).float()
            learned = rec["card_vs_cpu_learned_maps"] = {
                "frames": len(sel), **card_vs_cpu(np, cores[DEVICE], cores["cpu"]),
                "cpu_spread_under_1e-6_noise": card_vs_cpu(np, core_with_fits(np, lc, noisy, feats[sel].cpu(),
                                                                              mask_lr[sel].cpu(), *sub_args),
                                                           cores["cpu"])}
            require("skipped" not in cores[DEVICE][3] and "skipped" not in cores["cpu"][3],
                    f"subgraph skipped: card {cores[DEVICE][3].get('skipped')}, cpu {cores['cpu'][3].get('skipped')}")
            require(learned["edges_card"] == learned["edges_cpu"],
                    f"card and CPU keep other edges on the learned maps: {learned}")
            del kept, coords, feats, mask_lr
            torch.cuda.empty_cache()

    if "profile" in phases:
        with phase("profile", {}) as rec:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            scene = load_scene(str(SCENE / FRAMES), pose_files=str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                               external_focal_length=FOCAL, image_short_size=PROFILE_SHORT_SIDE)
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            warm, n = PROFILE_STEPS
            for name, refine in (("recipe", True), ("fixed_poses", False)):
                cfg = TrainConfig(schedule=ScheduleConfig(learning_rate_max=0.003), loss=ReproLossConfig(loss_type="tanh"),
                                  pose_refinement="mlp" if refine else "none", refine_calibration=refine, **PROFILE_TRAIN)
                trainer = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(**PROFILE_BUFFER))
                buffer = trainer.build_buffer()
                state = trainer.build_state()
                hp = train_hp(cfg)
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), warm, generator=trainer.generator)
                # host time per step without the profiler (its start-up and
                # bookkeeping slow the host), device time per step under it
                t0 = synced_clock(torch)
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), n, generator=trainer.generator)
                host_ms = (synced_clock(torch) - t0) / n * 1e3
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), n, generator=trainer.generator)
                    torch.cuda.synchronize()
                # kernel events only: the CPU ops that launched them carry the same time
                events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
                device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
                top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
                rec[name] = {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                             "device_busy_share": device_ms / host_ms,
                             "kernels_per_step": sum(e.count for e in events) / n,
                             "top_device_ms_per_step": {e.key[:80]: e.self_device_time_total / 1e3 / n for e in top}}
                del trainer, buffer, state

    pipe_scene_load = None  # phase pipeline's scene_load seconds (a cold decode cache)
    if "pipeline" in phases:
        with phase("pipeline", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, cuts={**PIPELINE_CUTS, **PIPELINE_OVERRIDES})
            flags = [f"--{k}={v}" for k, v in PIPELINE_CUTS.items()]
            # every loop-closure call of the run: its diagnostics, seconds and
            # K1 launches, read off the pipeline's own call
            lc_calls = []
            real_lce = tpipe.loop_close_entries

            def recorded_lce(*a, **k):
                before, shapes = fh.LAUNCHES, []
                t0 = synced_clock(torch)
                with k1_shapes(fh, shapes):
                    out, diag = real_lce(*a, **k)
                sp, ba = diag.get("subpix"), diag.get("ba") or {}
                lc_calls.append({
                    "max_frames": k.get("max_frames"), "ba_mode": k["cfg"].ba if "cfg" in k else "subpix",
                    "seconds": synced_clock(torch) - t0, "fused_head_fwd_launches": fh.LAUNCHES - before,
                    "fused_head_fwd_shapes": shapes,
                    **{key: diag.get(key) for key in ("skipped", "edges", "median_edge_rms", "median_corr_t",
                                                      "median_corr_rot_deg", "scene_diag")},
                    "drift_detected": tpipe.AceZeroPipeline._drift_detected(None, diag),
                    "subpix_accepted_of_selected": [sp["n_accepted"], sp["n_selected"]] if sp else None,
                    "ba_rms_px_first_last": [ba["rms_px_first"], ba["rms_px_last"]] if "rms_px_first" in ba else None,
                    "ba_skipped": ba.get("skipped"),
                })
                emit(phase="pipeline", event="loop_closure", **lc_calls[-1])
                return out, diag

            with tempfile.TemporaryDirectory() as tmp:
                argv = [str(SCENE / FRAMES), tmp, "--depth_files", str(SCENE / FRAMES.replace(".png", "_depth.npy")),
                        "--use_external_focal_length", str(FOCAL), "--encoder_path", str(ENCODER),
                        *flags, "--device", DEVICE]
                profiling.reset_stages()
                tpipe.loop_close_entries = recorded_lce
                try:
                    fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                    t0 = time.perf_counter()
                    result = ace_zero_cli.main(argv, **PIPELINE_OVERRIDES)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    tpipe.loop_close_entries = real_lce
                pipe_launches = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD,
                                 "loop_closure": sum(c["fused_head_fwd_launches"] for c in lc_calls),
                                 "loop_closure_shapes": [sh for c in lc_calls for sh in c["fused_head_fwd_shapes"]]}
                lines = (Path(tmp) / "poses_final.txt").read_text().splitlines()
                entries = read_pose_file(Path(tmp) / "poses_final.txt")
                artifacts = sorted(p.name for p in Path(tmp).iterdir())
            gts = [np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in sorted(glob.glob(str(SCENE / FRAMES)))]
            errors = evaluate_poses(entries, gts)
            by_name = sorted(entries, key=lambda e: e.rgb_file)
            _, scale = estimate_alignment(np.stack([e.pose_c2w for e in by_name]), np.stack(gts),
                                          np.asarray([e.confidence for e in by_name]))
            rates = registration_rates([e.confidence for e in entries], [500, 1000, 2000, 4000])
            pipe_scene_load = profiling.stage_totals().get("scene_load", (None,))[0]
            rec.update(
                wall_seconds=wall, stage_seconds={k: v[0] for k, v in profiling.stage_totals().items()},
                stage_calls={k: v[1] for k, v in profiling.stage_totals().items()},
                rounds=result["iterations"], rate_history=result["rate_history"],
                registration_rates=dict(zip(("500", "1000", "2000", "4000"), rates)),
                focal_estimate=result["focal_estimate"], artifacts=artifacts,
                aligned_within_5cm_5deg_pct=errors.accuracy, aligned=errors.aligned, alignment_scale=scale,
                median_rot_deg=errors.median_rot_deg, median_trans_cm=errors.median_trans_cm,
                fused_head_fwd_launches=pipe_launches["fwd"], fused_head_bwd_launches=pipe_launches["bwd"],
                loop_closure_calls=lc_calls,
                loop_closure_fused_head_fwd_launches=sum(c["fused_head_fwd_launches"] for c in lc_calls),
                loop_closure_stage_seconds={k: v[0] for k, v in profiling.stage_totals().items()
                                            if k.startswith("loop_closure")},
                registered_half=rates[0] >= RELOC_SHARE, report=result["report"])
            require(len(lines) == N_FRAMES and all(len(ln.split()) == 10 for ln in lines),
                    f"poses_final.txt is not {N_FRAMES} lines of 10 tokens")
            require(all(np.isfinite(e.pose_w2c).all() for e in entries), "non-finite pose in poses_final.txt")
            require(pipe_launches["fwd"] > 0, "the pipeline never launched fused_head_fwd")
            require(pipe_launches["bwd"] > 0, "the pipeline never launched fused_head_bwd")
            require(rates[0] >= PIPELINE_SHARE,
                    f"the pipeline registered {rates[0]:.1%} of the frames at confidence 500")
            full = [c for c in lc_calls if c["ba_mode"] != "off" and c["skipped"] is None]
            require(bool(full), f"no full loop-closure measurement ran unskipped: {lc_calls}")
            require(all(c["fused_head_fwd_launches"] > 0 for c in lc_calls), "a loop-closure call never launched K1")

    if "seeddepth" in phases:
        with phase("seeddepth", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, jax_cpu=SEEDDEPTH_JAX, tpu_record=SEEDDEPTH_TPU_RECORD,
                       tolerance=SEEDDEPTH_TOL, cpu_tolerance=SEEDDEPTH_CPU_TOL)
            est = learned_depth_estimator(DEPTH_HEAD, encoder_path=ENCODER, device=DEVICE)
            frames = sorted(glob.glob(str(SCENE / FRAMES)))[::SEEDDEPTH_STRIDE]
            raws, shapes, scales, ms, preds = [], [], [], [], []
            est(read_rgb(frames[0]))  # cuDNN's first-call set-up, outside the times
            for f in frames:
                img = read_rgb(f)
                gt = np.load(f[: -len(".png")] + "_depth.npy").astype(np.float64)
                t0 = synced_clock(torch)
                pred = est(img)
                ms.append((synced_clock(torch) - t0) * 1e3)
                preds.append(pred)
                v = gt > 0
                raws.append(float(np.median(np.abs(pred[v] - gt[v]) / gt[v])))
                sc = float(np.median(gt[v]) / np.median(pred[v]))
                shapes.append(float(np.median(np.abs(pred[v] * sc - gt[v]) / gt[v])))
                scales.append(sc)
            stats = {"raw_rel": float(np.median(raws)), "shape_rel": float(np.median(shapes)),
                     "scale_cv": float(np.std(scales) / np.mean(scales))}
            cpu_pred = learned_depth_estimator(DEPTH_HEAD, encoder_path=ENCODER, device="cpu")(read_rgb(frames[0]))
            dlog = float(np.abs(np.log(preds[0]) - np.log(cpu_pred)).max())
            rec.update(frames=len(frames), **stats, ms_per_frame=statistics.median(ms), ms_per_frame_all=ms,
                       card_vs_cpu_max_abs_dlog=dlog, finite=bool(all(np.isfinite(p_).all() for p_ in preds)))
            require(len(frames) == 10, f"expected 10 frames at stride {SEEDDEPTH_STRIDE}, found {len(frames)}")
            require(rec["finite"] and all(p_.shape == (480, 640) and (p_ > 0).all() for p_ in preds),
                    "the estimator's depth is not finite and positive at 480 x 640")
            for key, ref in SEEDDEPTH_JAX.items():
                require(abs(stats[key] - ref) <= SEEDDEPTH_TOL, f"seed depth {key} {stats[key]:.4f} is not within "
                                                                f"{SEEDDEPTH_TOL} of the JAX package's {ref:.4f}")
            require(dlog <= SEEDDEPTH_CPU_TOL, f"card and CPU log-depth differ by {dlog} > {SEEDDEPTH_CPU_TOL}")

    bare_out = bare_glob = None  # phase bare's output folder and JPEG glob, read by phases render and jpeg
    rec_bare_scene_load = None  # phase bare's cold scene_load seconds on its JPEGs
    if "bare" in phases:
        with phase("bare", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, cuts={**PIPELINE_CUTS, **PIPELINE_OVERRIDES}, floor=BARE_SHARE,
                       jax_cpu_rate=BARE_JAX_RATE)
            flags = [f"--{k}={v}" for k, v in PIPELINE_CUTS.items()]
            heads, export_shapes, export_seconds, render_shapes, visualizers, rounds = [], [], [], [], [], []
            real_lde, real_export = tpipe.learned_depth_estimator, tpipe.export_point_cloud_from_network
            real_cloud, real_viz, real_train = (tpipe.point_cloud_from_network, tpipe.ReconstructionVisualizer,
                                                tpipe.AceZeroPipeline._train)

            def recorded_lde(head_path, *a, **k):
                heads.append(Path(head_path).name)
                return real_lde(head_path, *a, **k)

            def recorded_export(*a, **k):
                t0 = synced_clock(torch)
                with k1_shapes(fh, export_shapes):
                    out = real_export(*a, **k)
                export_seconds.append(synced_clock(torch) - t0)
                return out

            def recorded_cloud(*a, **k):  # the render hook's point cloud
                with k1_shapes(fh, render_shapes):
                    return real_cloud(*a, **k)

            def recorded_viz(*a, **k):
                visualizers.append(real_viz(*a, **k))
                return visualizers[-1]

            def recorded_train(self, scene, train_cfg, init_head, base_seed, frame_callback=None):
                result = real_train(self, scene, train_cfg, init_head, base_seed, frame_callback)
                if frame_callback is not None:
                    rounds.append((result["iterations"], train_cfg.chunk_steps, train_cfg.iterations_output))
                return result

            # the output folder outlives the phase: phase render reads it.
            # The frames as a user hands them over: JPEG copies (write_jpeg at
            # BARE_JPEG, tinted to three components), each with a focal file
            # beside it, from the scene's focal_length.txt
            tmp = Path(work) / "bare"
            focal = (SCENE / "focal_length.txt").read_text().strip()
            (tmp / "jpg").mkdir(parents=True)
            t0 = time.perf_counter()
            for f in sorted(glob.glob(str(SCENE / FRAMES))):
                write_jpeg(tmp / "jpg" / (Path(f).stem + ".jpg"), tinted(np, read_png(f)), *BARE_JPEG)
                (tmp / "jpg" / (Path(f).stem + ".txt")).write_text(focal + "\n")
            bare_glob = str(tmp / "jpg" / FRAMES.replace(".png", ".jpg"))
            rec.update(jpeg=list(BARE_JPEG), tint=list(JPEG_TINT), jpeg_write_seconds=time.perf_counter() - t0,
                       jpeg_bytes=sum(p_.stat().st_size for p_ in (tmp / "jpg").glob("*.jpg")))
            out_dir = tmp / "out"
            argv = [bare_glob, str(out_dir), "--calibration_files", str(tmp / "jpg" / "frame_*.txt"),
                    "--encoder_path", str(ENCODER), "--export_point_cloud", "true", "--render_visualization", "true",
                    *flags, "--device", DEVICE]
            profiling.reset_stages()
            tpipe.learned_depth_estimator, tpipe.export_point_cloud_from_network = recorded_lde, recorded_export
            tpipe.point_cloud_from_network, tpipe.ReconstructionVisualizer = recorded_cloud, recorded_viz
            tpipe.AceZeroPipeline._train = recorded_train
            try:
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                result = ace_zero_cli.main(argv, **PIPELINE_OVERRIDES)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                bare_launches = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD, "export_shapes": export_shapes,
                                 "render_shapes": render_shapes}
            finally:
                tpipe.learned_depth_estimator, tpipe.export_point_cloud_from_network = real_lde, real_export
                tpipe.point_cloud_from_network, tpipe.ReconstructionVisualizer = real_cloud, real_viz
                tpipe.AceZeroPipeline._train = real_train
            lines = (out_dir / "poses_final.txt").read_text().splitlines()
            entries = read_pose_file(out_dir / "poses_final.txt")
            xyz, rgb = read_ply_points(out_dir / "pc_final.ply")
            artifacts = sorted(p_.name for p_ in out_dir.iterdir())
            gts = [np.loadtxt(f[: -len(".png")] + "_pose.txt") for f in sorted(glob.glob(str(SCENE / FRAMES)))]
            errors = evaluate_poses(entries, gts)
            rates = registration_rates([e.confidence for e in entries], [500, 1000, 2000, 4000])
            totals = profiling.stage_totals()

            # the video
            renders = out_dir / "renderings"
            frames = sorted(renders.glob("frame_*.png"))
            decoded, shown = 0, 0
            for f in frames:
                img = read_png(f)
                decoded += img.shape == FRAME_SHAPE
                shown += img.shape == FRAME_SHAPE and bool((img[200:-200] != 255).any())
            viz = visualizers[0] if visualizers else None
            registrations = totals.get("registration", (0, 0))[1]
            expected = {"reloc": RELOC_FRAMES * registrations, "sweep": SWEEP_FRAMES,
                        "mapping": sum(mapping_frames(*r) for r in rounds)}
            per_frame = {part: {"median_ms": statistics.median(v) * 1e3 if v else None, "total_s": sum(v)}
                         for part, v in (viz.frame_seconds.items() if viz else ())}
            # the cloud's colours come from the tinted JPEGs (R over B by about
            # 23 levels), not from the gray canvases (R = B)
            rgb_tint = float(rgb[:, 0].astype(np.float64).mean() - rgb[:, 2].astype(np.float64).mean()) \
                if rgb is not None and len(rgb) else None
            rec.update(
                wall_seconds=wall, stage_seconds={k: v[0] for k, v in totals.items()},
                stage_calls={k: v[1] for k, v in totals.items()}, depth_heads=heads,
                scene_load_seconds={"pipeline": pipe_scene_load, "bare_cold_jpeg": totals.get("scene_load", (None,))[0]},
                ply_mean_r_minus_b=rgb_tint,
                rounds=result["iterations"], rate_history=result["rate_history"],
                registration_rates=dict(zip(("500", "1000", "2000", "4000"), rates)),
                focal_estimate=result["focal_estimate"], artifacts=artifacts,
                aligned_within_5cm_5deg_pct=errors.accuracy, median_rot_deg=errors.median_rot_deg,
                median_trans_cm=errors.median_trans_cm, fused_head_fwd_launches=bare_launches["fwd"],
                fused_head_bwd_launches=bare_launches["bwd"], export_fused_head_fwd_shapes=export_shapes,
                export_seconds=export_seconds, ply_points=int(len(xyz)),
                ply_finite=bool(np.isfinite(xyz).all()), report=result["report"],
                frames_by_kind=viz.frames_by_kind if viz else None, frames_expected=expected,
                mapping_rounds=[list(r) for r in rounds], frames_written=len(frames), frames_decoded=decoded,
                frames_showing_the_scene=shown, register_pickles=sorted(p_.name for p_ in renders.glob("*.pkl")),
                frame_seconds=per_frame, render_fused_head_fwd_shapes=render_shapes,
                render_stage_seconds=totals.get("render", (None,))[0],
                cloud_points=int(len(viz.cloud_xyz)) if viz else None,
                renderings_bytes=sum(p_.stat().st_size for p_ in renders.iterdir()),
                ffmpeg=shutil.which("ffmpeg"), video_written=(out_dir / "reconstruction.mp4").exists())
            require(heads == [DEPTH_HEAD.name], f"the run did not seed from the learned head {DEPTH_HEAD.name}: {heads}")
            require(len(lines) == N_FRAMES and all(len(ln.split()) == 10 for ln in lines),
                    f"poses_final.txt is not {N_FRAMES} lines of 10 tokens")
            require(all(np.isfinite(e.pose_w2c).all() for e in entries), "non-finite pose in poses_final.txt")
            require(bare_launches["fwd"] > 0 and bare_launches["bwd"] > 0, f"a kernel never launched: {bare_launches}")
            require(len(export_shapes) > 0, "the point-cloud export never launched fused_head_fwd")
            require(len(xyz) > 0 and rec["ply_finite"] and rgb is not None and len(rgb) == len(xyz),
                    f"pc_final.ply holds {len(xyz)} points")
            require(rgb_tint > 10, f"pc_final.ply's colours are not the JPEGs' (mean R - B {rgb_tint})")
            require(rates[0] >= BARE_SHARE,
                    f"the bare run registered {rates[0]:.1%} of the frames at confidence 500 (floor {BARE_SHARE:.1%})")
            require(viz is not None and viz.frames_by_kind["sweep"] == SWEEP_FRAMES
                    and viz.frames_by_kind["reloc"] == expected["reloc"],
                    f"frames {rec['frames_by_kind']}, expected {expected}")
            require(len(frames) == sum(viz.frames_by_kind.values()) == decoded == shown,
                    f"{len(frames)} frames, {decoded} decode to {FRAME_SHAPE}, {shown} show the scene")
            require(len(rec["register_pickles"]) == registrations and len(render_shapes) > 0,
                    f"pickles {rec['register_pickles']}, render-hook K1 launches {render_shapes}")
            bare_out = out_dir
            rec_bare_scene_load = totals.get("scene_load", (None,))[0]

    if "render" in phases:
        with phase("render", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, pixel_share=RENDER_PIXEL_SHARE)
            renders = bare_out / "renderings"
            states = sorted(renders.glob("iteration*_register.pkl"), key=lambda p_: int(p_.name[9:].split("_")[0]))
            entries = read_pose_file(bare_out / "poses_final.txt")
            poses = np.stack([e.pose_c2w for e in entries])
            confs = np.asarray([e.confidence for e in entries])
            render_launches = {}

            # 1. the renderer on the card against the CPU, on the last state's
            # cloud, from the orbit camera, with the cameras
            viz = ReconstructionVisualizer(VizConfig(target_path=Path(work) / "render_check"), device=DEVICE)
            viz.load_state(states[-1])
            view = viz._pan_camera(0.02 * viz.frame_idx)
            cam_xyz, cam_rgb = render_cameras(poses, np.tile([[0.9, 0.2, 0.1]], (len(poses), 1)), view,
                                              viz.cfg.focal, *FRAME_SHAPE[:2], viz.cfg.marker_size)
            xyz = np.concatenate([viz.cloud_xyz, cam_xyz])
            rgb = np.concatenate([viz.cloud_rgb, cam_rgb])
            xyz_d, rgb_d = torch.from_numpy(xyz).to(DEVICE), torch.from_numpy(rgb).to(DEVICE)
            empty = np.zeros((0, 3), np.float32)
            card = [composite_frame(xyz_d, rgb_d, empty, empty, view, viz.cfg.focal, *FRAME_SHAPE[:2])
                    for _ in range(2)]
            cpu = composite_frame(xyz, rgb, empty, empty, view, viz.cfg.focal, *FRAME_SHAPE[:2], device="cpu")
            differ = float(np.any(card[0] != cpu, axis=-1).mean())
            device_ms = time_ms(lambda: render_point_cloud(xyz_d, rgb_d, view, viz.cfg.focal, *FRAME_SHAPE[:2]),
                                torch)
            frame_ms = []
            for _ in range(10):
                t0 = time.perf_counter()
                composite_frame(xyz_d, rgb_d, empty, empty, view, viz.cfg.focal, *FRAME_SHAPE[:2])
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            cpu_ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                composite_frame(xyz, rgb, empty, empty, view, viz.cfg.focal, *FRAME_SHAPE[:2], device="cpu")
                cpu_ms.append((time.perf_counter() - t0) * 1e3)
            rec["renderer"] = {"state": states[-1].name, "points": int(len(xyz)), "pixels_differing_share": differ,
                               "card_repeats_bit_for_bit": bool(np.array_equal(card[0], card[1])),
                               "device_ms": device_ms, "frame_ms_with_download": statistics.median(frame_ms),
                               "cpu_ms": statistics.median(cpu_ms), "background_share":
                                   float(np.all(card[0] == 255, axis=-1).mean())}
            require(differ <= RENDER_PIXEL_SHARE, f"card and CPU frames differ in {differ:.4%} of the pixels")
            require(rec["renderer"]["card_repeats_bit_for_bit"], "the card's frame changed between two renders")

            # 2. the final-sweep CLI on bare's renderings; it numbers its frames
            # from the last state's frame index on, as the JAX package's does
            t0, t0_ns = time.perf_counter(), time.time_ns()
            require(render_final_sweep_cli.main([str(renders), "--num_frames", str(SWEEP_FRAMES), "--device",
                                                 DEVICE]) == 0,
                    "render_final_sweep_cli failed")
            written = [p_ for p_ in renders.glob("frame_*.png") if p_.stat().st_mtime_ns >= t0_ns]
            rec["sweep_cli"] = {"seconds": time.perf_counter() - t0, "frames": len(written),
                                "first_frame": min(p_.name for p_ in written) if written else None}
            require(len(written) == SWEEP_FRAMES and all(read_png(p_).shape == FRAME_SHAPE for p_ in written[:3]),
                    f"the sweep CLI wrote {len(written)} frames")

            # 3. export_cli from the visualizer buffer: the pickle's cloud as it is
            out = Path(work) / "render"
            out.mkdir()
            t0 = time.perf_counter()
            require(export_cli.main(["point_cloud", str(out / "buffer.ply"), "--visualization_buffer",
                                     str(states[-1])]) == 0, "export_cli --visualization_buffer failed")
            b_xyz, b_rgb = read_ply_points(out / "buffer.ply")
            want_rgb = (viz.cloud_rgb * 255).clip(0, 255).astype(np.uint8)
            rec["buffer_export"] = {"seconds": time.perf_counter() - t0, "points": int(len(b_xyz)),
                                    "bit_equal": bool(np.array_equal(b_xyz, viz.cloud_xyz)
                                                      and np.array_equal(b_rgb, want_rgb))}
            require(rec["buffer_export"]["bit_equal"], "the buffer PLY is not the pickle's cloud")

            # 4. export_cli from the network: bare's final head, K1 on the card
            final_head = max(bare_out.glob("iteration[0-9]*.pt"), key=lambda p_: int(p_.stem[9:].split("_")[0]))
            shapes = []
            with k1_shapes(fh, shapes):
                fh.LAUNCHES = 0
                t0 = synced_clock(torch)
                require(export_cli.main(["point_cloud", str(out / "network.ply"), "--network", str(final_head),
                                         "--pose_file", str(bare_out / "poses_final.txt"), "--encoder_path",
                                         str(ENCODER), "--pose_file_conf_threshold", str(EXPORT_CONF), "--device",
                                         DEVICE]) == 0,
                        "export_cli --network failed")
                n_xyz, _ = read_ply_points(out / "network.ply")
                render_launches["export_cli"] = fh.LAUNCHES
            rec["network_export"] = {"head": final_head.name, "seconds": synced_clock(torch) - t0,
                                     "points": int(len(n_xyz)), "finite": bool(np.isfinite(n_xyz).all()),
                                     "fused_head_fwd_launches": render_launches["export_cli"],
                                     "fused_head_fwd_shapes": shapes}
            require(len(n_xyz) > 0 and rec["network_export"]["finite"] and render_launches["export_cli"] > 0,
                    f"the network export: {rec['network_export']}")

            # 5. camera meshes
            require(export_cli.main(["cameras", str(bare_out / "poses_final.txt"), str(out / "cameras.ply")]) == 0,
                    "export_cli cameras failed")
            rec["cameras"] = ply_header_counts(out / "cameras.ply")
            require(rec["cameras"] == {"vertex": 5 * N_FRAMES, "face": 6 * N_FRAMES}, f"cameras {rec['cameras']}")

            # 6. the Nerfstudio export of the JPEG frames, and the runner
            # without Nerfstudio
            transforms = json.loads(nerf.export_transforms_json(bare_out / "poses_final.txt", bare_glob,
                                                                out / "nerf").read_text())
            test_want = [f for i, f in enumerate(sorted(glob.glob(bare_glob))) if i % 8 == 4]
            rec["nerfstudio"] = {"frames": len(transforms["frames"]), "train": len(transforms["train_filenames"]),
                                 "test": len(transforms["test_filenames"]),
                                 "point_cloud": transforms.get("ply_file_path"), "ns_train": shutil.which("ns-train")}
            require(len(transforms["frames"]) == N_FRAMES and transforms["test_filenames"] == test_want
                    and (out / "nerf" / "pc_final.ply").read_bytes() == (bare_out / "pc_final.ply").read_bytes(),
                    f"transforms.json: {rec['nerfstudio']}")
            if rec["nerfstudio"]["ns_train"] is None:
                try:
                    nerfstudio_runner.run_benchmark(bare_out / "poses_final.txt", bare_glob, out / "bench")
                    raise AssertionError("run_benchmark ran without ns-train")
                except RuntimeError as exc:
                    rec["nerfstudio"]["runner_error"] = str(exc)[:200]
                    require("ns-train" in str(exc), f"the runner's error does not name ns-train: {exc}")
                # the runner's downscale (before it looks for ns-train) of
                # three JPEG frames enlarged to 1,280 pixels wide: JPEGs 640
                # wide under the sources' names, close to the frames at that
                # size (4.0-4.3 levels a pixel on the CPU after the three
                # JPEG writes and the two resizes; another frame is 20 or
                # more)
                big = out / "big"
                big.mkdir()
                srcs = sorted(glob.glob(bare_glob))[:3]
                bigs = []
                for f in srcs:
                    bigs.append(str(big / Path(f).name))
                    src = read_jpeg(f)
                    big_hw = (round(src.shape[0] * 1280 / src.shape[1]), 1280)
                    write_jpeg(bigs[-1], pil_resize_bilinear(src, *big_hw), *BARE_JPEG)
                write_pose_file(big / "poses.txt", [PoseFileEntry(b, e.pose_w2c, 2 * e.focal_length, 2000.0)
                                                    for b, e in zip(bigs, entries)])
                t0 = time.perf_counter()
                try:
                    nerfstudio_runner.run_benchmark(big / "poses.txt", str(big / "*.jpg"), out / "bench_big")
                    raise AssertionError("run_benchmark ran without ns-train")
                except RuntimeError as exc:
                    require("ns-train" in str(exc), f"the runner's error does not name ns-train: {exc}")
                frames_out = json.loads((out / "bench_big" / "transforms.json").read_text())["frames"]
                small = [read_jpeg(fr["file_path"]) for fr in frames_out]
                by_name = {Path(f).name: f for f in srcs}  # transforms.json lists the frames in glob order
                diffs = [float(np.abs(a.astype(np.int16) - pil_resize_bilinear(
                    read_jpeg(by_name[Path(fr["file_path"]).name]), *a.shape[:2])).mean())
                    for a, fr in zip(small, frames_out)]
                rec["nerfstudio"]["downscale"] = {
                    "seconds": time.perf_counter() - t0, "sizes": [[fr["h"], fr["w"]] for fr in frames_out],
                    "files": [Path(fr["file_path"]).name for fr in frames_out], "mean_abs_diff_to_frame": diffs,
                    "fl_x": [fr["fl_x"] for fr in frames_out]}
                require(all(fr["w"] == 640 and fr["h"] == round(big_hw[0] / 2) for fr in frames_out)
                        and all(a.shape == (fr["h"], fr["w"], 3) for a, fr in zip(small, frames_out))
                        and sorted(Path(fr["file_path"]).name for fr in frames_out) == sorted(by_name)
                        and max(diffs) < 8.0, f"the runner's JPEG downscale: {rec['nerfstudio']['downscale']}")

            # 7. the runner's downscale of one source of each kind PIL opens,
            # against PIL's (the JAX runner's) results: the frame's new size
            # and focal, the output's mode and pixels (PNG) or bytes (JPEG)
            t0 = time.perf_counter()
            kinds = runner_kinds_check(np, nerfstudio_runner, out / "runner")
            rec["runner_kinds"] = {"seconds": time.perf_counter() - t0,
                                   "equal_to_pil": f"{sum(c['equal_to_pil'] for c in kinds.values())}/{len(kinds)}",
                                   "sources": kinds}
            require(sorted(kinds) == sorted(RUNNER_SOURCES) and all(c["equal_to_pil"] for c in kinds.values()),
                    f"the runner's downscale is not PIL's: {[n for n, c in kinds.items() if not c['equal_to_pil']]}")

            # 8. Regressor against the export path, one K1 launch each
            files = sorted(glob.glob(bare_glob))[:REGRESSOR_FRAMES]
            canvases = decode_to_canvas(files, short_size=480).canvases
            reg = Regressor.create_from_split_state_dict(ENCODER, final_head, device=DEVICE)
            shapes = []
            with k1_shapes(fh, shapes):
                fh.LAUNCHES = 0
                want = predict_coords(reg.encoder_params, reg.head_params, reg.head_cfg, canvases)
                with torch.inference_mode():
                    got = reg.forward(normalize_images(torch.from_numpy(canvases).to(DEVICE))).cpu().numpy()
                render_launches["regressor"] = fh.LAUNCHES
            rec["regressor"] = {"frames": len(files), "shape": list(got.shape), "bit_equal": bool(
                np.array_equal(got, want)), "fused_head_fwd_launches": render_launches["regressor"],
                "fused_head_fwd_shapes": shapes}
            require(rec["regressor"]["bit_equal"] and np.isfinite(got).all() and render_launches["regressor"] == 2,
                    f"Regressor against predict_coords: {rec['regressor']}")
            render_launches["shapes"] = rec["network_export"]["fused_head_fwd_shapes"] + shapes

    if "jpeg" in phases:
        with phase("jpeg", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, host_compiler=build.build_info.get("jpeg", {}).get("compiler"),
                       canvas_library=build.host_target(tnative.SOURCE).name)
            # (a) the committed fixtures decode to PIL's arrays
            digests = json.loads((JPEG_FIXTURES / "pil_digests.json").read_text())
            fixtures = {}
            for name, want in sorted(digests["files"].items()):
                got = read_jpeg(JPEG_FIXTURES / name)
                fixtures[name] = list(got.shape) == want["shape"] and array_digest(got) == want["sha256"]
            rec["fixtures_equal_to_pil"] = f"{sum(fixtures.values())}/{len(fixtures)}"
            require(all(fixtures.values()), f"fixtures not decoded to PIL's bits: {[n for n, v in fixtures.items() if not v]}")
            # the four-component fixtures through read_rgb: PIL's convert("RGB")
            rgb = {name: array_digest(read_rgb(JPEG_FIXTURES / name)) == want for name, want in sorted(digests["rgb"].items())}
            rec["read_rgb_equal_to_pil"] = f"{sum(rgb.values())}/{len(rgb)}"
            require(rgb and all(rgb.values()), f"read_rgb not PIL's convert('RGB'): {rgb}")
            # decode_to_canvas over every fixture, all kinds in one glob: the
            # JAX package's canvases at the default canvas and at one smaller
            # than the content (the centre crop)
            t0 = time.perf_counter()
            fixture_glob = sorted(str(p_) for p_ in JPEG_FIXTURES.glob("*.jpg"))
            canvas = []
            for entry in digests["canvas"]:
                hw = None if entry["canvas_hw"] is None else tuple(entry["canvas_hw"])
                out = decode_to_canvas(fixture_glob, short_size=entry["short_size"], canvas_hw=hw, num_workers=4)
                canvas.append({"short_size": entry["short_size"], "canvas_hw": entry["canvas_hw"],
                               "shape": list(out.canvases.shape), "equal_to_jax": canvas_digest(out) == entry["sha256"]})
            rec["canvas"] = canvas
            rec["canvas_seconds"] = time.perf_counter() - t0
            require(len(canvas) == 2 and all(c["equal_to_jax"] for c in canvas),
                    f"decode_to_canvas over the fixtures is not the JAX package's: {canvas}")

            # (b) write_jpeg writes PIL's bytes, and they decode to PIL's arrays
            roundtrip = []
            for entry in digests["roundtrip"]:
                path = Path(work) / f"roundtrip_{entry['frame']}.jpg"
                write_jpeg(path, jpeg_roundtrip_frame(np, entry["frame"]), entry["quality"], entry["subsampling"])
                roundtrip.append({"frame": entry["frame"], "quality": entry["quality"],
                                  "subsampling": entry["subsampling"],
                                  "bytes_equal_to_pil": hashlib.sha256(path.read_bytes()).hexdigest()
                                  == entry["bytes_sha256"],
                                  "decode_equal_to_pil": array_digest(read_jpeg(path)) == entry["sha256"]})
            rec["roundtrip"] = roundtrip
            require(all(r["bytes_equal_to_pil"] and r["decode_equal_to_pil"] for r in roundtrip),
                    f"write_jpeg round trip: {roundtrip}")

            # (c) photo-size frames: the chesslike frames enlarged to
            # JPEG_PHOTO_HW, written at JPEG_PHOTO_QUALITY (4:2:0)
            photo = Path(work) / "photo"
            photo.mkdir()
            srcs = sorted(glob.glob(str(SCENE / FRAMES)))[:: N_FRAMES // JPEG_PHOTO_FRAMES][:JPEG_PHOTO_FRAMES]

            def make_photo(i_f):
                i, f = i_f
                big = pil_resize_bilinear(tinted(np, read_png(f)), *JPEG_PHOTO_HW)
                write_jpeg(photo / f"photo_{i:02d}.jpg", big, JPEG_PHOTO_QUALITY)

            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=JPEG_PHOTO_FRAMES) as ex:
                list(ex.map(make_photo, enumerate(srcs)))
            files = sorted(str(p_) for p_ in photo.glob("*.jpg"))
            mp = JPEG_PHOTO_HW[0] * JPEG_PHOTO_HW[1] / 1e6
            rec["photo"] = {"frames": len(files), "hw": list(JPEG_PHOTO_HW), "quality": JPEG_PHOTO_QUALITY,
                            "megapixels": mp, "make_seconds": time.perf_counter() - t0,
                            "mean_bytes": statistics.mean(Path(f).stat().st_size for f in files)}
            # the codec alone, one thread, the files warm in the page cache
            decode_s = []
            for f in files[:3]:
                t0 = time.perf_counter()
                img = read_jpeg(f)
                decode_s.append(time.perf_counter() - t0)
            require(img.shape == (*JPEG_PHOTO_HW, 3), f"a photo frame decodes to {img.shape}")
            del img
            # threads: ctypes releases the GIL, so the decodes overlap
            t0 = time.perf_counter()
            for f in files:
                read_jpeg(f)
            serial = time.perf_counter() - t0
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(max_workers=len(files)) as ex:
                shapes = [a.shape for a in ex.map(read_jpeg, files)]
            threaded = time.perf_counter() - t0
            rec["codec"] = {"read_jpeg_ms": statistics.median(decode_s) * 1e3,
                            "read_jpeg_mp_per_s": mp / statistics.median(decode_s),
                            "serial_seconds": serial, "threaded_seconds": threaded, "threads": len(files),
                            "thread_speedup": serial / threaded, "cpus": os.cpu_count()}
            require(all(sh == (*JPEG_PHOTO_HW, 3) for sh in shapes), "a threaded decode gave another shape")
            require(serial / threaded > 2.0, f"{len(files)} threads decode only {serial / threaded:.2f}x as fast as one: "
                                             "the GIL is not released")
            # the canvas pass on each frame alone against its plain version
            rec["canvas_pass"], plain_canvases = canvas_pass_check(np, files, 480)
            rec["canvas_pass"]["pass_mp_per_s"] = mp / rec["canvas_pass"]["pass_ms"] * 1e3
            require(rec["canvas_pass"]["equal"], f"the canvas pass differs from gray_resize: {rec['canvas_pass']}")
            # decode_to_canvas, each worker count in a fresh process
            runs = {w: photo_decode_child(ROOT, str(photo / "*.jpg"), w) for w in JPEG_WORKERS}
            for w, r in runs.items():
                r.update(ms_per_image=r["seconds"] / r["frames"] * 1e3, mp_per_s=r["frames"] * mp / r["seconds"])
            rec["decode_to_canvas"] = {str(w): r for w, r in runs.items()}
            w1, wn = JPEG_WORKERS[0], JPEG_WORKERS[-1]
            rec["decode_to_canvas_speedup"] = runs[w1]["seconds"] / runs[wn]["seconds"]
            require(len({r["sha256"] for r in runs.values()}) == 1 and runs[w1]["frames"] == JPEG_PHOTO_FRAMES,
                    f"decode_to_canvas differs between worker counts: {rec['decode_to_canvas']}")
            rec["decode_to_canvas_equal_to_plain"] = runs[w1]["sha256"] == hashlib.sha256(plain_canvases.tobytes()).hexdigest()
            require(rec["decode_to_canvas_equal_to_plain"], "decode_to_canvas's canvases are not the plain version's")
            shutil.rmtree(photo)

            # (d) the warm read of the decode cache that the bare run filled
            # (without phase bare: JPEG copies of the frames, read cold first)
            cache_dir = AceZeroConfig().decode_cache_dir  # the reconstruction CLI's default
            pattern = bare_glob
            if pattern is None:
                (Path(work) / "jpeg_cache").mkdir()
                for f in sorted(glob.glob(str(SCENE / FRAMES))):
                    write_jpeg(Path(work) / "jpeg_cache" / (Path(f).stem + ".jpg"), tinted(np, read_png(f)), *BARE_JPEG)
                pattern = str(Path(work) / "jpeg_cache" / "*.jpg")
                t0 = time.perf_counter()
                decode_to_canvas(sorted(glob.glob(pattern)), short_size=480, cache_dir=cache_dir)
                rec["cache_cold_seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm = decode_to_canvas(sorted(glob.glob(pattern)), short_size=480, cache_dir=cache_dir)
            rec["cache"] = {"glob_of": "bare" if bare_glob else "jpeg", "warm_seconds": time.perf_counter() - t0,
                            "hit": isinstance(warm.canvases, np.memmap), "frames": len(warm.canvases),
                            "bare_cold_scene_load_seconds": rec_bare_scene_load}
            require(rec["cache"]["hit"] and len(warm.canvases) == N_FRAMES, f"the decode cache missed: {rec['cache']}")

    if "spill" in phases:
        with phase("spill", {}) as rec:
            rec.update(kind=kind, nvidia_smi=smi, steps_held=SPILL_STEPS[0], steps_timed=SPILL_STEPS[1])
            scene = load_scene(str(SCENE / FRAMES), pose_files=str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                               external_focal_length=FOCAL)
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            runs = {}
            spill_launches = {"fwd": 0, "bwd": 0}
            for name, spill in (("device", False), ("host_spill", True)):
                cfg = TrainConfig(schedule=ScheduleConfig(learning_rate_max=0.003), loss=ReproLossConfig(loss_type="tanh"),
                                  buffer_host_spill=spill)
                trainer = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(), base_seed=2089)
                hp = train_hp(cfg)
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = synced_clock(torch)
                buffer = trainer.build_buffer()
                fill = synced_clock(torch) - t0
                state = trainer.build_state()
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), SPILL_STEPS[0],
                                       generator=trainer.generator)
                torch.cuda.synchronize()
                held = [t.cpu() for t in tree_leaves(state.head_params)]
                t0 = time.perf_counter()
                state, _ = train_steps(state, buffer, trainer.ctx, hp, cfg, HeadConfig(), SPILL_STEPS[1],
                                       generator=trainer.generator)
                dispatched = time.perf_counter() - t0
                torch.cuda.synchronize()
                timed = time.perf_counter() - t0
                spill_launches["fwd"] += fh.LAUNCHES
                spill_launches["bwd"] += fh.LAUNCHES_BWD
                runs[name] = {"buffer": buffer, "params": held}
                rec[name] = {"fill_seconds": fill, "buffer_rows": int(buffer["features"].shape[0]),
                             "buffer_device": str(buffer["features"].device),
                             "buffer_pinned": bool(buffer["features"].is_pinned()) if spill else None,
                             "steps_per_s": SPILL_STEPS[1] / timed, "ms_per_step": timed / SPILL_STEPS[1] * 1e3,
                             "host_ms_per_step": dispatched / SPILL_STEPS[1] * 1e3,
                             "fused_head_fwd_launches": fh.LAUNCHES, "fused_head_bwd_launches": fh.LAUNCHES_BWD}
                del trainer, state
            dev_buf, host_buf = runs["device"]["buffer"], runs["host_spill"]["buffer"]
            rec["fill_equal_rows"] = all(torch.equal(dev_buf[k].cpu(), host_buf[k]) for k in dev_buf)
            rec["params_bit_equal"] = all(torch.equal(a, b) for a, b in zip(runs["device"]["params"],
                                                                              runs["host_spill"]["params"]))
            rec["spill_over_device_steps_per_s"] = rec["host_spill"]["steps_per_s"] / rec["device"]["steps_per_s"]
            del runs, dev_buf, host_buf
            torch.cuda.empty_cache()
            require(rec["host_spill"]["buffer_device"] == "cpu" and rec["host_spill"]["buffer_pinned"],
                    "the host-spill buffer is not in pinned host memory")
            require(rec["fill_equal_rows"], "the host-spill fill differs from the device fill")
            require(rec["params_bit_equal"], f"host-spill and device-buffer parameters differ after {SPILL_STEPS[0]} steps")
            total = sum(SPILL_STEPS)
            require(all(rec[n]["fused_head_bwd_launches"] == total and rec[n]["fused_head_fwd_launches"] >= total
                        for n in ("device", "host_spill")), f"a run missed its kernels: {spill_launches}")

    if "mesh" in phases:
        with phase("mesh", {}) as rec:
            from collections import Counter

            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            from dataclasses import replace

            from acezero_tpu_torch.parallel import gather_rows, make_mesh
            from acezero_tpu_torch.registration import driver as tdrv
            from acezero_tpu_torch.training import trainer as tt
            from acezero_tpu_torch.registration.ransac import draw_hypothesis_indices

            rec.update(kind=kind, nvidia_smi=smi, count=torch.cuda.device_count(), shards=MESH_SHARDS,
                       steps_held=MESH_STEPS[0], steps_timed=MESH_STEPS[1])
            meshes = {"logical": make_mesh(devices=[DEVICE] * MESH_SHARDS)}
            if torch.cuda.device_count() > 1:
                meshes["cards"] = make_mesh()
            scene = load_scene(str(SCENE / FRAMES), pose_files=str(SCENE / FRAMES.replace(".png", "_pose.txt")),
                               external_focal_length=FOCAL)
            enc = torch_io.load_encoder(ENCODER, DEVICE)
            # the mapping recipe of phase profile (the pipeline's rounds)
            cfg = TrainConfig(schedule=ScheduleConfig(learning_rate_max=0.003), loss=ReproLossConfig(loss_type="tanh"),
                              pose_refinement="mlp", refine_calibration=True)
            hp = train_hp(cfg)
            # the map of phase mapping's fixed-pose run, else the shipped head
            reg_head_cfg, reg_head = map_head if map_head is not None else torch_io.load_head(HEAD, DEVICE)
            rec["registration_map"] = "mapping fixed_poses" if map_head is not None else str(HEAD.relative_to(ROOT))

            def sync_all() -> float:
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
                return time.perf_counter()

            def zero_counts():
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                fh.LAUNCHES_BY_DEVICE.clear()
                fh.LAUNCHES_BWD_BY_DEVICE.clear()

            def counts() -> dict:
                return {"fwd": dict(fh.LAUNCHES_BY_DEVICE), "bwd": dict(fh.LAUNCHES_BWD_BY_DEVICE)}

            def steps(trainer, state, buffer, n, mesh):
                ctx = trainer.mesh_ctx if mesh is not None else trainer.ctx
                return train_steps(state, buffer, ctx, hp, cfg, HeadConfig(), n, generator=trainer.generator, mesh=mesh)

            def timed_steps(trainer, state, buffer, mesh):
                t0 = sync_all()
                state, _ = steps(trainer, state, buffer, MESH_STEPS[1], mesh)
                dispatched = time.perf_counter() - t0
                wall = sync_all() - t0
                return state, {"steps_per_s": MESH_STEPS[1] / wall, "ms_per_step": wall / MESH_STEPS[1] * 1e3,
                               "host_ms_per_step": dispatched / MESH_STEPS[1] * 1e3}

            def leaves(state):
                return [t.float().cpu() for t in tree_leaves((state.head_params, state.pose_params, state.focal_g))]

            @contextlib.contextmanager
            def first_step(into: dict, reduce=None):
                """Record the first step's reduced (loss, inlier fraction,
                gradients) into `into`; `reduce` replaces the reduction of
                the mesh step (a control)."""
                real_apply, real_reduce = tt._apply_step, tt.reduce_sum

                def apply(state, loss, batch_inliers, grads, hp_, cfg_):
                    if not into:
                        into.update(loss=float(loss), inliers=float(batch_inliers),
                                    grads=[(p, g.float().cpu()) for p, g in named_leaves(grads)])
                    return real_apply(state, loss, batch_inliers, grads, hp_, cfg_)

                tt._apply_step = apply
                if reduce is not None:
                    tt.reduce_sum = lambda trees, dev: reduce(real_reduce, trees, dev)
                try:
                    yield into
                finally:
                    tt._apply_step, tt.reduce_sum = real_apply, real_reduce

            def grad_rel(got: dict, want: dict) -> dict:
                """Relative Frobenius difference of each gradient leaf, by path
                (absolute where the reference is zero)."""
                out = {}
                for (p, g), (_, w) in zip(got["grads"], want["grads"]):
                    n = float(w.norm())
                    out[p] = float((g - w).norm()) / (n if n > 0 else 1.0)
                return out

            def grads_within(rel: dict) -> bool:
                return all(r <= (MESH_GRAD_FC3_RTOL if p.startswith("/0/fc3/w") else MESH_GRAD_RTOL)
                           for p, r in rel.items())

            def held_steps(trainer, buf, mesh, init_gen, batch_gen, reduce=None):
                """MESH_STEPS[0] steps on `buf` from the trainer's start state
                and the batch generator's state: (start, params, losses, first
                step, state)."""
                trainer.init_generator.set_state(init_gen)
                trainer.generator.set_state(batch_gen)
                st = trainer.build_state()
                start = leaves(st)
                with first_step({}, reduce) as first:
                    st, stats = steps(trainer, st, buf, MESH_STEPS[0], mesh)
                return start, leaves(st), stats["loss"].cpu().numpy(), first, st

            failures = []

            def check(cond: bool, what: str) -> None:
                if not cond:
                    failures.append(what)

            # one device: the reference fill, the held steps, the timed steps
            one = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(), base_seed=2089)
            init_gen = one.init_generator.get_state()
            buffer = one.build_buffer()
            batch_gen = one.generator.get_state()
            zero_counts()
            start, params_one, loss_one, first_one, state = held_steps(one, buffer, None, init_gen, batch_gen)
            state, rec["one_device"] = timed_steps(one, state, buffer, None)
            rec["one_device"]["launches"] = counts()
            del state
            zero_counts()
            t0 = sync_all()
            reg_one = tdrv.register_frames(enc, reg_head, reg_head_cfg, scene, tdrv.RegistrationConfig(), device=DEVICE)
            reg_seconds = sync_all() - t0
            rec["one_device"].update(register_seconds=reg_seconds, frames_per_s=len(reg_one) / reg_seconds,
                                     register_launches=counts())
            # the one chunk's pass-1 draws of that run (the driver's generator
            # on the masks in frame order), indexed by scene frame: with them
            # injected, one device's registration at any chunk length draws
            # what the run above drew
            reg_cfg = tdrv.RegistrationConfig()
            order = tdrv._frame_order(len(scene), reg_cfg)
            with torch.inference_mode():
                mask_lr = _canvas_prologue(*tdrv._chunk_images(scene, order, DEVICE), 8)[1]
            gen = torch.Generator(device=DEVICE).manual_seed(reg_cfg.base_seed + 0x9E37)
            hyp = torch.empty((len(scene), reg_cfg.ransac.hypotheses, reg_cfg.ransac.max_tries, 4), dtype=torch.long,
                              device=DEVICE)
            hyp[torch.as_tensor(order, device=DEVICE)] = draw_hypothesis_indices(
                mask_lr.reshape(len(scene), -1), reg_cfg.ransac.hypotheses, reg_cfg.ransac.max_tries, gen)
            rec["one_device"]["injected_draws_vs_generator"] = compare_entries(
                np, tdrv.register_frames(enc, reg_head, reg_head_cfg, scene, reg_cfg, device=DEVICE, hyp_indices=hyp),
                reg_one)
            by_lane = {}  # one device's registration in chunks of a lane's length, by that length
            mesh_launches = {"fwd": 0, "bwd": 0}
            for name, mesh in meshes.items():
                out = rec[name] = {"devices": [str(d) for d in mesh.devices]}
                per_step = Counter(d.index for d in mesh.devices)  # each position adds one launch a step
                trainer = MappingTrainer(scene, enc, HeadConfig(), cfg, BufferConfig(), base_seed=2089, mesh=mesh)
                t0 = sync_all()
                shards = trainer.build_buffer()
                out["fill_seconds"] = sync_all() - t0
                rows = sum(sh["features"].shape[0] for sh in shards)
                out["buffer_rows"] = rows
                out["fill_equal_rows"] = all(torch.equal(torch.cat([sh[k].to(DEVICE) for sh in shards]), buffer[k][:rows])
                                             for k in buffer)
                idx = torch.randint(0, rows, (MESH_GATHER_B,), device=DEVICE,
                                    generator=torch.Generator(device=DEVICE).manual_seed(7))
                parts = gather_rows(shards, idx, mesh)
                out["gather_bit_equal"] = all(torch.equal(torch.cat([pt[k].to(DEVICE) for pt in parts]), buffer[k][idx])
                                              for k in buffer)
                out["gather_part_devices"] = [str(pt["features"].device) for pt in parts]
                t0 = sync_all()
                for _ in range(20):
                    gather_rows(shards, idx, mesh)
                out["gather_ms"] = (sync_all() - t0) / 20 * 1e3
                t0 = sync_all()
                for _ in range(20):
                    {k: v[idx] for k, v in buffer.items()}
                out["index_ms"] = (sync_all() - t0) / 20 * 1e3
                del parts

                zero_counts()
                start_m, params_m, loss_m, first_m, state_m = held_steps(trainer, shards, mesh, init_gen, batch_gen)
                rel = np.abs(loss_m / loss_one - 1)
                out.update(loss_one=loss_one.tolist(), loss_mesh=loss_m.tolist(), loss0_rel=float(rel[0]),
                           loss_rel_max=float(rel.max()),
                           start_bit_equal=all(torch.equal(a, b) for a, b in zip(start_m, start)),
                           first_loss_rel=abs(first_m["loss"] / first_one["loss"] - 1),
                           first_inliers=[first_one["inliers"], first_m["inliers"]],
                           first_grad_rel=grad_rel(first_m, first_one),
                           update_rel_frob=rel_update(torch, tree_leaves, params_m, start, params_one),
                           param_rel_frob=rel_update(torch, tree_leaves, params_m, [0 * t for t in start], params_one))
                state_m, timing = timed_steps(trainer, state_m, shards, mesh)
                out.update(timing, launches=counts(),
                           over_one_device_steps_per_s=timing["steps_per_s"] / rec["one_device"]["steps_per_s"])
                total = sum(MESH_STEPS)
                want = {d: c * total for d, c in per_step.items()}
                out["launches_expected"] = want
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    state_m, _ = steps(trainer, state_m, shards, MESH_PROFILE_STEPS, mesh)
                    sync_all()
                out["mapping_overlap"] = device_busy(DeviceType, prof)
                # the controls, from the same start and draws: no update, and
                # the first part's gradients alone
                ctl_params = held_steps(trainer, shards, mesh, init_gen, batch_gen,
                                        reduce=lambda real, trees, dev: (*real(trees, dev)[:2], real(trees[:1], dev)[2]))
                out["controls"] = {
                    "no_update": {"update_rel_frob": rel_update(torch, tree_leaves, start, start, params_one)},
                    "first_part_grads": {"update_rel_frob": rel_update(torch, tree_leaves, ctl_params[1], start,
                                                                       params_one),
                                         "first_grad_rel_max": max(grad_rel(ctl_params[3], first_one).values()),
                                         "grads_within": grads_within(grad_rel(ctl_params[3], first_one))}}
                del ctl_params
                mesh_launches["fwd"] += sum(out["launches"]["fwd"].values())
                mesh_launches["bwd"] += sum(out["launches"]["bwd"].values())
                del trainer, shards, state_m

                calls = []
                real_coords = tdrv.coords_chunk

                def counted_coords(*a, **k):
                    calls.append(a[3].device.index)
                    return real_coords(*a, **k)

                tdrv.coords_chunk = counted_coords
                try:
                    zero_counts()
                    t0 = sync_all()
                    reg_m = tdrv.register_frames(enc, reg_head, reg_head_cfg, scene, tdrv.RegistrationConfig(), mesh=mesh)
                    reg_seconds = sync_all() - t0
                    out["register_launches"] = counts()
                    reg_calls = dict(Counter(calls))
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        tdrv.register_frames(enc, reg_head, reg_head_cfg, scene, tdrv.RegistrationConfig(), mesh=mesh)
                        sync_all()
                    out["registration_overlap"] = device_busy(DeviceType, prof)
                finally:
                    tdrv.coords_chunk = real_coords
                mesh_launches["fwd"] += sum(out["register_launches"]["fwd"].values())
                out.update(register_seconds=reg_seconds, frames_per_s=len(reg_m) / reg_seconds,
                           coords_calls_by_device=reg_calls, vs_one_device=compare_entries(np, reg_m, reg_one))
                # the same draws and the same batch on every device as one
                # device registering chunks of a lane's length: the same bits
                lane = N_FRAMES // mesh.size
                if N_FRAMES % mesh.size == 0 and tdrv._frame_chunk(reg_cfg, mesh) >= N_FRAMES:
                    if lane not in by_lane:
                        by_lane[lane] = tdrv.register_frames(enc, reg_head, reg_head_cfg, scene,
                                                             replace(reg_cfg, frame_chunk=lane), device=DEVICE,
                                                             hyp_indices=hyp)
                    same = tdrv.register_frames(enc, reg_head, reg_head_cfg, scene, reg_cfg, mesh=mesh, hyp_indices=hyp)
                    sb = out["same_batches"] = compare_entries(np, same, by_lane[lane])
                    # one device in chunks of a lane's length against one chunk
                    out["one_device_lane_chunks"] = compare_entries(np, by_lane[lane], reg_one)
                    check(sb["confident_bit_equal"] == sb["confident_frames"],
                          f"{name}: {sb['confident_bit_equal']} of {sb['confident_frames']} confident frames bit-equal "
                          f"to one device registering chunks of {lane} with the same draws")
                vs = out["vs_one_device"]
                check(out["fill_equal_rows"], f"{name}: the sharded fill differs from one device's")
                check(out["gather_bit_equal"], f"{name}: gather_rows differs from plain indexing")
                check(out["start_bit_equal"], f"{name}: the held steps start from other parameters than one device's")
                check(out["loss0_rel"] <= MESH_LOSS0_RTOL and out["first_loss_rel"] <= MESH_LOSS0_RTOL,
                      f"{name}: first loss {out['loss0_rel']} > {MESH_LOSS0_RTOL}")
                check(first_m["inliers"] == first_one["inliers"],
                      f"{name}: first step's inlier fraction {out['first_inliers']} differs")
                check(grads_within(out["first_grad_rel"]), f"{name}: first step's gradients {out['first_grad_rel']} "
                      f"beyond {MESH_GRAD_RTOL} (fc3's weight {MESH_GRAD_FC3_RTOL})")
                check(out["loss_rel_max"] <= MESH_LOSS_RTOL, f"{name}: losses {out['loss_rel_max']} > {MESH_LOSS_RTOL}")
                check(out["update_rel_frob"] <= MESH_UPDATE_RTOL,
                      f"{name}: parameter update {out['update_rel_frob']} > {MESH_UPDATE_RTOL}")
                ctl = out["controls"]
                check(ctl["no_update"]["update_rel_frob"] > MESH_UPDATE_RTOL,
                      f"{name}: the no-update control passes the update check: {ctl}")
                check(not ctl["first_part_grads"]["grads_within"],
                      f"{name}: the first-part-gradients control passes the gradient check: {ctl}")
                check(out["launches"]["fwd"] == want and out["launches"]["bwd"] == want,
                      f"{name}: launches {out['launches']} != {want} (one K1 and one K2 a part a step)")
                check(out["register_launches"]["fwd"] == reg_calls and set(reg_calls) == {d.index for d in mesh.devices}
                      and sum(reg_calls.values()) >= mesh.size,
                      f"{name}: registration launches {out['register_launches']} against chunks {reg_calls}")
                check(len(reg_m) == N_FRAMES and vs["validity_differs"] == 0 and not vs["inliers_apart_confident"],
                      f"{name}: registration validity or inliers differ: {vs}")
                check(vs["confident_within"] >= MESH_REG_SHARE * vs["confident_frames"]
                      and vs["max_trans_m"] <= MESH_REG_M_MAX and vs["max_rot_deg"] <= MESH_REG_DEG_MAX,
                      f"{name}: registered poses from one device's: {vs}")
            mesh_launches["by_mesh"] = {name: {"mapping": rec[name]["launches"], "registration": rec[name]["register_launches"]}
                                        for name in meshes}
            del buffer, one
            torch.cuda.empty_cache()
            require(not failures, "; ".join(failures))

    if "pretrain" in phases:
        with phase("pretrain", {}) as rec:
            from acezero_tpu_torch.cli import pretrain_cli, pretrain_depth_cli
            from acezero_tpu_torch.models.depthnet import init_depth_head_params
            from acezero_tpu_torch.pretrain import depth_pretrain as tdp
            from acezero_tpu_torch.pretrain import encoder_eval
            from acezero_tpu_torch.pretrain import encoder_pretrain as tep
            from acezero_tpu_torch.training.optim import adamw_init, tree_unflatten

            def to(tree, dev):
                return tree_unflatten(tree, [t.to(dev) for t in tree_leaves(tree)])

            rec.update(kind=kind, nvidia_smi=smi, encoder_args=PRETRAIN_ARGS, depth_cuts=DEPTH_PRETRAIN,
                       shortfit_iterations=SHORTFIT_ITERATIONS, cpu_rtol=PRETRAIN_CPU_RTOL)
            pretrain_launches = {}
            cfg = tep.PretrainConfig(contrastive_weight=0.2, steps=PRETRAIN_STEPS)  # the CLI's configuration
            with tempfile.TemporaryDirectory() as tmp:
                # 1. encoder pretraining through the CLI, counts zeroed just before
                enc_path = Path(tmp) / "enc.pt"
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = time.perf_counter()
                res = pretrain_cli.main([str(enc_path), *PRETRAIN_ARGS, "--device", DEVICE])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                pretrain_launches["encoder"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD}
                hist, means = res["history"], res["chunk_means"]
                trained = torch_io.load_encoder(enc_path, DEVICE)
                shipped = torch_io.load_encoder(ENCODER)
                rec["encoder"] = {
                    "cli_seconds": wall, "corpus_seconds": res["corpus_seconds"],
                    "train_seconds": res["train_seconds"], "steps": res["steps"],
                    "ms_per_step": res["train_seconds"] / res["steps"] * 1e3,
                    "steps_per_s": res["steps"] / res["train_seconds"],
                    "history": hist, "chunk_means": means,
                    "fused_head_fwd_launches": fh.LAUNCHES, "fused_head_bwd_launches": fh.LAUNCHES_BWD,
                    "launches_per_step": [fh.LAUNCHES / res["steps"], fh.LAUNCHES_BWD / res["steps"]]}
                want_launches = PRETRAIN_STEPS * cfg.batch_images
                require(res["steps"] == PRETRAIN_STEPS, f"the CLI ran {res['steps']} steps")
                require(all(np.isfinite(list(h.values())).all() for h in hist), f"a logged term is not finite: {hist}")
                require(means[-1]["coord_l2"] < means[0]["coord_l2"],
                        f"coord_l2 did not fall: {means[0]['coord_l2']} -> {means[-1]['coord_l2']} (chunk means)")
                require(means[-1]["contrast"] > 0, f"no positives in the last chunk: {means[-1]}")
                require({k: tuple(v["w"].shape) for k, v in trained.items()}
                        == {k: tuple(v["w"].shape) for k, v in shipped.items()},
                        "the written encoder does not have tpu_encoder_v6.pt's keys and shapes")
                require(pretrain_launches["encoder"] == {"fwd": want_launches, "bwd": want_launches},
                        f"K1/K2 launches {pretrain_launches['encoder']}, want {want_launches} each (one an image)")

                # 2. steps past the warm-up on the card and on the CPU, same parameters
                # and draws, on the corpus the CLI trained on
                t0 = time.perf_counter()
                corpus = res["corpus"]
                params = tep.init_params(cfg, corpus)
                draws = pretrain_draws(torch, tep, cfg, len(corpus["images_u8"]), PRETRAIN_CPU_STEPS, seed=1305)
                runs, after = {}, {}
                for dev in (DEVICE, "cpu"):
                    p = to(params, dev)
                    after[dev], _, st = tep.pretrain_chunk(
                        p, (adamw_init(p["encoder"]), adamw_init(p["heads"])), tep.corpus_to_device(corpus, cfg, dev),
                        PRETRAIN_CPU_STEP0, cfg, HeadConfig(num_head_blocks=cfg.head_blocks), draws=draws)
                    runs[dev] = {k: v.cpu().tolist() for k, v in st.items()}
                rel = {k: max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(runs[DEVICE][k], runs["cpu"][k]))
                       for k in tep.STATS}
                upd = {t: rel_update(torch, tree_leaves, after[DEVICE][t], params[t], after["cpu"][t])
                       for t in ("encoder", "heads")}
                rec["encoder_card_vs_cpu"] = {"step0": PRETRAIN_CPU_STEP0, "lr": tep._lr_at(cfg, PRETRAIN_CPU_STEP0),
                                              "card": runs[DEVICE], "cpu": runs["cpu"], "max_rel": rel,
                                              "update_rel": upd, "seconds": time.perf_counter() - t0}
                require(max(rel.values()) <= PRETRAIN_CPU_RTOL,
                        f"card and CPU pretraining steps differ by {rel} > {PRETRAIN_CPU_RTOL}")
                require(max(upd.values()) <= PRETRAIN_UPDATE_TOL,
                        f"card and CPU pretraining updates differ by {upd} > {PRETRAIN_UPDATE_TOL}")
                del corpus, params, runs, after, res

                # 3. the probes: match_score of the shipped and the new encoder, the short fit
                t0 = synced_clock(torch)
                m_v6 = encoder_eval.match_score(torch_io.load_encoder(ENCODER, DEVICE))
                t_match = synced_clock(torch) - t0
                m_new = encoder_eval.match_score(trained, **MATCH_TRAINED)
                fh.LAUNCHES = fh.LAUNCHES_BWD = 0
                t0 = synced_clock(torch)
                inl, med = encoder_eval.shortfit_score(torch_io.load_encoder(ENCODER, DEVICE),
                                                       iterations=SHORTFIT_ITERATIONS)
                t_fit = synced_clock(torch) - t0
                pretrain_launches["shortfit"] = {"fwd": fh.LAUNCHES, "bwd": fh.LAUNCHES_BWD}
                rec["probes"] = {"match_v6": m_v6, "match_v6_jax_cpu": MATCH_JAX_V6, "match_seconds": t_match,
                                 "match_trained": m_new, "match_trained_at": MATCH_TRAINED,
                                 "shortfit_v6_inlier10": inl, "shortfit_v6_med_px": med,
                                 "shortfit_min_inlier10": SHORTFIT_MIN_INLIER10, "shortfit_seconds": t_fit,
                                 "shortfit_launches": pretrain_launches["shortfit"]}
                require(abs(m_v6 - MATCH_JAX_V6) <= MATCH_TOL_PP,
                        f"match_score of v6 {m_v6:.3f} is not within {MATCH_TOL_PP} of the JAX package's {MATCH_JAX_V6:.3f}")
                require(np.isfinite(m_new) and np.isfinite(inl) and np.isfinite(med),
                        f"a probe is not finite: match {m_new}, shortfit {inl}, {med}")
                require(pretrain_launches["shortfit"]["bwd"] > 0, "the short fit never launched K2")
                require(inl >= SHORTFIT_MIN_INLIER10,
                        f"v6's short fit places {inl:.2f}% of cells within 10 px, under {SHORTFIT_MIN_INLIER10}%")

                # 4. seed-depth pretraining through the CLI, then its first steps card against CPU
                depth_path = Path(tmp) / "depth.pt"
                t0 = time.perf_counter()
                dres = pretrain_depth_cli.main([str(depth_path), "--encoder_path", str(ENCODER),
                                                *[a for k, v in DEPTH_PRETRAIN.items() for a in (f"--{k}", str(v))],
                                                "--device", DEVICE])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                dcfg = tdp.DepthPretrainConfig(**DEPTH_PRETRAIN)  # the CLI's configuration
                head = torch_io.load_depth_head(depth_path)
                t1 = time.perf_counter()
                images, gt = dres["corpus"]["images"], dres["corpus"]["gt_d8"]  # the CLI's corpus
                order = np.random.default_rng(dcfg.seed).integers(0, len(images), (min(dcfg.chunk_steps, dcfg.steps),
                                                                                   dcfg.batch_images))
                init = init_depth_head_params(torch.Generator().manual_seed(dcfg.seed), width_mult=dcfg.width_mult)
                runs, after = {}, {}
                for dev in (DEVICE, "cpu"):
                    p = to(init, dev)
                    after[dev], _, losses = tdp.train_chunk(
                        p, adamw_init(p), torch_io.load_encoder(ENCODER, dev), torch.from_numpy(images).to(dev),
                        torch.from_numpy(gt).to(dev), torch.from_numpy(order[:PRETRAIN_CPU_STEPS]).to(dev),
                        tdp.lr_table(dcfg), dcfg.silog_lambda, dcfg.grad_loss_weight)
                    runs[dev] = losses.cpu().tolist()
                drel = max(abs(a - b) / abs(b) for a, b in zip(runs[DEVICE], runs["cpu"]))
                dupd = rel_update(torch, tree_leaves, after[DEVICE], init, after["cpu"])
                rec["depth"] = {"cli_seconds": wall, "corpus_seconds": dres["corpus_seconds"],
                                "train_seconds": dres["train_seconds"],
                                "ms_per_step": dres["train_seconds"] / dcfg.steps * 1e3,
                                "steps_per_s": dcfg.steps / dres["train_seconds"], "chunk_losses": dres["chunk_losses"],
                                "head_layers": sorted(head), "card_vs_cpu": {"card": runs[DEVICE], "cpu": runs["cpu"],
                                                                             "max_rel": drel, "update_rel": dupd},
                                "card_vs_cpu_seconds": time.perf_counter() - t1}
                require(np.isfinite(dres["chunk_losses"]).all() and dres["chunk_losses"][-1] < dres["chunk_losses"][0],
                        f"the depth loss did not fall: {dres['chunk_losses']}")
                require(drel <= PRETRAIN_CPU_RTOL, f"card and CPU depth steps differ by {drel} > {PRETRAIN_CPU_RTOL}")
                require(dupd <= PRETRAIN_UPDATE_TOL,
                        f"card and CPU depth-head updates differ by {dupd} > {PRETRAIN_UPDATE_TOL}")
            torch.cuda.empty_cache()

    if "report" in phases:
        with phase("report", {}):
            def pick(entry, *keys):
                return {k: entry.get(k) for k in keys}

            fields = ("max_abs_err", "rel_err", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
            k1_reg, k1_map, k2_map = k1.get("registration", {}), k1.get("mapping", {}), k2.get("mapping", {})
            fwd = map_launches["fwd"] if map_launches else 0
            bwd = map_launches["bwd"] if map_launches else 0
            pipe_fwd = pipe_launches["fwd"] if pipe_launches else 0
            pipe_lc = pipe_launches["loop_closure"] if pipe_launches else None
            pipe_bwd = pipe_launches["bwd"] if pipe_launches else 0
            bare_fwd, bare_bwd = (bare_launches["fwd"], bare_launches["bwd"]) if bare_launches else (0, 0)
            spill_fwd, spill_bwd = (spill_launches["fwd"], spill_launches["bwd"]) if spill_launches else (0, 0)
            mesh_fwd, mesh_bwd = (mesh_launches["fwd"], mesh_launches["bwd"]) if mesh_launches else (0, 0)
            render_fwd = render_launches["export_cli"] + render_launches["regressor"] if render_launches else 0
            pre = pretrain_launches or {}
            pre_fwd, pre_bwd = (pre["encoder"]["fwd"], pre["encoder"]["bwd"]) if pre else (0, 0)
            fit_fwd, fit_bwd = (pre["shortfit"]["fwd"], pre["shortfit"]["bwd"]) if pre else (0, 0)
            k1_pre, k2_pre = k1.get("pretrain", {}), k2.get("pretrain", {})
            shape_fields = ("B", "L", "kernel_ms", "kernel_ms_stream", "plain_ms", "library_ms", "bound_ms",
                            "bound_by", "rel_err", "max_abs_err")
            emit(kernels=[{
                "name": "fused_head_fwd",
                "route": "cuda",
                "source": "acezero_tpu_torch/ops/csrc/fused_head_fwd.cu",
                "replaces": "acezero_tpu/ops/fused_head.py:108",
                "replaces_function": "acezero_tpu/ops/fused_head.py::_forward_kernel",
                "launches": ((launches or 0) + fwd + (lc_launches or 0) + pipe_fwd + bare_fwd + render_fwd + spill_fwd
                             + mesh_fwd + pre_fwd + fit_fwd),
                "launches_by_path": {"register": launches, "mapping": fwd if map_launches else None,
                                     "loopclose": lc_launches, "pipeline": pipe_fwd if pipe_launches else None,
                                     "pipeline_loop_closure": pipe_lc, "bare": bare_fwd if bare_launches else None,
                                     "bare_render_hooks": (len(bare_launches["render_shapes"]) if bare_launches
                                                           else None),
                                     "render": render_fwd if render_launches else None,
                                     "spill": spill_fwd if spill_launches else None,
                                     "mesh": mesh_fwd if mesh_launches else None,
                                     "pretrain": pre_fwd if pre else None,
                                     "pretrain_shortfit": fit_fwd if pre else None},
                # phase mesh's launches by mesh, run and device index
                "mesh_launches": mesh_launches["by_mesh"] if mesh_launches else None,
                # [B, L] of each loop-closure launch, recorded where it was made
                "loop_closure_shapes": {"loopclose": lc_shapes,
                                        "pipeline": pipe_launches["loop_closure_shapes"] if pipe_launches else None},
                # [B, L] of each launch of phase bare's point-cloud export
                "export_shapes": bare_launches["export_shapes"] if bare_launches else None,
                # [B, L] of each launch of phase bare's render hooks (one point
                # cloud a registration round), and of phase render's
                # export_cli --network and Regressor runs
                "render_hook_shapes": bare_launches["render_shapes"] if bare_launches else None,
                "render_shapes": render_launches["shapes"] if render_launches else None,
                **pick(k1_reg, *fields),
                "ms": k1_reg.get("kernel_ms"),
                "shape": pick(k1_reg, "B", "L"),
                **pick(k1_reg, "kernel_ms_stream", "launch_overhead_ms", "rel_err_vs_library", "tflops",
                       "tflops_stream", "sm_fill"),
                "mapping_shape": pick(k1_map, "B", "L", "kernel_ms", "kernel_ms_stream", "launch_overhead_ms",
                                      "plain_ms", "library_ms", "bound_ms", "bound_by", "rel_err",
                                      "rel_err_vs_library"),
                "pretrain_shape": pick(k1_pre, *shape_fields),
                "other_shapes": {name: pick(e, "B", "L", "kernel_ms", "kernel_ms_stream", "tflops", "sm_fill")
                                 for name, e in k1.items() if name not in ("registration", "mapping")},
            }, {
                "name": "fused_head_bwd",
                "route": "cuda",
                "source": "acezero_tpu_torch/ops/csrc/fused_head_bwd.cu",
                "replaces": "acezero_tpu/ops/fused_head.py:112",
                "replaces_function": "acezero_tpu/ops/fused_head.py::_backward_kernel",
                "launches": bwd + pipe_bwd + bare_bwd + spill_bwd + mesh_bwd + pre_bwd + fit_bwd,
                "launches_by_path": {"register": 0, "mapping": bwd if map_launches else None,
                                     "loopclose": 0 if lc_launches is not None else None,
                                     "pipeline": pipe_bwd if pipe_launches else None,
                                     "bare": bare_bwd if bare_launches else None,
                                     "render": 0 if render_launches else None,
                                     "spill": spill_bwd if spill_launches else None,
                                     "mesh": mesh_bwd if mesh_launches else None,
                                     "pretrain": pre_bwd if pre else None,
                                     "pretrain_shortfit": fit_bwd if pre else None},
                **pick(k2_map, *fields, "kernel_ms_stream", "tflops", "tflops_stream", "smem_bytes", "sm_fill"),
                "ms": k2_map.get("kernel_ms"),
                "shape": pick(k2_map, "B", "L"),
                "pretrain_shape": pick(k2_pre, *shape_fields),
                "other_shapes": {name: pick(e, "B", "L", "kernel_ms", "kernel_ms_stream", "tflops", "sm_fill")
                                 for name, e in k2.items() if name != "mapping"},
            }])

    if handoff is not None:
        Path(handoff).write_text(json.dumps({
            "map_launches": map_launches, "lc_launches": lc_launches, "lc_shapes": lc_shapes,
            "pipe_launches": pipe_launches, "bare_launches": bare_launches, "render_launches": render_launches,
            "spill_launches": spill_launches, "mesh_launches": mesh_launches, "pretrain_launches": pretrain_launches}))
        return 0
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
