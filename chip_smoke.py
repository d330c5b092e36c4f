"""Smoke run of the PyTorch port (snvc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # the check
    python3 chip_smoke.py --profile    # also profile one request of each
                                       # serving path and one training step
                                       # (lines "profile_request")

Phases, each printing one line with its elapsed seconds:
  1. device  - the card's name; nvidia-smi's name and power limit;
  2. build   - nvcc builds every CUDA kernel, and each kernel's ptxas
               registers and spills are printed (the two wgmma conv
               kernels must spill nothing and keep their wgmma
               unserialized; K3 and K4, forward and backward, must spill
               nothing);
  3. K1      - the stereo voxel sampler kernel against its plain version
               (small shapes; the flagship shape at uniform random
               projections and at a seeded flagship batch's own), with
               kernel (the path's projections; kernel_ms_random beside it)
               / plain / F.grid_sample times and the memory bound;
  4. K2      - the large-tap 3D conv kernel against its plain version for
               the three flagship convs and two ragged shapes, with kernel
               / plain / F.conv3d times, TFLOP/s and the share of the
               tensor-core bound per conv;
  5. K3      - the plane-sweep cost volume kernel against its plain
               version (small shapes with shared and per-sample shift
               tables, shifts of 0, integer, fractional and past the row;
               the detect shape with a [2, 64] table), with kernel / plain
               / library times and the memory bound; the library call
               (a 5-D F.grid_sample of the right half + a cat, bf16) is
               first held to the plain version in float32 at the edge
               table (its relative error printed);
  6. K4      - the frustum -> voxel kernel against its plain version (small
               and detect shapes), with kernel / plain / F.grid_sample
               times and the memory bound;
  7. serving - a flagship RefineRunner (hrnet-w32, 32x192x192 grid, 4
               instances, bf16, seeded random weights) answers one warm-up
               and three requests; the launch counters must show K1 once
               and K2 three times per request; a small model's outputs on
               the card must agree with the same model on the CPU
               (phase "reference");
  8. detect  - a full-width DetectRunner (StereoConfig(): reslike-det-small,
               384x1248 pair, 64 planes, 288x300x20 BEV grid, bf16, seeded
               random weights) answers one warm-up and three requests; the
               counters must show K3 and K4 once per request and K1 / K2
               not at all; a tiny StereoNet on the card must agree with
               the same weights on the CPU (phase "stereo_reference");
  9. K1_bwd  - the sampler's backward kernel against its plain version
               (small shapes with the grid gradient; the training shape at a
               seeded batch's projections, and with every point of an
               instance on one 2x2 tap patch, float32 and bf16), with
               kernel (the batch's projections, no grid gradient; the one-
               patch time beside it) / plain / F.grid_sample-backward times
               and the memory bound;
 10. K2_bwd  - dx (the K2 kernel on flipped weights) and dw (the split-K
               weight-gradient kernel) of the three prelude convs at the
               training shape and of two ragged shapes, against the
               per-tap conv's float32 autograd, with kernel / plain /
               cuDNN (torch.nn.grad) times, TFLOP/s and the share of the
               tensor-core bound per conv;
 11. K5      - the k3 conv (the K2 kernel at a 3x3x3 tap) forward and
               backward against the plain version at a stereo 3D-stack
               shape and at the JAX tests' [1, 4, 8, 16, 128] -> 32, with
               F.conv3d / conv3d_input / conv3d_weight times beside the
               forward, dx and dw;
 12. train_reference - one training step of a small float32 model on the
               card against the same step on the CPU (losses, every
               gradient, BatchNorm statistics, parameters after the next
               step), then in bf16 held to three times the CPU's own bf16
               drift (+1 % of scale);
 13. train   - the default training config (VernierConfig(): hrnet-w32,
               16x96x96 grid, 256x256 ROIs, 384x1280 images, 8 instances,
               bf16, remat; TrainConfig with warmup_steps=2) takes 12 steps
               on one seeded batch; the loss must be finite and fall, and
               the counters must show per step K1 1 + 1 backward, K2 3 +
               3 dx, dw 3, K3 = K4 = K5 = 0;
 14. K3_bwd  - the plane sweep's backward kernel against its plain version
               (small shapes, shared and per-sample tables with the edge
               shifts; the training shape [1, 64, 96, 312, 64] bf16 at the
               default calibration's table, and N = 2 with a [2, 64] edge
               table), within 2 bf16 ulp of the largest value, with kernel
               / plain / library (K3's library call's backward) times and
               the memory bound;
 15. K4_bwd  - the frustum resample's backward (d volume: a plan kernel,
               then the main kernel) against its plain version (small
               shapes with per-sample calibration; planes and feature rows
               that receive nothing and near rows; the training shape,
               gradient [1, 288, 300, 20, 32] bf16 -> [1, 64, 96, 312,
               32], its plan first held to the plain plan bit for bit),
               within 2 bf16 ulp of the largest value (and the training
               shape in float32 within 1e-5 of it), with kernel (both
               launches) / plain / F.grid_sample-backward times, the
               memory bound and the feature rows with work; then P's
               gradient at the training shape (K4's forward, autograd of
               the gather form) against the same on the CPU from the
               plain forward, each row within 2 bf16 ulp of its largest
               entry;
 16. stereo_train_reference - one training step of a tiny float32
               StereoNet (no SPP branches, cuDNN off) on the card against
               the same step on the CPU (losses, every gradient, BatchNorm
               statistics, parameters after the next step), then in bf16
               held to three times the CPU's own bf16 drift (+1 % of
               scale);
 17. stereo_train - StereoConfig() (reslike-det-small, 384x1248, 64 planes,
               288x300x20 BEV, bf16), batch 1, one seeded training frame
               with 4 cars, TrainConfig with warmup_steps=2: 12 steps; the
               loss must be finite and fall, and the counters must show
               per step K3 1 + 1 backward, K4 1 + 1 backward, K1 = K2 =
               K5 = 0.
 18. two_stage - two-stage serving over a seeded KITTI tree through the
               port's CLIs (``main(argv)``): 4 frames x 3 cars written as
               375x1242 PNGs with all five row filters (``decode_png``
               must give the arrays back bit for bit; decode ms a frame),
               the detect CLI with a seeded StereoConfig() model
               (counters K3 = K4 = 4, K1 = K2 = 0; every file parses, at
               most --max_boxes lines), the inference_agnostic CLI with a
               seeded flagship model on write_predictions' 12 noisy-GT
               proposals (K1 = 4, K2 = 12; --prefetch 2 and 0 write the
               same bytes) and on stage 1's own proposals for 2 batches
               (K1 = 2, K2 = 6), and the evaluate CLI (built with g++
               here): the GT as predictions and the noisy proposals must
               score the AP values pinned from JAX's evaluator, and the
               refined output must give all four car metrics; each
               CLI's wall seconds (checkpoint load and first call
               included; stage 2 at --prefetch 2 and 0) and the g++ build
               seconds of the evaluator and of the PNG helper, beside
               nvidia-smi's name and power limit.
 19. two_stage_warm - both runners with those checkpoints loaded and
               warm: every request of the split queued under torch's sync
               debug mode, which must see no host sync (the host's queueing
               ms beside the ms until the card is done), and ``run`` over
               the split at --prefetch 2 and 0 (median ms of 3 each).
 20. train_cli - the two training CLIs on that tree, at full width, into
               experiment directories in the same temporary directory:
               train_vernier at its default config for 4 steps, then
               --resume to 6 (the loaded state must equal the saved one bit
               for bit; metrics.jsonl 6 lines), with the offset and bbox
               heads for 2 steps (their losses and gradients finite); per
               step K1 1 + 1 backward, K2 3 + 3 dx, dw 3; train_stereo at
               StereoConfig(), batch 1, --augment_flip --photometric_aug
               for 4 steps (per step K3 1 + 1 backward, K4 1 + 1
               backward); then detect on the trained stereo directory (K3 =
               K4 = frames) and inference_agnostic --report_loss on the
               trained Vernier one with the GT as proposals (K1 = batches,
               K2 = 3 x batches; finite losses a batch); each CLI's median
               step ms, wall seconds and checkpoint save seconds.
 21. variants - the other Vernier heads and inputs: K1 and its backward
               at C = 48 and K2 / dx / dw at the hrnet-w48 head's widths
               (96 -> 48, 48 -> 48) against their plain versions, with
               kernel / plain / library times and bounds; a small model of
               each head (3D, BEV, BEV_type2, BEV_type3 with add_xy and
               concat-atten) on the card against the CPU, float32 within
               1e-3 of scale, then bf16 under phase reference's rule;
               flagship serving (1 warm-up + 3 requests) of BEV_type2 (K1
               x1, K2 x3 a request), BEV (K1 x1) and w48 (BEV_type3,
               hrnet-w48, add_xy, concat-atten: K1 x1, K2 x3); the 3D
               head's forward at the flagship width ([4, 9, 32, 192, 192]
               finite, K1 x1) and RefineRunner's refusal of it; 8 training
               steps at VernierConfig() of 3D (grid_type "3D"), BEV_type2,
               BEV and w48 (per step K1 1 + 1 backward; K2, dx, dw 3 each
               for BEV_type2 and w48); median request / step ms and peak
               memory each, beside nvidia-smi's name and power limit.
 22. synthetic_world - the port's renderer (no cv2) on the host: a
               4-frame KITTI tree (3 cars a frame) and a 6-frame moving-car
               sequence, seconds a frame (files included) and a view
               (render alone); the tree rendered again from its seed gives
               the same bytes; every PNG decodes (``decode_png``) to the
               array rendered.
 23. track   - the tracking CLI (``tools/track.py``) over that sequence
               with a seeded flagship model (BEV_type3, hrnet-w32,
               32x192x192, bf16) saved as a model directory, at --motion
               static and cv (wall seconds, model load included): K1 =
               frames and K2 = 3 x frames a run, finite boxes; then the
               loaded tracker warm over the sequence, ms a frame.
 24. demos   - the three end-metric demos through ``main(argv)`` at cut
               sizes (each cut in the phase's line): demo_ap_lift (20
               steps, 4 train frames, 2 val frames), demo_tracking (20
               steps, 4 train frames, 4 sequence frames), demo_two_stage
               (10 stereo + 10 Vernier steps, 4 train frames, 2 val
               frames); each writes its JSON with JAX's keys and finite
               values; counters per Vernier step K1 1 + 1 backward, K2 3 +
               3 dx, dw 3, per stereo step K3 1 + 1, K4 1 + 1, and per
               served batch / frame K1 x1, K2 x3 / K3 x1, K4 x1; wall
               seconds each.
 25. parallel - data parallelism (parallel/api.py).  Two gloo ranks
               share the card (NCCL refuses two ranks on one GPU; the
               ranks share its SMs, so their step time is no scaling
               figure), started as a launcher starts them
               (``initialize_multihost``): two steps of VernierConfig()
               at the global batch of 8 (4 a rank) and of StereoConfig()
               at 2 pairs (1 a rank), in bf16 and (step 0) in float32;
               the float32 step 0 against the one-process step on the
               same global batch under phase train_reference's rule
               (losses 1e-4, grad_norm 3e-3; bf16 differences printed:
               the card's convolutions give other bits at 4 instances
               than at 8), the ranks agreeing, per rank and bf16 step
               K1 1 + 1, K2 3 + 3 dx, dw 3 / K3 1 + 1, K4 1 + 1; the
               warm bf16 step's ms and peak memory a rank beside the
               one-process step's (phase train's median; a 2-pair stereo
               step).  The flagship
               RefineRunner and the full-width DetectRunner (2 frames)
               on a mesh [cuda:0, cuda:0] against the one-device runner
               (1 warm-up + 2 requests each; largest differences printed,
               request ms; K1 2, K2 6 / K3 2, K4 2 a request), and phase
               reference's small models on that mesh under reference's
               bf16 rule.  First, train_vernier through torchrun in a
               one-rank NCCL group (2 steps of hrnet-tiny on a seeded
               1-frame tree) while the one-process float32 steps run.
 26. tensor_parallel - the mesh's "model" axis (parallel/tensor.py):
               first each kernel at the split paths' shapes against its
               plain version, timed with its bound (K1 and its backward
               on the nl slab of a flagship request, 32x192x96; K2 / dx /
               dw on the three prelude convs' slabs widened by their
               halos to 102, 100 and 104 lengths; K3 and its backward on
               each 32-plane slab of StereoConfig(); K4 and its backward
               on the gathered volume); then every path in this process
               and on two gloo ranks sharing the card at n_data 1,
               n_model 2 (``initialize_multihost(..., n_model=2)``): the
               full-width DetectRunner (1 warm-up + 2 bf16 frames, 1
               float32 frame), a StereoConfig() step (batch 1) and a
               flagship-grid Vernier step (32x192x192, 8 instances),
               each 2 bf16 steps and a float32 step 0; the ranks agree
               (1e-5 in float32, 1e-2 in bf16: each computes the
               replicated layers itself), the float32 steps lie within
               phase train_reference's rule of this process's, the
               float32 detections' scores within 1e-3 (bf16 differences
               printed);
               per rank K3 = K4 = 2 a 2-frame serve, per bf16 step K3 1 +
               1, K4 1 + 1 / K1 1 + 1, K2 / dx / dw 3, each K2 input 102,
               100 or 104 lengths wide; ms and peak memory a rank beside
               this process's ("two ranks share one card: no scaling
               figure").
 27. tensor_parallel_local - the one-process form of the data x model
               mesh (parallel/local.py: a thread a position, one
               backward), on the card: first K1 / K1 bwd on the flagship
               grid's uneven nl slabs at n_model 5 (48 and 32 lengths),
               K2 / dx / dw on their slabs widened by the prelude's halos
               (54 / 52 / 56 and 38 / 36 / 40) and K3 / K3 bwd on
               StereoConfig()'s slabs at n_model 3 (24 / 20 / 20 planes),
               each against its plain version, timed with its bound; then
               make_mesh(1, [cuda:0, cuda:0], 2): phase tensor_parallel's
               paths (DetectRunner 1 warm-up + 2 bf16 frames and 1
               float32, a StereoConfig() step, a flagship-grid Vernier
               step at 8 instances: 2 bf16 steps, a float32 step 0), the
               float32 ones within train_reference's rule of phase
               tensor_parallel's one-device runs and of its gloo ranks,
               the float32 scores within 1e-3 of the largest; uneven
               slabs: StereoConfig() at n_model 3 and the flagship grid at
               n_model 5 (a bf16 and a float32 step each, the latter
               under the same rule); the 3D and BEV heads at n_model 2
               (a small float32 step each against its one-device step);
               launches a position (the forward kernels by thread) and in
               all, K2's input widths, ms and peak memory beside the
               one-device runs' ("positions share one card: no scaling
               figure"); the one-device float32 flagship-grid step run
               twice in this process, then twice with
               cudnn.deterministic: each pair's gap in grad_norm and in
               the encoder's and the head's gradients.  The Vernier
               step on make_mesh(1, [cuda:0, cuda:0], 2) rematerializes
               its 3D hourglass (cfg.remat, as JAX on its mesh: the
               recompute replays the forward's collectives); beside it
               the same step without remat, 4 bf16 steps each: the
               float32 step 0 with remat within train_reference's rule
               of the one without, per position and bf16 step K1 1 and
               K2 3 (K1 / K1 bwd 8, K2 / dx / dw 24 in all), each
               position's 3D hourglass forward twice a step with remat
               and once without, as many rendezvous meetings either way;
               step ms (the warm steps' median) and peak memory of both.  Last, the flagship prelude's conv3_k5_d2 (K2, a
               4-length halo) on 8 lengths over make_mesh(1, [cuda:0] *
               4, 4): slabs of 2 lengths, each halo reaching two slabs,
               the output, dx and dw against the whole layer's on the
               card: float32 within 1e-4 of scale, bf16 the output under
               K2's rule and the gradients under assert_split_sum.
 28. tensor_parallel_padded - the model axis at every extent JAX's mesh
               splits (a short last unit, positions that hold no plane),
               on the one-process mesh: K1 / K1 bwd on the trained
               Vernier model's slabs (32, 16 and the short 12 of a
               44-length grid), K2 / dx / dw on them widened by the
               prelude's halos, K3 / K3 bwd on a 4-plane slab, each
               against its plain version and timed with its bound, and
               each wrapper on an empty slab returning without a launch;
               then the repo's trained model
               (artifacts/two_stage_r4_torch/vernier) trained from its
               checkpoint on make_mesh(1, [cuda:0]*4, 4) (16 / 16 / 16 /
               0), (1, 2) (32 / 16) and on a 44-length grid at n_model 4
               (16 / 16 / 12 / 0), and StereoConfig(num_depths=8) served
               (1 warm-up, 1 bf16 and 1 float32 frame) and trained at
               n_model 3 (4 / 4 / 0): float32 against the one-device runs
               under phase tensor_parallel's rules, the launches by
               position thread (none on the empty one, K4 on every
               position's gathered volume), ms and peak memory beside the
               one-device runs'.
 29. release_checkpoint - the reference's checkpoints in the port: a
               fabricated reference state_dict of a small BEV_type3 model
               (hrnet-tiny, the part-offset and bbox heads) converted by
               utils/convert_torch, on the card against the CPU (float32
               within 1e-3 of scale, bf16 under phase reference's rule);
               a fabricated tar at validate_epoch80.release_config
               (hrnet-w48, GroupNorm, 32x192x192, 256x256 ROIs, 8
               instances, bf16) through validate_epoch80.main over a
               seeded 4-frame x 3-car val tree with noisy-GT proposals
               (K1 = batches, K2 = 3 x batches; validation.json with
               JAX's keys, finite), with the tar's tensor count, its load
               and conversion seconds, the median ms of a warm batch, the
               peak memory and the wall seconds; diagnose_proposals.main
               on phase demos' demo_two_stage directory (a seeded one
               when run alone): K3 = K4 = frames decoded, the coverage
               keys present, roiaware_pool3d on the card against the CPU
               (max and avg; avg twice gives the same bits).
 30. native_loader - the 256 PNGs of phase trained_two_stage's val split
               decoded into the trained config's canvas by png.decode_png
               + _place, by native_loader.decode_png_padded one view at a
               time and by decode_batch_padded 8 views at a time: the
               same bytes; ms a view each on the card's host beside
               nproc; load_velodyne equals np.fromfile; a missing PNG
               raises; 46 seeded files of every other PNG kind
               (PNG_KINDS: each colour type and bit depth, PLTE, tRNS,
               Adam7) decode to their known RGB in the three readers.
 31. trained_two_stage - JAX's trained two-stage run
               (artifacts/two_stage_r4) through the port's CLIs with the
               committed conversions of its checkpoints
               (artifacts/two_stage_r4_torch) over its 128-frame val split
               (make_synthetic_kitti(root, 128, 3, seed=1000), drawn by a
               child process on the host while the earlier phases run;
               its seconds printed): bf16 (the checkpoints' dtype) detect
               over every frame at demo_two_stage's stage-1 settings (K3 =
               K4 = 128), inference_agnostic on JAX's 181 committed
               proposals and on the port's own (K1 = batches, K2 = 3 x
               batches; the argmax decode, both pred types), every AP3D
               moderate beside JAX's recorded bf16 TPU run (witnesses,
               not gates); float32 with TF32 off: the 181 proposals
               refined and held to JAX's float32 CPU output
               (artifacts/two_stage_r4_torch/witness: AP3D moderate within
               0.05 of JAX's for each pred type; boxes over 1e-3 and the
               largest field difference printed), and with cuDNN off too
               stage 1 on the first 16 frames held to JAX's (boxes paired
               by nearest BEV centre, every field within 1e-3 m / rad; a
               box on one side only passes when its score lies within
               1e-3 of the 0.02 threshold); diagnose_refinement over the
               run's work dir (K1 = 3 x batches, K2 = 9 x batches; each
               decode's row printed); visualize over 4 frames in both
               modes (PNGs decode at their sizes; each projected corner
               of a drawn edge drawn within 1 px); inference_agnostic
               --debug over one batch (K1 1, K2 3; the NCF panels'
               brightest pixels on their parts' argmax cells); each
               stage's wall seconds beside those measured when each
               view was decoded alone by data/png.py (the images now
               come through the native loader).
 32. profile - tools/profile_vernier.py --config flagship --batch 4 and
               tools/profile_stereo.py (StereoConfig(), bf16) in child
               processes: every stage line and JSON printed, K1 / K2
               (Vernier) and K3 / K4 (stereo) launched there; one
               flagship refinement request under utils.profiling.trace
               (K1 1, K2 3): its trace file names the K1 and K2 kernels;
               device_memory_stats() after it, its peak printed.
Then a {"kernels": [...]} line (launches: the serving, detect and
training phases' counts plus train_cli's, variants', track's, demos',
parallel's, tensor_parallel's, tensor_parallel_local's,
tensor_parallel_padded's, release_checkpoint's,
trained_two_stage's and profile's traced request's), nvidia-smi's line,
and as the last line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero
before the last line; without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from snvc_tpu_torch import _build
from snvc_tpu_torch.config import (
    BackboneConfig,
    StereoConfig,
    TrainConfig,
    VernierConfig,
    flagship_vernier_config,
    load_config,
    save_config,
    tiny_stereo_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.data.instance_db import build_db_from_predictions
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.pipeline import RefinementPipeline
from snvc_tpu_torch.data.png import decode_png, encode_png
from snvc_tpu_torch.data.stereo import normalize_images, synthetic_stereo_request
from snvc_tpu_torch.data.stereo_pipeline import StereoPipeline
from snvc_tpu_torch.data import native_loader, synthetic
from snvc_tpu_torch.data.synthetic import (
    IMG_H,
    IMG_W,
    box2d_of,
    calib_text,
    make_synthetic_kitti,
    make_synthetic_sequence,
    random_box,
    surface_points,
    synthetic_batch_arrays,
    write_predictions,
)
from snvc_tpu_torch.eval.kitti_ap import build_evaluator
from snvc_tpu_torch.geometry.calib import (
    Calibration,
    KittiLabel,
    format_label,
    read_label,
    ry_to_alpha,
)
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.inference.track import Tracker
from snvc_tpu_torch.models.stereonet import (
    StereoNet,
    _bev_axes,
    depth_hypotheses,
    plane_shifts,
)
from snvc_tpu_torch.models.vernier import VernierScale, length_levels
from snvc_tpu_torch.ops.conv3d_fold import (
    conv3d_input_grad,
    conv3d_large_tap,
    conv3d_pertap,
    conv3d_weight_grad,
    conv3d_weight_grad_plain,
    conv3d_work,
    flip_weight,
)
from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3
from snvc_tpu_torch.ops.cost_volume import (
    plane_sweep_shifted,
    plane_sweep_shifted_bwd,
    k3_bwd_work,
    k3_work,
    plane_sweep_volume_k3,
    plane_sweep_volume_k3_bwd,
)
from snvc_tpu_torch.ops.frustum import (
    _project_uv,
    frustum_tables,
    frustum_to_voxel_k4,
    frustum_to_voxel_k4_bwd,
    frustum_to_voxel_k4_bwd_plan,
    frustum_to_voxel_separable,
    frustum_to_voxel_separable_bwd,
    k4_bwd_plan,
    k4_bwd_work,
    k4_planes,
    k4_work,
)
from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import (
    k1_bwd_work,
    k1_work,
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)
from snvc_tpu_torch.parallel.api import initialize_multihost, make_mesh
from snvc_tpu_torch.parallel.tensor import slab_bounds
from snvc_tpu_torch.ops.points_in_boxes import roiaware_pool3d
from snvc_tpu_torch.tools import demo_ap_lift, demo_tracking, demo_two_stage
from snvc_tpu_torch.eval.witness import compare_matched, compare_ordered
from snvc_tpu_torch.tools import diagnose_proposals, validate_epoch80
from snvc_tpu_torch.tools import diagnose_refinement
from snvc_tpu_torch.tools import detect as cli_detect
from snvc_tpu_torch.tools import evaluate as cli_evaluate
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.tools import track as cli_track
from snvc_tpu_torch.tools import train_stereo as cli_train_stereo
from snvc_tpu_torch.tools import train_vernier as cli_train_vernier
from snvc_tpu_torch.tools._model_dir import load_model
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    learning_rate,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from snvc_tpu_torch.training.train_stereo import (
    create_stereo_state,
    make_stereo_train_step,
    stereo_batch_to_device,
)
from snvc_tpu_torch.utils.cost import count_cost
from snvc_tpu_torch.utils.convert_torch import (
    convert_vernier_checkpoint,
    fabricate_vernier_state_dict,
    load_torch_checkpoint,
)

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# float32 outside the tensor cores, HBM3 bandwidth; the bounds below are
# against these.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the stereo 3D stack's first conv input: the [1, 64, 96, 312, 64] plane-
# sweep volume of StereoConfig()
STEREO_STACK = (1, 64, 96, 312, 64)

T0 = time.perf_counter()


def phase(label: str, t_start: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{label}] {time.perf_counter() - t_start:.2f}s {body}", flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """(kernel, registers, spill bytes, ptxas performance notes) of each
    kernel in an ``nvcc -Xptxas -v`` log; template kernels keep their
    arguments (``conv3d_large_tap_kernel<32,1,1,7>``)."""
    out, fn, spills, notes = [], "?", 0, {}
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn, spills = short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"\((C75\d\d)\).*function '(\S+)'", ln)
        if m:
            notes.setdefault(short_name(m.group(2)), []).append(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append([fn, int(m.group(1)), spills])
    return [(f, r, sp, notes.get(f, [])) for f, r, sp in out]


TEMPLATE_ARG = r"Li(-?\d+)E|(f)|13(__nv_bfloat16)"


def short_name(mangled: str) -> str:
    """``_ZN..23conv3d_large_tap_kernelILi32ELi1ELi1ELi7EEEv..`` ->
    ``conv3d_large_tap_kernel<32,1,1,7>``, ``..IfLi2EE..`` -> ``<f32,2>``
    (Itanium names: a length, then the identifier)."""
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
        end = m.end() + int(m.group(1))
        name = mangled[m.end():end]
        if name.endswith("_kernel"):
            args = re.match(rf"I((?:{TEMPLATE_ARG})+)E", mangled[end:])
            if args:
                name += "<" + ",".join(
                    i or ("f32" if f else "bf16")
                    for i, f, _ in re.findall(TEMPLATE_ARG,
                                              args.group(1))) + ">"
            return name
    return mangled


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_of(work, peak_flops: float) -> float:
    """The least ms for a kernel's declared work (``utils.cost.Work``, the
    formula beside the kernel that ``count_cost`` reads too): the larger
    of its bytes over PEAK_BYTES and its operations over ``peak_flops``."""
    return max(work.bytes_accessed / PEAK_BYTES,
               work.flops / peak_flops) * 1e3


# ---------------------------------------------------------------- K1 ----
def k1_case(gen, N, Hf, Wf, C, grid, roi, dtype, dev):
    """Features and projections; a margin of the ROI puts some points
    outside the image so the zero-padding taps are exercised."""
    nh, nw, nl = grid
    P = nh * nw * nl
    lf = torch.randn((N, Hf, Wf, C), generator=gen).to(dev, dtype)
    rf = torch.randn((N, Hf, Wf, C), generator=gen).to(dev, dtype)
    lo, hi = -0.0625 * roi[1], 1.0625 * roi[1]
    gl = (torch.rand((N, P, 2), generator=gen) * (hi - lo) + lo).to(dev)
    gr = (torch.rand((N, P, 2), generator=gen) * (hi - lo) + lo).to(dev)
    return lf, rf, gl, gr


def batch_projections(cfg, seed, dev):
    """The [N, P, 2] ROI-pixel projections of both views that the path
    computes for one seeded synthetic batch (assemble_instances): ordered
    along the grid and clustered on the object, unlike k1_case's."""
    b = batch_to_device(synthetic_batch_arrays(cfg, seed=seed), dev)
    gl, gr = assemble_instances(
        b["images_left"], b["images_right"], b["image_idx"], b["trans_l"],
        b["trans_r"], b["samples"], b["P_left"], b["P_right"],
        torch.from_numpy(make_grid_local(cfg)).to(dev), cfg)[2:]
    return gl.float().contiguous(), gr.float().contiguous()


def check_k1(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, f32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        args = k1_case(gen, 2, 16, 16, 32, (4, 8, 8), (64, 64), dtype, dev)
        got = stereo_voxel_sample(*args, (64, 64), (4, 8, 8)).float()
        want = sample_stereo_voxel(*args, (64, 64), (4, 8, 8)).float()
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        err = (got - want).abs()
        # bf16: kernel and plain round the same f32 sum; they may differ by
        # one bf16 ulp (2^-7 relative) through a different fma order
        assert bool((err <= tol * want.abs() + 1e-5).all()), \
            f"K1 small {dtype}: max err {err.max().item()}"
    # flagship shape: [4, 64, 64, 32] bf16 features, 32x192x192 grid, at
    # uniform random projections and at the path's own (a seeded flagship
    # batch); the path's are the kernel's reported time
    cfg = flagship_vernier_config()
    grid, roi = cfg.grid_resolution, cfg.resolution
    lf, rf, rgl, rgr = k1_case(gen, cfg.max_instances, 64, 64, 32, grid, roi,
                               torch.bfloat16, dev)
    gl, gr = batch_projections(cfg, 0, dev)
    max_err = 0.0
    for label, pl, pr in (("random", rgl, rgr), ("path", gl, gr)):
        max_err = max(max_err, assert_k1(f"K1 flagship {label}", lf, rf, pl,
                                         pr, roi, grid))
    ms_random = cuda_ms(lambda: stereo_voxel_sample(lf, rf, rgl, rgr, roi,
                                                    grid), 20)
    times = k1_times(lf, rf, gl, gr, roi, grid)
    phase("K1", t, max_abs_err=f"{max_err:.3e}",
          kernel_ms_random=f"{ms_random:.4f}", **times_fields(times))
    return dict(max_abs_err=max_err, **times)


def times_fields(times: dict) -> dict:
    """A kernel's numbers as phase fields (``ms`` printed as kernel_ms)."""
    return {("kernel_ms" if k == "ms" else k):
            f"{v:.3e}" if k == "max_abs_err" else f"{v:.4f}"
            for k, v in times.items()}


def assert_k1(label, lf, rf, gl, gr, roi, grid) -> float:
    """K1 against its plain version: within one bf16 ulp (2^-7 relative)
    plus 1e-5.  Returns the largest error."""
    got = stereo_voxel_sample(lf, rf, gl, gr, roi, grid)
    want = sample_stereo_voxel(lf, rf, gl, gr, roi, grid)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2.0 ** -7 * want.float().abs() + 1e-5).all()), \
        f"{label}: max err {err.max().item()}"
    return err.max().item()


def k1_times(lf, rf, gl, gr, roi, grid) -> dict:
    """K1's kernel / plain / library ms at these inputs and its bound.
    Library: F.grid_sample per view (NCHW view of the same NHWC data,
    normalized grid [N, 1, P, 2]) and the concat, timed only."""
    ms = cuda_ms(lambda: stereo_voxel_sample(lf, rf, gl, gr, roi, grid), 20)
    plain_ms = cuda_ms(lambda: sample_stereo_voxel(lf, rf, gl, gr, roi,
                                                   grid), 3)
    lft, rft = lf.permute(0, 3, 1, 2), rf.permute(0, 3, 1, 2)
    scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=lf.device)
    ngl = (gl * scale - 1.0)[:, None].to(lf.dtype)
    ngr = (gr * scale - 1.0)[:, None].to(lf.dtype)

    def library():
        a = F.grid_sample(lft, ngl, align_corners=False, padding_mode="zeros")
        b = F.grid_sample(rft, ngr, align_corners=False, padding_mode="zeros")
        return torch.cat([a, b], dim=1)

    library_ms = cuda_ms(library, 3)
    N, Hf, Wf, C = lf.shape
    bound_ms = bound_of(k1_work(N, gl.shape[1], Hf, Wf, C,
                                lf.element_size()), PEAK_F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


# ---------------------------------------------------------------- K2 ----
def k2_case(gen, shape, kernel, F_out, dev):
    N, D, H, W, C = shape
    x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
    fan_in = math.prod(kernel) * C
    w = (torch.randn(kernel + (C, F_out), generator=gen)
         / math.sqrt(fan_in)).to(dev, torch.bfloat16)
    return x, w


def check_k2(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False  # the f32 reference is f32
    torch.backends.cuda.matmul.allow_tf32 = False
    flag = (4, 32, 192, 192)
    cases = [  # name, x shape, kernel, F, dilation, timed
        ("conv1_k7", flag + (64,), (7, 7, 7), 32, 1, True),
        ("conv2_k5", flag + (32,), (5, 5, 5), 32, 1, True),
        ("conv3_k5_d2", flag + (32,), (5, 5, 5), 32, 2, True),
        ("ragged", (2, 9, 10, 70, 40), (5, 3, 7), 24, 2, False),
        ("ragged_scalar", (1, 7, 6, 33, 12), (5, 5, 5), 10, 1, False),
    ]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    max_err = 0.0
    for case in cases:
        err, times = run_k2_case(gen, dev, *case)
        max_err = max(max_err, err)
        for k, v in times.items():
            tot[k] += v
    phase("K2", t, max_abs_err=f"{max_err:.3e}",
          **{k: f"{v:.3f}" for k, v in tot.items()})
    return dict(max_abs_err=max_err, **tot)


def run_k2_case(gen, dev, name, shape, kernel, F_out, dil, timed):
    """One K2 case against the per-tap float32 conv; when ``timed``, its
    kernel / plain / F.conv3d ms and bound.  Prints a phase line;
    returns (max error, times or {})."""
    tc = time.perf_counter()
    x, w = k2_case(gen, shape, kernel, F_out, dev)
    got = conv3d_large_tap(x, w, dil).float()
    ref = conv3d_pertap(x.float(), w.float(), dil)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    # kernel: exact bf16 products summed in f32, rounded once to bf16
    # (half an ulp, 2^-8 relative); 2^-7 relative plus 1e-3 of the
    # output scale leaves room for the f32 summation order
    tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert bool((err <= tol).all()), f"K2 {name}: max err {err.max().item()}"
    max_err = err.max().item()
    fields = dict(max_abs_err=f"{max_err:.3e}")
    del got, ref, err, tol
    times = {}
    if timed:
        # multiply-adds with padding zeros are not work the conv needs
        work = conv3d_work(shape, kernel, F_out, dil, x.element_size())
        flops = work.flops
        ms = cuda_ms(lambda: conv3d_large_tap(x, w, dil), 3)
        plain_ms = cuda_ms(lambda: conv3d_pertap(x, w, dil), 2)
        xt = x.permute(0, 4, 1, 2, 3)
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        pad = tuple((k - 1) // 2 * dil for k in kernel)
        library_ms = cuda_ms(lambda: F.conv3d(xt, wt, None, 1, pad, dil), 2)
        bound_ms = bound_of(work, PEAK_BF16_FLOPS)
        times = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     library_ms=library_ms)
        fields.update(kernel_ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
                      library_ms=f"{library_ms:.3f}",
                      bound_ms=f"{bound_ms:.3f}",
                      tflops=f"{flops / ms / 1e9:.1f}",
                      pct_of_bound=f"{100 * bound_ms / ms:.1f}")
    phase(f"K2 {name}", tc, **fields)
    del x, w
    torch.cuda.empty_cache()
    return max_err, times


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude x (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(x, 2.0 ** -126))) - 7)


def assert_within_ulps(label, got, want, ulps=2):
    """|got - want| <= ``ulps`` bf16 ulp of the largest |want|."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= ulps * bf16_ulp(scale), \
        f"{label}: max err {err} > {ulps} bf16 ulp of {scale}"
    return err


# ---------------------------------------------------------------- K3 ----
def k3_edge_table(N, D, W, gen):
    """[N, D] shifts: the first row random in [0, W), the rest the edge
    cases 0, integers, fractions, the last column, and past the row."""
    edge = torch.tensor([0.0, 1.0, 2.5, 7.25, W - 1.0, W - 0.5, W + 0.0,
                         W + 5.5, 3 * W + 0.25], dtype=torch.float32)
    t = torch.rand((N, D), generator=gen) * W
    for n in range(1, N):
        t[n, :len(edge)] = edge[: D]
    return t


def k3_library(lf, rf, shifts):
    """K3's function as PyTorch calls: F.grid_sample, 5-D, of the right
    features (an NCDHW view with one depth plane) at column x - shift[n,
    d] of each plane, bilinear, zeros padding, align_corners=True (so
    pixel centres map to themselves), concatenated after the left half
    broadcast over the planes.  The grid is built here, in the features'
    dtype.  Returns ``call(lf, rf)`` -> [N, 2C, D, H, W]."""
    N, H, W, C = lf.shape
    s = shifts.float().expand(N, -1)  # [D] or [N, D] -> [N, D]
    D = s.shape[1]
    dev = lf.device
    x = torch.arange(W, device=dev) - s[:, :, None, None]  # [N, D, 1, W]
    y = torch.arange(H, device=dev)[None, None, :, None].float()
    grid = torch.stack([(2 * x / (W - 1) - 1).expand(N, D, H, W),
                        (2 * y / (H - 1) - 1).expand(N, D, H, W),
                        torch.zeros((N, D, H, W), device=dev)],
                       dim=-1).to(lf.dtype)

    def call(left, right):
        r = F.grid_sample(right.permute(0, 3, 1, 2)[:, :, None], grid,
                          mode="bilinear", padding_mode="zeros",
                          align_corners=True)
        lt = left.permute(0, 3, 1, 2)[:, :, None].expand(N, C, D, H, W)
        return torch.cat([lt, r], dim=1)

    return call


def k3_library_err(lf, rf, table) -> float:
    """The library call's largest difference from K3's plain version in
    float32 (features and grid), relative to the largest value: the
    check that it computes the same function, edge shifts included."""
    lf, rf = lf.float(), rf.float()
    got = k3_library(lf, rf, table)(lf, rf).permute(0, 2, 3, 4, 1)
    want = plane_sweep_shifted(lf, rf, table)
    return float((got - want).abs().max() / want.abs().max())


def check_k3(gen, dev) -> dict:
    t = time.perf_counter()
    # small shapes, f32 and bf16, shared [D] and per-sample [N, D] tables
    for dtype in (torch.float32, torch.bfloat16):
        lf = torch.randn((2, 8, 24, 16), generator=gen).to(dev, dtype)
        rf = torch.randn((2, 8, 24, 16), generator=gen).to(dev, dtype)
        for shifts in (k3_edge_table(2, 9, 24, gen)[1],
                       k3_edge_table(2, 9, 24, gen)):
            s = shifts.to(dev)
            assert_within_ulps(f"K3 small {dtype} {tuple(s.shape)}",
                               plane_sweep_volume_k3(lf, rf, s),
                               plane_sweep_shifted(lf, rf, s))
    # detect shape: [N, 96, 312, 32] bf16 features, 64 planes; a [2, 64]
    # table whose second row holds the edge cases
    cfg = StereoConfig()
    H, W = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    C = 32
    lf = torch.randn((2, H, W, C), generator=gen).to(dev, torch.bfloat16)
    rf = torch.randn((2, H, W, C), generator=gen).to(dev, torch.bfloat16)
    table = k3_edge_table(2, cfg.num_depths, W, gen).to(dev)
    err = assert_within_ulps("K3 detect [2, D]",
                             plane_sweep_volume_k3(lf, rf, table),
                             plane_sweep_shifted(lf, rf, table))
    lib_err = k3_library_err(lf, rf, table)
    # the request's own shift table, one sample
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    depths = torch.from_numpy(depth_hypotheses(cfg)).to(dev)
    shifts = plane_shifts(Pl, Pr, depths)
    l1, r1 = lf[:1].contiguous(), rf[:1].contiguous()
    got = plane_sweep_volume_k3(l1, r1, shifts)
    err = max(err, assert_within_ulps("K3 detect", got,
                                      plane_sweep_shifted(l1, r1, shifts)))
    times = k3_times(l1, r1, shifts)
    phase("K3", t, max_abs_err=f"{err:.3e}", **times_fields(times),
          library_f32_rel_err=f"{lib_err:.3e}")
    return dict(max_abs_err=err, **times)


def k3_times(lf, rf, shifts) -> dict:
    """K3's kernel / plain / library ms at these inputs and its bound.
    Library: the 5-D F.grid_sample + cat in bf16, timed only (its bf16
    grid rounds the columns, as K1's and K4's library grids do)."""
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: plane_sweep_volume_k3(lf, rf, shifts), 20)
    plain_ms = cuda_ms(lambda: plane_sweep_shifted(lf, rf, shifts), 3)
    call = k3_library(lf, rf, shifts)
    library_ms = cuda_ms(lambda: call(lf, rf), 3)
    N, H, W, C = lf.shape
    bound_ms = bound_of(k3_work(N, shifts.shape[-1], H, W, C,
                                lf.element_size(), shifts.numel()),
                        PEAK_F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


# ---------------------------------------------------------------- K4 ----
def k4_tables(depths, zs, xs, ys, dev):
    d0, fd = frustum_tables(depths, zs)
    return [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            for a, dt in ((d0, np.int32), (fd, np.float32),
                          (zs, np.float32), (xs, np.float32),
                          (ys, np.float32))]


def k4_library_grid(P, tabs, D, Hf, Wf):
    """The [1, nz, nx, ny, 3] bf16 (u, v, d) grid, normalized for
    F.grid_sample with align_corners=True, at which the BEV cells sample
    the volume: the library call's form of K4."""
    u, v = _project_uv(P, tabs[2], tabs[3], tabs[4], 4)  # [1,nz,nx], [1,nz,ny]
    d = tabs[0].float() + tabs[1]
    nz, nx, ny = u.shape[1], u.shape[2], v.shape[2]
    return torch.stack([
        (2 * u / (Wf - 1) - 1)[..., None].expand(1, nz, nx, ny),
        (2 * v / (Hf - 1) - 1)[:, :, None, :].expand(1, nz, nx, ny),
        (2 * d / (D - 1) - 1)[None, :, None, None].expand(1, nz, nx, ny),
    ], dim=-1).to(torch.bfloat16)


def k4_small_case(dev):
    """The small K4 case: 6 planes over 4-30 m, BEV rows past both ends
    of the planes, columns partly outside the image, and per-sample P."""
    depths = np.linspace(4.0, 30.0, 6).astype(np.float32)
    zs = (4.0 + (np.arange(10) + 0.5) * 2.0).astype(np.float32)
    zs[0], zs[-1] = 2.5, 34.0
    xs = (-6.0 + (np.arange(12) + 0.5)).astype(np.float32)
    ys = (-1.0 + (np.arange(4) + 0.5) * 0.8).astype(np.float32)
    P = torch.tensor([[80.0, 0, 48.0, 2.0], [0, 80.0, 32.0, -0.3],
                      [0, 0, 1, 0.005]]).repeat(2, 1, 1)
    P[1, 0, 3] += 0.5
    return P.to(dev), k4_tables(depths, zs, xs, ys, dev)


def check_k4(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, both dtypes: depths past both ends, columns outside
    P, tabs = k4_small_case(dev)
    for dtype in (torch.float32, torch.bfloat16):
        vol = torch.randn((2, 6, 16, 24, 16), generator=gen).to(dev, dtype)
        assert_within_ulps(f"K4 small {dtype}",
                           frustum_to_voxel_k4(vol, P, *tabs, 4),
                           frustum_to_voxel_separable(vol, P, *tabs, 4))
    # detect shape: [1, 64, 96, 312, 32] bf16 planes -> 288 x 300 x 20
    cfg = StereoConfig()
    D, C = cfg.num_depths, 32
    Hf, Wf = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    depths = depth_hypotheses(cfg)
    tabs = k4_tables(depths, *_bev_axes(cfg), dev)
    vol = torch.randn((1, D, Hf, Wf, C), generator=gen).to(dev, torch.bfloat16)
    P = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    got = frustum_to_voxel_k4(vol, P, *tabs, 4)
    err = assert_within_ulps("K4 detect", got,
                             frustum_to_voxel_separable(vol, P, *tabs, 4))
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: frustum_to_voxel_k4(vol, P, *tabs, 4), 20)
    plain_ms = cuda_ms(lambda: frustum_to_voxel_separable(vol, P, *tabs, 4),
                       3)
    # library: one trilinear F.grid_sample over the 5-D volume with
    # align_corners=True and a (u, v, d) grid, timed only
    grid = k4_library_grid(P, tabs, D, Hf, Wf)
    vt = vol.permute(0, 4, 1, 2, 3)
    library_ms = cuda_ms(lambda: F.grid_sample(
        vt, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        3)
    planes = k4_planes(tabs[0])
    bound_ms = bound_of(k4_work(tuple(vol.shape), tabs[0], tuple(got.shape),
                                vol.element_size()), PEAK_F32_FLOPS)
    phase("K4", t, max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", planes=planes)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms)


# ----------------------------------------------------------- serving ----
KERNELS = dict(K1=stereo_voxel_sample, K1_bwd=stereo_voxel_sample_bwd,
               K2=conv3d_large_tap, K2_dx=conv3d_input_grad,
               K2_dw=conv3d_weight_grad, K3=plane_sweep_volume_k3,
               K3_bwd=plane_sweep_volume_k3_bwd, K4=frustum_to_voxel_k4,
               K4_bwd=frustum_to_voxel_k4_bwd, K5=conv3d_k3)


def counts_of(**nonzero) -> dict:
    """Every kernel's expected count: 0 unless given."""
    return {k: nonzero.get(k, 0) for k in KERNELS}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def check_serving(dev, profile: bool = False) -> dict:
    return serve(flagship_vernier_config(), dev, "serving", 3, profile)


def serve(cfg, dev, label: str, k2_per_request: int,
          profile: bool = False) -> dict:
    """A RefineRunner of ``cfg`` with seeded weights: one warm-up and
    three requests, each timed on the host clock around a synchronized
    step; the outputs' shapes, finite values and the launch counters (K1
    once and K2 ``k2_per_request`` times a request)."""
    t = time.perf_counter()
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    runner = RefineRunner(model, cfg, device=dev)
    runner.step(synthetic_batch_arrays(cfg, seed=100))  # warm-up
    torch.cuda.synchronize()
    batches = [synthetic_batch_arrays(cfg, seed=s) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    I, P = cfg.max_instances, cfg.num_parts
    nh, nw, nl = cfg.grid_resolution
    shapes = dict(one_part=(I, 7), all_parts=(I, 7), confidence=(I, P),
                  keep=(I,), ncf=(I, P, nl, nw), occupancy=(I, nh, nw, nl))
    if cfg.vernier_type == "BEV_type3":
        shapes["coordinates"] = (I, P, 2)
    for b in batches:
        t_req = time.perf_counter()
        out = runner.step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_req) * 1e3)
        if "coordinates" not in shapes:
            assert out["coordinates"] is None, "coordinates"
        for k, s in shapes.items():
            v = out[k]
            assert tuple(v.shape) == s, f"{k}: {tuple(v.shape)} != {s}"
            if k != "keep":
                arr = v if isinstance(v, np.ndarray) else v.cpu().numpy()
                assert np.isfinite(arr).all(), f"{k} is not finite"
    counts = read_counts()
    n = len(batches)
    assert counts == counts_of(K1=n, K2=k2_per_request * n), \
        f"{label} launch counts {counts}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(times)[len(times) // 2]
    phase(label, t, request_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", inst_per_s=f"{I / (med / 1e3):.2f}",
          peak_mem_gb=f"{peak_gb:.2f}",
          launches=json.dumps(counts).replace(" ", ""))
    if profile:
        profile_request(lambda: runner.step(batches[0]))
    del runner, model
    torch.cuda.empty_cache()
    return dict(counts=counts, request_ms=times, peak_gb=peak_gb)


def profile_request(request) -> None:
    """torch.profiler over one request (``request()``): device time by
    kernel (the 40 largest, and every one of the port's own) and the
    device's busy share of the request's wall time.  Only device (kernel) events are summed: the operator-level
    rows report the same device time again, and a user annotation on the
    device (the optimizer's ``Optimizer.step#AdamW.step``) spans its
    kernels and the gaps between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_req = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_req) * 1e3
    rows = []
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    lines = [f"request wall {wall_ms:.2f} ms (profiled), device busy "
             f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
             f"{sum(r[1] for r in rows)} kernel launches",
             "device_ms  calls  kernel"]
    # the 40 largest rows, and every row of the port's own kernels
    own = ("stereo_voxel_sample", "conv3d_", "plane_sweep", "frustum_to")
    lines += [f"{ms:9.3f}  {n:5d}  {key[:110]}" for i, (ms, n, key)
              in enumerate(rows) if i < 40 or any(k in key for k in own)]
    for ln in lines:
        print(f"  profile: {ln}")
    phase("profile_request", t, wall_ms=f"{wall_ms:.2f}",
          busy_ms=f"{busy_ms:.2f}")


def check_reference(dev) -> None:
    """A small model (hrnet-tiny, 8x32x32 grid, HourglassDeep) on the card
    in bf16 (the kernels) against the same weights on the CPU in float32
    (the plain versions).  Random-weight GroupNorm stacks amplify bf16
    rounding (the CPU's own bf16 run drifts ~10 % of the NCF's scale from
    its float32 run), so the card must stay within three times the CPU
    bf16 drift plus 1 % of the scale: a wrong kernel lands far outside.
    Both bf16 steps are counted (``utils.cost``): the card's work must
    equal the CPU's, in total and per kernel (phase ``cost``)."""
    t = time.perf_counter()
    small = tiny_vernier_config(grid_resolution=(8, 32, 32),
                                image_size=(128, 256), max_instances=2)
    batch = synthetic_batch_arrays(small, seed=7)
    keys = ("ncf", "occupancy", "coordinates")

    def run(cfg, device):
        model = VernierScale(cfg, device=device,
                             generator=torch.Generator().manual_seed(1))
        runner = RefineRunner(model, cfg, device=device)
        with count_cost() as c:
            out = runner.step(batch, host_outputs=keys)
        return out, c

    bf16 = small.replace(compute_dtype="bfloat16")
    ref, _ = run(small, "cpu")
    cpu_bf16, cpu_cost = run(bf16, "cpu")
    reset_counts()
    got, card_cost = run(bf16, dev)
    assert (stereo_voxel_sample.launches, conv3d_large_tap.launches) == (1, 3)
    fields = same_cost("reference", card_cost, cpu_cost, ("K1", "K2"))
    for k in keys:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert np.isfinite(got[k]).all(), f"small model {k} not finite"
        assert err <= 3.0 * drift + 0.01, \
            f"small model {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"{k}_rel_err"] = f"{err:.4f}"
        fields[f"{k}_cpu_bf16_rel_err"] = f"{drift:.4f}"
    phase("reference", t, **fields)


def same_cost(label, card, other, kernels) -> dict:
    """Raises unless two ``utils.cost`` counts of one program, on the card
    and on the CPU (or the meta device), are equal in total and per
    kernel, each of ``kernels`` declared; the aten ops that part them are
    named.  Returns the phase fields."""
    diff = {k: (card.by_op.get(k), other.by_op.get(k))
            for k in set(card.by_op) | set(other.by_op)
            if card.by_op.get(k) != other.by_op.get(k)}
    assert card.totals() == other.totals(), \
        f"{label}: work {card.totals()} != {other.totals()}; ops {diff}"
    assert card.by_kernel == other.by_kernel, \
        f"{label}: per kernel {card.by_kernel} != {other.by_kernel}"
    assert set(card.by_kernel) == set(kernels), \
        f"{label}: kernels {sorted(card.by_kernel)}"
    return dict(gflop=f"{card.flops / 1e9:.4f}",
                gb=f"{card.bytes_accessed / 1e9:.4f}",
                work_card_eq_cpu="yes")


def cost_fields(label, c, times) -> dict:
    """A count's GFLOP, GB and bound at the card's bf16 and memory
    peaks, the share of the bound the median of ``times`` (ms) reaches;
    one line a kernel."""
    med = sorted(times)[len(times) // 2]
    f_ms, b_ms = c.flops / PEAK_BF16_FLOPS * 1e3, \
        c.bytes_accessed / PEAK_BYTES * 1e3
    bound = max(f_ms, b_ms)
    for k, v in sorted(c.by_kernel.items()):
        print(f"  cost: {label} {k} calls={v['calls']} "
              f"gflop={v['flops'] / 1e9:.4f} "
              f"gb={v['bytes_accessed'] / 1e9:.4f}")
    return {f"{label}_gflop": f"{c.flops / 1e9:.2f}",
            f"{label}_gb": f"{c.bytes_accessed / 1e9:.3f}",
            f"{label}_bound_ms": f"{bound:.3f}",
            f"{label}_bound_by": "operations" if f_ms >= b_ms else "bytes",
            f"{label}_flops_ms": f"{f_ms:.3f}",
            f"{label}_bytes_ms": f"{b_ms:.3f}",
            f"{label}_ms": ",".join(f"{v:.1f}" for v in times),
            f"{label}_median_ms": f"{med:.1f}",
            f"{label}_share_of_bound": f"{100 * bound / med:.1f}%"}


def synced_ms(fn, args) -> list:
    """Host ms of ``fn(a)`` for each ``a`` of ``args``, synchronized."""
    times = []
    for a in args:
        t_req = time.perf_counter()
        fn(a)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_req) * 1e3)
    return times


def meta_stereo_count(cfg, req):
    """The StereoNet forward of ``cfg`` counted on the meta device: the
    CPU code on shapes alone.  K4's plane table stays on the host, where
    its declared work reads the planes it uses (tests/test_torch_cost.py
    holds this count to the CPU's)."""
    model = StereoNet(cfg, device="meta")
    d0, _ = frustum_tables(depth_hypotheses(cfg), _bev_axes(cfg)[0])
    model.head.bev_d0 = torch.from_numpy(d0)
    args = stereo_inputs(req, "meta")
    with count_cost() as c:
        model(*args)
    return c


def check_cost(dev) -> dict:
    """The work of one flagship refinement request and of one
    ``StereoConfig()`` batch-1 detection forward, counted on the card
    (``utils.cost``: the aten ops, K1-K4 by their declared work): GFLOP,
    GB, the bound at the card's bf16 and memory peaks, and the share of it
    that the median of three requests (a synchronized ``RefineRunner.step``
    / model forward) reaches.  The refinement count is held equal, in
    total and per kernel, to the plain path's on the meta device (the
    CPU code on shapes alone: CPU forwards of 9.7 and 1.6 TFLOP are out
    of reach), and so is the detection forward's (``meta_stereo_count``).
    Phases ``reference`` and ``stereo_reference`` hold the card's counts
    to the CPU's on real runs at their small shapes."""
    t = time.perf_counter()
    cfg = flagship_vernier_config()
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    runner = RefineRunner(model, cfg, device=dev)
    batches = [synthetic_batch_arrays(cfg, seed=s) for s in (1, 2, 3)]
    runner.step(batches[0])  # warm-up
    card = runner.cost_counter(batches[0])
    meta = RefineRunner(VernierScale(cfg, device="meta"), cfg,
                        device="meta").cost_counter(batches[0])
    same_cost("cost refine (card, meta)", card, meta, ("K1", "K2"))
    assert card.by_kernel["K2"]["calls"] == 3, card.by_kernel
    fields = cost_fields("refine", card, synced_ms(runner.step, batches))
    del runner, model
    torch.cuda.empty_cache()

    scfg = StereoConfig()
    smodel = StereoNet(scfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    reqs = [synthetic_stereo_request(scfg, seed=s) for s in (1, 2, 3)]
    args = [stereo_inputs(r, dev) for r in reqs]
    smodel(*args[0])  # warm-up
    with count_cost() as c:
        smodel(*args[0])
    same_cost("cost detect (card, meta)", c,
              meta_stereo_count(scfg, reqs[0]), ("K3", "K4"))
    fields.update(cost_fields("detect", c,
                              synced_ms(lambda a: smodel(*a), args)))
    del smodel, args
    torch.cuda.empty_cache()
    phase("cost", t, **fields, nvidia_smi=repr(nvidia_smi()))
    return fields


# ------------------------------------------------------------ detect ----
def check_detect(dev, profile: bool = False) -> dict:
    """A full-width StereoConfig() DetectRunner: one warm-up and three
    requests, each timed on the host clock around a synchronized forward."""
    t = time.perf_counter()
    cfg = StereoConfig()
    model = StereoNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    runner = DetectRunner(model, cfg, device=dev)
    runner.forward(synthetic_stereo_request(cfg, seed=100))  # warm-up
    torch.cuda.synchronize()
    requests = [synthetic_stereo_request(cfg, seed=s) for s in (1, 2, 3)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, n_valid = [], []
    mb = runner.max_boxes
    for r in requests:
        t_req = time.perf_counter()
        boxes, scores, classes, valid = runner.forward(r)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_req) * 1e3)
        for name, v, shape in (("boxes", boxes, (1, mb, 7)),
                               ("scores", scores, (1, mb)),
                               ("classes", classes, (1, mb)),
                               ("valid", valid, (1, mb))):
            assert tuple(v.shape) == shape, f"{name}: {tuple(v.shape)}"
        assert bool(torch.isfinite(boxes).all()), "boxes are not finite"
        assert bool(torch.isfinite(scores[valid]).all()), \
            "scores of valid proposals are not finite"
        n_valid.append(int(valid.sum()))
    counts = read_counts()
    n = len(requests)
    assert counts == counts_of(K3=n, K4=n), f"launch counts {counts}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(times)[len(times) // 2]
    phase("detect", t, request_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", pairs_per_s=f"{1e3 / med:.2f}",
          peak_mem_gb=f"{peak_gb:.2f}", valid=",".join(map(str, n_valid)),
          launches=json.dumps(counts).replace(" ", ""))
    if profile:
        profile_request(lambda: runner.forward(requests[0]))
    del runner, model
    torch.cuda.empty_cache()
    return dict(counts=counts, request_ms=times)


def stereo_inputs(req, device) -> tuple:
    """The StereoNet forward's arguments from a stereo request: both
    views normalized, both projections, on ``device``."""
    b = {k: torch.from_numpy(req[k]).to(device)
         for k in ("images_left", "images_right", "P_left", "P_right")}
    return (normalize_images(b["images_left"]),
            normalize_images(b["images_right"]), b["P_left"], b["P_right"])


def check_stereo_reference(dev) -> None:
    """tiny_stereo_config in bf16 on the card (K3, K4) against the same
    weights in float32 on the CPU (their plain versions).  TF32 is off for
    cuDNN convolutions and matmuls and the float32 matmul precision is
    "highest", so the card's float32 work is float32.  The bound is the
    rule of phase "reference": within three times the CPU's own bf16 drift
    from its float32 run, plus 1 % of the output's scale."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_stereo_config()
    req = synthetic_stereo_request(small, seed=7)
    keys = ("depth", "cls", "reg", "centerness")

    def run(cfg, device):
        model = StereoNet(cfg, device=device,
                          generator=torch.Generator().manual_seed(2))
        with torch.inference_mode():
            args = stereo_inputs(req, device)
            with count_cost() as c:
                out = model(*args)
        return {k: out[k].float().cpu().numpy() for k in keys}, c

    bf16 = small.replace(compute_dtype="bfloat16")
    ref, _ = run(small, "cpu")
    cpu_bf16, cpu_cost = run(bf16, "cpu")
    reset_counts()
    got, card_cost = run(bf16, dev)
    counts = read_counts()
    assert counts == counts_of(K3=1, K4=1), f"launch counts {counts}"
    fields = same_cost("stereo_reference", card_cost, cpu_cost, ("K3", "K4"))
    for k in keys:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert np.isfinite(got[k]).all(), f"tiny stereo {k} not finite"
        assert err <= 3.0 * drift + 0.01, \
            f"tiny stereo {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"{k}_rel_err"] = f"{err:.4f}"
        fields[f"{k}_cpu_bf16_rel_err"] = f"{drift:.4f}"
    phase("stereo_reference", t, tf32="off", matmul_precision="highest",
          **fields)


# ------------------------------------------------------------ K1 bwd ----
def assert_k1_grad(label, got, want, rel):
    """|got - want| <= rel |want| + 1e-4 of the largest |want|: the kernel
    sums in float32 with atomics (order varies) and rounds once."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = rel * want.abs() + 1e-4 * want.abs().max()
    assert bool((err <= tol).all()), f"{label}: max err {err.max().item()}"
    return err.max().item()


def check_k1_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    # small shape, f32 and bf16, with the grids' gradient
    for dtype in (torch.float32, torch.bfloat16):
        lf, rf, gl, gr = k1_case(gen, 2, 16, 16, 32, (4, 8, 8), (64, 64),
                                 dtype, dev)
        g = torch.randn((2, 4, 8, 8, 64), generator=gen).to(dev, dtype)
        assert_k1_bwd(f"K1_bwd small {dtype}", lf, rf, gl, gr, g, (64, 64))
    # training shape: [8, 64, 64, 32] bf16 features, 16x96x96 grid, and the
    # projections of a training batch (where they cluster, the adds
    # contend: uniform random points would understate the time)
    cfg = VernierConfig()
    N, grid = cfg.max_instances, cfg.grid_resolution
    roi = cfg.resolution
    P = math.prod(grid)
    gl, gr = batch_projections(cfg, 0, dev)
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        lf, rf, _, _ = k1_case(gen, N, 64, 64, 32, (1, 1, 1), roi, dtype,
                               dev)
        g = torch.randn((N,) + grid + (64,), generator=gen).to(dev, dtype)
        # worst contention: every point of an instance inside one 2x2 tap
        # patch (its own random patch, random fractions inside it)
        cell = torch.randint(0, 63, (N, 1, 2), generator=gen).float()
        frac = torch.rand((N, P, 2), generator=gen) * 0.9 + 0.05
        patch = ((cell + frac + 0.5) * (roi[1] / 64)).to(dev)
        for label, pl, pr in (("one_patch", patch, patch.flip(0)),
                              ("train", gl, gr)):
            if label == "train" and dtype == torch.float32:
                continue  # f32 at the training projections: the small cases
            max_err = max(max_err, assert_k1_bwd(
                f"K1_bwd {label} {dtype}", lf, rf, pl, pr, g, roi))
    patch = patch.contiguous()
    ms_one_patch = cuda_ms(lambda: stereo_voxel_sample_bwd(
        lf, rf, patch, patch, g, roi, need_grid=False), 5)
    times = k1_bwd_times(lf, rf, gl, gr, g, roi)
    phase("K1_bwd", t, max_abs_err=f"{max_err:.3e}",
          kernel_ms_one_patch=f"{ms_one_patch:.4f}", **times_fields(times))
    return dict(max_abs_err=max_err, **times)


def assert_k1_bwd(label, lf, rf, gl, gr, g, roi) -> float:
    """K1's backward (with the grids' gradient) against its plain version
    in float32: ``assert_k1_grad`` at 1e-5 relative (float32 features) or
    2^-7 (bf16) for the features' gradients, 1e-5 for the grids'.
    Returns the largest error of the features' gradients."""
    got = stereo_voxel_sample_bwd(lf, rf, gl.contiguous(), gr.contiguous(),
                                  g, roi)
    want = sample_stereo_voxel_bwd(lf.float(), rf.float(), gl, gr,
                                   g.float(), roi)
    torch.cuda.synchronize()
    rel = 1e-5 if lf.dtype == torch.float32 else 2.0 ** -7
    err = 0.0
    for name, a, b in zip(("dleft", "dright", "dgrid_l", "dgrid_r"), got,
                          want):
        e = assert_k1_grad(f"{label} {name}", a, b,
                           rel if name[1] != "g" else 1e-5)
        if name[1] != "g":
            err = max(err, e)
    return err


def k1_bwd_times(lf, rf, gl, gr, g, roi) -> dict:
    """K1's backward kernel / plain / library ms, timed as training runs
    it (no grid gradient), and its bound.  Library: the backward of
    F.grid_sample per view (NCHW views of the NHWC features), timed
    only."""
    ms = cuda_ms(lambda: stereo_voxel_sample_bwd(lf, rf, gl, gr, g, roi,
                                                 need_grid=False), 20)
    plain_ms = cuda_ms(lambda: sample_stereo_voxel_bwd(
        lf, rf, gl, gr, g, roi, need_grid=False), 3)
    N, C = lf.shape[0], lf.shape[-1]
    scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=lf.device)
    leaves = [f.detach().requires_grad_() for f in (lf, rf)]
    outs, gouts = [], []
    for leaf, gp, half in ((leaves[0], gl, g[..., :C]),
                           (leaves[1], gr, g[..., C:])):
        ng = (gp * scale - 1.0)[:, None].to(lf.dtype)
        outs.append(F.grid_sample(leaf.permute(0, 3, 1, 2), ng,
                                  align_corners=False, padding_mode="zeros"))
        gouts.append(half.reshape(N, 1, -1, C).permute(0, 3, 1, 2))
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        outs, leaves, gouts, retain_graph=True), 3)
    N, Hf, Wf, C = lf.shape
    bound_ms = bound_of(k1_bwd_work(N, gl.shape[1], Hf, Wf, C,
                                    lf.element_size(), need_grid=False),
                        PEAK_F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


# ------------------------------------------------------------ K2 bwd ----
def assert_conv(label, got, ref):
    """The K2 rule: 2^-7 relative plus 1e-3 of the output's scale."""
    err = (got.float() - ref).abs()
    tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
    assert bool((err <= tol).all()), f"{label}: max err {err.max().item()}"
    return err.max().item()


def conv_grads_ref(x, w, g, dil, fn=conv3d_pertap):
    """dx and dw of ``fn`` by float32 autograd (TF32 off)."""
    with torch.enable_grad():
        xr = x.float().requires_grad_()
        wr = w.float().requires_grad_()
        fn(xr, wr, dil).backward(g.float())
    return xr.grad, wr.grad


def check_k2_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = VernierConfig()  # [8, 16, 96, 96] voxels per training step
    shape = (cfg.max_instances,) + cfg.grid_resolution
    cases = [  # name, x shape, kernel, F, dilation, timed
        ("conv1_k7", shape + (64,), (7, 7, 7), 32, 1, True),
        ("conv2_k5", shape + (32,), (5, 5, 5), 32, 1, True),
        ("conv3_k5_d2", shape + (32,), (5, 5, 5), 32, 2, True),
        ("ragged", (2, 9, 10, 70, 40), (5, 3, 7), 24, 2, False),
        ("ragged_scalar", (1, 7, 6, 33, 12), (5, 5, 5), 10, 1, False),
    ]
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0) for k in ("dx", "dw")}
    for case in cases:
        for k, d in run_k2_bwd_case(gen, dev, *case).items():
            tot[k]["max_abs_err"] = max(tot[k]["max_abs_err"],
                                        d.pop("max_abs_err"))
            for key, v in d.items():
                tot[k][key] += v
    phase("K2_bwd", t, **{f"{k}_{key}": f"{v:.3f}" for k, d in tot.items()
                          for key, v in d.items() if key != "max_abs_err"})
    return tot


def run_k2_bwd_case(gen, dev, name, xs, kernel, F_out, dil, timed) -> dict:
    """dx (the K2 kernel on flipped weights) and dw of one conv against
    the per-tap conv's float32 autograd; when ``timed``, kernel / plain /
    cuDNN ms and bound of each.  Prints a phase line; returns {"dx": {..},
    "dw": {..}} with max_abs_err and the times."""
    tc = time.perf_counter()
    x, w = k2_case(gen, xs, kernel, F_out, dev)
    g = torch.randn(xs[:-1] + (F_out,), generator=gen).to(dev, torch.bfloat16)
    dx = conv3d_input_grad(g, w, dil)
    dw = conv3d_weight_grad(x, g, kernel, dil)
    ref_dx, ref_dw = conv_grads_ref(x, w, g, dil)
    torch.cuda.synchronize()
    out = dict(dx=dict(max_abs_err=assert_conv(f"K2_bwd {name} dx", dx,
                                               ref_dx)),
               dw=dict(max_abs_err=assert_conv(f"K2_bwd {name} dw", dw,
                                               ref_dw)))
    del dx, dw, ref_dx, ref_dw
    fields = {f"{k}_max_abs_err": f"{v['max_abs_err']:.3e}"
              for k, v in out.items()}
    if timed:
        # dx and dw: the forward's taps; two of x, w, g read, one written
        work = conv3d_work(xs, kernel, F_out, dil, x.element_size())
        flops = work.flops
        pad = tuple((k - 1) // 2 * dil for k in kernel)
        xt, gt = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        wf = flip_weight(w)
        times = dict(
            dx=(cuda_ms(lambda: conv3d_input_grad(g, w, dil), 3),
                cuda_ms(lambda: conv3d_pertap(g, wf, dil), 2),
                cuda_ms(lambda: torch.nn.grad.conv3d_input(
                    xt.shape, wt, gt, 1, pad, dil), 2)),
            dw=(cuda_ms(lambda: conv3d_weight_grad(x, g, kernel, dil), 3),
                cuda_ms(lambda: conv3d_weight_grad_plain(
                    x, g, kernel, dil), 1),
                cuda_ms(lambda: torch.nn.grad.conv3d_weight(
                    xt, wt.shape, gt, 1, pad, dil), 2)))
        bound_ms = bound_of(work, PEAK_BF16_FLOPS)
        for k, (ms, plain_ms, library_ms) in times.items():
            out[k].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms)
            fields.update({f"{k}_ms": f"{ms:.3f}",
                           f"{k}_plain_ms": f"{plain_ms:.3f}",
                           f"{k}_cudnn_ms": f"{library_ms:.3f}",
                           f"{k}_bound_ms": f"{bound_ms:.3f}",
                           f"{k}_tflops": f"{flops / ms / 1e9:.1f}",
                           f"{k}_pct_of_bound": f"{100 * bound_ms / ms:.1f}"})
    phase(f"K2_bwd {name}", tc, **fields)
    del x, w, g
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- K5 ----
def check_k5(gen, dev) -> dict:
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    cases = [  # name, x shape, F
        ("stereo_stack", STEREO_STACK, 32),
        ("jax_test", (1, 4, 8, 16, 128), 32),
    ]
    out = {}
    for name, xs, F_out in cases:
        tc = time.perf_counter()
        x, w = k2_case(gen, xs, (3, 3, 3), F_out, dev)
        g = torch.randn(xs[:-1] + (F_out,), generator=gen).to(
            dev, torch.bfloat16)
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            wr = w.detach().requires_grad_()
            y = conv3d_k3(xr, wr)
            y.backward(g)
        ref = conv3d_pertap(x.float(), w.float(), 1)
        ref_dx, ref_dw = conv_grads_ref(x, w, g, 1)
        torch.cuda.synchronize()
        err = assert_conv(f"K5 {name}", y, ref)
        assert_conv(f"K5 {name} dx", xr.grad, ref_dx)
        assert_conv(f"K5 {name} dw", wr.grad, ref_dw)
        del y, ref, ref_dx, ref_dw, xr, wr
        work = conv3d_work(xs, (3, 3, 3), F_out, 1, x.element_size())
        flops = work.flops
        xt = x.permute(0, 4, 1, 2, 3)
        wt = w.permute(4, 3, 0, 1, 2).contiguous()
        ms = cuda_ms(lambda: conv3d_k3(x, w), 5)
        plain_ms = cuda_ms(lambda: conv3d_pertap(x, w, 1), 3)
        library_ms = cuda_ms(lambda: F.conv3d(xt, wt, None, 1, 1), 3)
        gt = g.permute(0, 4, 1, 2, 3)
        dx_ms = cuda_ms(lambda: conv3d_input_grad(g, w, 1), 5)
        dw_ms = cuda_ms(lambda: conv3d_weight_grad(x, g, (3, 3, 3), 1), 5)
        dx_library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_input(
            xt.shape, wt, gt, 1, 1), 3)
        dw_library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            xt, wt.shape, gt, 1, 1), 3)
        # forward, dx and dw each read two of x, w, g and write the third
        bound_ms = bound_of(work, PEAK_BF16_FLOPS)
        phase(f"K5 {name}", tc, max_abs_err=f"{err:.3e}",
              kernel_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              cudnn_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
              tflops=f"{flops / ms / 1e9:.1f}",
              pct_of_bound=f"{100 * bound_ms / ms:.1f}",
              dx_ms=f"{dx_ms:.4f}", dx_cudnn_ms=f"{dx_library_ms:.4f}",
              dx_tflops=f"{flops / dx_ms / 1e9:.1f}",
              dw_ms=f"{dw_ms:.4f}", dw_cudnn_ms=f"{dw_library_ms:.4f}",
              dw_tflops=f"{flops / dw_ms / 1e9:.1f}")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, library_ms=library_ms)
        del x, w, g
        torch.cuda.empty_cache()
    phase("K5", t)
    return out["stereo_stack"]


# ---------------------------------------------------------- training ----
REF_TRAIN = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50,
                        grad_clip=5.0)


def train_two_steps(cfg, device) -> dict:
    """Steps 0 and 1 of a seeded small model on one seeded batch
    (``two_steps``)."""
    model = VernierScale(cfg, device=device,
                         generator=torch.Generator().manual_seed(1))
    state = create_train_state(model, cfg, REF_TRAIN)
    step = make_train_step(cfg, REF_TRAIN, device)
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=7), device)
    return two_steps(state, step, batch)


def two_steps(state, step, batch) -> dict:
    """The losses and clipped gradients of step 0 (rate 0), the buffers
    (BatchNorm statistics) after it, and the parameters after step 1, on
    the CPU."""
    model = state.model
    m = step(state, batch)
    # copies: on the CPU .cpu() is the tensor itself, which step 1 updates
    res = dict(losses={k: float(v) for k, v in m.items()},
               grads={n: p.grad.float().cpu().clone()
                      for n, p in model.named_parameters()},
               stats={n: b.cpu().clone() for n, b in model.named_buffers()})
    step(state, batch)
    res["params"] = {n: p.detach().float().cpu().clone()
                     for n, p in model.named_parameters()}
    return res


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    den = sum(float((b[k] ** 2).sum()) for k in b)
    return math.sqrt(num / max(den, 1e-30))


def check_train_reference(dev) -> None:
    """One training step of a small model (hrnet-tiny, 8x16x16 grid, 4
    instances) on the card against the CPU.  The images are 384x1280, the
    default calibration's frame, so the ROIs hold image content (smaller
    images leave every ROI outside the frame, and float32 BatchNorm
    statistics of constant inputs are ill-conditioned).

    float32 (the fault this slice repairs: a float32 Conv3d went to the
    bf16-only K2 kernel): TF32 off and the matmul precision "highest", so
    the card's float32 work is float32.  Losses within 1e-4 relative,
    gradients within 3e-3 (global relative L2) and 3e-2 of each tensor's
    scale (float32 reordering through ~60 layers and their backward; the
    CPU's float32 gradients were 6e-4 / 4.7e-3 from a float64 run),
    BatchNorm statistics within 1e-4 of scale.  Step 1 is Adam's first
    nonzero update, lr x sign(g): every parameter within 2 x lr, and 97 %
    within 1e-5 (gradient elements within noise of zero may flip).

    bf16: the card's losses and gradients within three times the CPU's own
    bf16 drift from its float32 run, plus 1 % of scale."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_vernier_config(max_instances=4, image_size=(384, 1280))
    ref = train_two_steps(small, "cpu")
    reset_counts()
    got = train_two_steps(small, dev)
    counts = read_counts()
    assert counts == counts_of(K1=2, K1_bwd=2), f"f32 launch counts {counts}"
    fields = assert_f32_step(ref, got, 5e-4)  # rate of step 1

    bf16 = small.replace(compute_dtype="bfloat16")
    cpu_bf16 = train_two_steps(bf16, "cpu")
    reset_counts()
    got = train_two_steps(bf16, dev)
    counts = read_counts()
    assert counts == counts_of(K1=2, K1_bwd=2, K2=6, K2_dx=6, K2_dw=6), \
        f"bf16 launch counts {counts}"
    fields.update(assert_bf16_step(ref, cpu_bf16, got))
    phase("train_reference", t, tf32="off", matmul_precision="highest",
          **fields)


def assert_f32_step(ref: dict, got: dict, lr1: float) -> dict:
    """PR 6's rule for a float32 step on the card against the CPU
    (``two_steps`` results): losses within 1e-4 relative, gradients within
    3e-3 (global relative L2) and 3e-2 of each tensor's scale, buffers
    within 1e-4 of scale; step 1, Adam's first nonzero update (lr1 x
    sign(g)): every parameter within 2 x lr1, 97 % within 1e-5."""
    for k, v in ref["losses"].items():
        assert math.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= 1e-4 * abs(v), \
            f"f32 {k}: {got['losses'][k]} vs {v}"
    g_rel = rel_l2(got["grads"], ref["grads"])
    worst = max(float((got["grads"][n] - w).abs().max())
                / max(float(w.abs().max()), 1e-12)
                for n, w in ref["grads"].items())
    assert g_rel <= 3e-3 and worst <= 3e-2, f"f32 grads {g_rel} {worst}"
    for n, w in ref["stats"].items():
        err = float((got["stats"][n] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1.0), f"{n}: {err}"
    flip = 2.0 * lr1 + 1e-6
    perr = torch.cat([(got["params"][n] - w).abs().ravel()
                      for n, w in ref["params"].items()])
    close = float((perr <= 1e-5).float().mean())
    assert float(perr.max()) <= flip and close >= 0.97, \
        f"f32 params: max {float(perr.max())}, within 1e-5 {close}"
    total_err = abs(got["losses"]["total"] / ref["losses"]["total"] - 1)
    return dict(f32_total_rel_err=f"{total_err:.2e}",
                f32_grad_rel_l2=f"{g_rel:.2e}", f32_grad_worst=f"{worst:.2e}",
                f32_params_within_1e5=f"{close:.4f}")


def assert_bf16_step(ref: dict, cpu_bf16: dict, got: dict) -> dict:
    """A bf16 step on the card: losses and gradients (global relative L2)
    within three times the CPU's own bf16 drift from its float32 step,
    plus 1 % of scale."""
    fields = {}
    for k, v in ref["losses"].items():
        err = abs(got["losses"][k] - v) / max(abs(v), 1e-6)
        drift = abs(cpu_bf16["losses"][k] - v) / max(abs(v), 1e-6)
        assert math.isfinite(got["losses"][k]) and err <= 3 * drift + 0.01, \
            f"bf16 {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"bf16_{k}_rel_err"] = f"{err:.4f}"
        fields[f"bf16_{k}_cpu_rel_err"] = f"{drift:.4f}"
    g_err = rel_l2(got["grads"], ref["grads"])
    g_drift = rel_l2(cpu_bf16["grads"], ref["grads"])
    assert g_err <= 3 * g_drift + 0.01, \
        f"bf16 grads: card {g_err:.4f}, cpu bf16 {g_drift:.4f}"
    fields.update(bf16_grad_rel_l2=f"{g_err:.4f}",
                  bf16_grad_cpu_rel_l2=f"{g_drift:.4f}")
    return fields


def check_train(dev, profile: bool = False, steps: int = 12) -> dict:
    """The JAX CLI's default training config, full width and depth."""
    return train_steps(VernierConfig(), dev, "train", 3, steps, profile)


def train_steps(cfg, dev, label: str, k2_per_step: int, steps: int,
                profile: bool = False) -> dict:
    """``steps`` training steps of ``cfg`` with seeded weights on one
    seeded batch; rate warm-up 2 steps (500 would keep the rate ~0).  The
    loss must be finite and fall; per step K1 1 + 1 backward and K2, dx,
    dw ``k2_per_step`` each."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # the card's defaults
    tc = TrainConfig(warmup_steps=2)
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, tc)
    step = make_train_step(cfg, tc, dev)
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(steps):
        t_step = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(m["total"]))
    counts = read_counts()
    n, k = steps, k2_per_step
    assert counts == counts_of(K1=n, K1_bwd=n, K2=k * n, K2_dx=k * n,
                               K2_dw=k * n), f"{label} launch counts {counts}"
    assert all(math.isfinite(v) for v in losses), f"{label} losses {losses}"
    assert losses[-1] < losses[0], f"{label} loss did not fall: {losses}"
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    I = cfg.max_instances
    phase(label, t, note="TrainConfig.warmup_steps=2",
          loss=",".join(f"{v:.4f}" for v in losses),
          step_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", q1_ms=f"{q1:.1f}", q3_ms=f"{q3:.1f}",
          inst_per_s=f"{I / (med / 1e3):.2f}", peak_mem_gb=f"{peak_gb:.2f}",
          launches_per_step=json.dumps(
              {k: v // n for k, v in counts.items()}).replace(" ", ""))
    if profile:
        profile_request(lambda: step(state, batch))
    del state, model, step, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=times, peak_gb=peak_gb)


# ------------------------------------------------------ K3 / K4 bwd ----
def check_k3_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    # small shapes, f32 and bf16, shared [D] and per-sample [N, D] tables
    # holding 0, integers, fractions and shifts past the row
    for dtype in (torch.float32, torch.bfloat16):
        for shifts in (k3_edge_table(2, 9, 24, gen)[1],
                       k3_edge_table(2, 9, 24, gen)):
            s = shifts.to(dev)
            g = torch.randn((2, 9, 8, 24, 32), generator=gen).to(dev, dtype)
            for name, a, b in zip(("dleft", "dright"),
                                  plane_sweep_volume_k3_bwd(g, s, 24),
                                  plane_sweep_shifted_bwd(g, s, 24)):
                assert_within_ulps(
                    f"K3_bwd small {dtype} {tuple(s.shape)} {name}", a, b)
    # the training shape: a [N, 64, 96, 312, 64] bf16 gradient; N = 2 with
    # a [2, 64] table whose second row holds the edge cases, then one
    # sample at the default calibration's table (timed)
    cfg = StereoConfig()
    H, W = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    C, D = 32, cfg.num_depths
    err = 0.0
    g = torch.randn((2, D, H, W, 2 * C), generator=gen).to(dev, torch.bfloat16)
    table = k3_edge_table(2, D, W, gen).to(dev)
    for name, a, b in zip(("dleft", "dright"),
                          plane_sweep_volume_k3_bwd(g, table, W),
                          plane_sweep_shifted_bwd(g, table, W)):
        err = max(err, assert_within_ulps(f"K3_bwd [2, D] {name}", a, b))
    # the library's backward in float32 against the plain one (the
    # features' values do not enter a linear map's gradient)
    leaves = [torch.zeros((2, H, W, C), device=dev, requires_grad=True)
              for _ in range(2)]
    gf = g.float()
    lib = torch.autograd.grad(k3_library(*leaves, table)(*leaves), leaves,
                              gf.permute(0, 4, 1, 2, 3))
    lib_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                  zip(lib, plane_sweep_shifted_bwd(gf, table, W)))
    del lib, leaves, gf
    g = g[:1].contiguous()
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    shifts = plane_shifts(Pl, Pr, torch.from_numpy(depth_hypotheses(cfg)).to(
        dev))
    for name, a, b in zip(("dleft", "dright"),
                          plane_sweep_volume_k3_bwd(g, shifts, W),
                          plane_sweep_shifted_bwd(g, shifts, W)):
        err = max(err, assert_within_ulps(f"K3_bwd train {name}", a, b))
    times = k3_bwd_times(g, shifts, W)
    phase("K3_bwd", t, max_abs_err=f"{err:.3e}", **times_fields(times),
          library_f32_rel_err=f"{lib_err:.3e}")
    return dict(max_abs_err=err, **times)


def k3_bwd_times(g, shifts, W: int) -> dict:
    """K3's backward kernel / plain / library ms at this gradient and its
    bound.  Library: the backward of k3_library's calls in bf16, timed
    only."""
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: plane_sweep_volume_k3_bwd(g, shifts, W), 20)
    plain_ms = cuda_ms(lambda: plane_sweep_shifted_bwd(g, shifts, W), 3)
    N, H, C = g.shape[0], g.shape[2], g.shape[-1] // 2
    leaves = [torch.zeros((N, H, W, C), device=g.device, dtype=g.dtype,
                          requires_grad=True) for _ in range(2)]
    out = k3_library(*leaves, shifts)(*leaves)
    gt = g.permute(0, 4, 1, 2, 3)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, leaves, gt, retain_graph=True), 3)
    bound_ms = bound_of(k3_bwd_work(N, g.shape[1], H, W, C,
                                    g.element_size(), shifts.numel()),
                        PEAK_F32_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms)


def k4_bwd_near_case(gen, dev):
    """Planes over 1.5-12 m with BEV rows at 2-5 m only (the far planes
    and most feature rows receive nothing: the plan's zero rows) and near
    rows whose x cells span 10-25 of the 96 columns; C = 16, per-sample P
    (tests/test_torch_frustum.py's near case)."""
    depths = np.linspace(1.5, 12.0, 8).astype(np.float32)
    zs = (2.0 + np.arange(12) * 0.25).astype(np.float32)
    xs = (-3.0 + (np.arange(13) + 0.5) * 0.5).astype(np.float32)
    ys = (-0.3 + (np.arange(6) + 0.5) * 0.1).astype(np.float32)
    P = torch.tensor([[400.0, 0, 192.0, 1.0], [0, 400.0, 64.0, -0.2],
                      [0, 0, 1, 0.003]]).repeat(2, 1, 1)
    P[1, 0, 3] += 30.0
    g = torch.randn((2, 12, 13, 6, 16), generator=gen)
    return P.to(dev), k4_tables(depths, zs, xs, ys, dev), g, (8, 32, 96)


def k4_dP(vol, P, tabs, g):
    """P's gradient of K4's wrapper (``FrustumK4``: the volume constant)
    for the output gradient ``g``."""
    P = P.clone().requires_grad_()
    frustum_to_voxel_k4(vol, P, *tabs, 4).backward(g)
    return P.grad


def check_k4_bwd(gen, dev) -> dict:
    t = time.perf_counter()
    # small shapes, both dtypes: rows past both ends of the planes, columns
    # outside the image, per-sample P; then planes and feature rows that
    # receive nothing, and near rows
    P, tabs = k4_small_case(dev)
    Pn, tabs_n, gn, hw_n = k4_bwd_near_case(gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn((2, 10, 12, 4, 16), generator=gen).to(dev, dtype)
        assert_within_ulps(
            f"K4_bwd small {dtype}",
            frustum_to_voxel_k4_bwd(g, P, *tabs, (6, 16, 24), 4),
            frustum_to_voxel_separable_bwd(g, P, *tabs, (6, 16, 24), 4))
        g = gn.to(dev, dtype)
        assert_within_ulps(
            f"K4_bwd near {dtype}",
            frustum_to_voxel_k4_bwd(g, Pn, *tabs_n, hw_n, 4),
            frustum_to_voxel_separable_bwd(g, Pn, *tabs_n, hw_n, 4))
    # the training shape: gradient [1, 288, 300, 20, 32] bf16 -> the
    # [1, 64, 96, 312, 32] volume's, at the default calibration; first the
    # plan kernel against its plain version (the same bits)
    cfg = StereoConfig()
    D, C = cfg.num_depths, 32
    Hf, Wf = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    tabs = k4_tables(depth_hypotheses(cfg), *_bev_axes(cfg), dev)
    nz, nx, ny = (len(a) for a in tabs[2:])
    P = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    u, v, zr, work = frustum_to_voxel_k4_bwd_plan(P, *tabs, (D, Hf, Wf), 4)
    want_u, want_v = _project_uv(P, *tabs[2:], 4)
    want_zr, want_work = k4_bwd_plan(want_u, want_v, tabs[0], tabs[1],
                                     (D, Hf, Wf))
    assert torch.equal(u, want_u) and torch.equal(v, want_v), "K4_bwd plan uv"
    assert torch.equal(zr, want_zr) and torch.equal(work, want_work), \
        "K4_bwd plan rows"
    work_rows = int(work.sum())
    # float32 at the training shape: within 1e-5 of the largest value
    # (plain matmuls in float32, not TF32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.randn((1, nz, nx, ny, C), generator=gen).to(dev)
    got = frustum_to_voxel_k4_bwd(g, P, *tabs, (D, Hf, Wf), 4)
    want = frustum_to_voxel_separable_bwd(g, P, *tabs, (D, Hf, Wf), 4)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    err32 = float((got - want).abs().max())
    assert err32 <= 1e-5 * float(want.abs().max()), \
        f"K4_bwd train f32: max err {err32} > 1e-5 of {want.abs().max()}"
    del got, want
    g = torch.randn((1, nz, nx, ny, C), generator=gen).to(dev, torch.bfloat16)
    got = frustum_to_voxel_k4_bwd(g, P, *tabs, (D, Hf, Wf), 4)
    err = assert_within_ulps(
        "K4_bwd train", got,
        frustum_to_voxel_separable_bwd(g, P, *tabs, (D, Hf, Wf), 4))
    # P's gradient at the training shape: the kernel forward and the
    # autograd of the gather form on the card against the plain forward
    # and the same autograd on the CPU, under the same rule
    vol = torch.randn((1, D, Hf, Wf, C), generator=gen).to(dev, torch.bfloat16)
    dP = k4_dP(vol, P, tabs, g)
    want = k4_dP(vol.cpu(), P.cpu(), [a.cpu() for a in tabs], g.cpu())
    # row by row: the rows of dP differ in scale by orders of magnitude
    dP_err = max(assert_within_ulps(f"K4 dP train row {r}", dP[:, r],
                                    want[:, r].to(dev)) for r in range(3))
    del vol
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: frustum_to_voxel_k4_bwd(g, P, *tabs, (D, Hf, Wf), 4),
                 20)
    plain_ms = cuda_ms(lambda: frustum_to_voxel_separable_bwd(
        g, P, *tabs, (D, Hf, Wf), 4), 3)
    # library: the backward of the 5-D F.grid_sample of phase K4 with
    # respect to its input, timed only
    leaf = torch.zeros((1, C, D, Hf, Wf), dtype=torch.bfloat16, device=dev,
                       requires_grad=True)
    out = F.grid_sample(leaf, k4_library_grid(P, tabs, D, Hf, Wf),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    gout = g.permute(0, 4, 1, 2, 3)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, leaf, gout,
                                                     retain_graph=True), 3)
    bound_ms = bound_of(k4_bwd_work(tuple(g.shape), (D, Hf, Wf),
                                    g.element_size()), PEAK_F32_FLOPS)
    phase("K4_bwd", t, max_abs_err=f"{err:.3e}", kernel_ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", f32_max_abs_err=f"{err32:.3e}",
          dP_max_abs_err=f"{dP_err:.3e}",
          dP_max_abs=f"{float(dP.abs().max()):.3e}",
          work_rows=f"{work_rows}/{work.numel()}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                library_ms=library_ms)


# --------------------------------------------------- stereo training ----
# the JAX stereo training test's optimizer (tests/test_stereo_training.py)
REF_STEREO_TRAIN = TrainConfig(lr=3e-4, warmup_steps=1, total_steps=20,
                               grad_clip=5.0)


def stereo_two_steps(cfg, device) -> dict:
    """Steps 0 and 1 of a seeded tiny StereoNet on one seeded training
    frame with two cars (``two_steps``)."""
    model = StereoNet(cfg, device=device,
                      generator=torch.Generator().manual_seed(1))
    state = create_stereo_state(model, REF_STEREO_TRAIN)
    step = make_stereo_train_step(cfg, REF_STEREO_TRAIN, device)
    batch = stereo_batch_to_device(
        synthetic_stereo_request(cfg, seed=7, boxes_per_frame=2), device)
    return two_steps(state, step, batch)


def check_stereo_train_reference(dev) -> None:
    """One stereo training step of a tiny model (reslike50-det-tiny with
    its BatchNorm stem, 64x128, 16 planes, the JAX training test's 38 m
    range) on the card against the CPU, under phase train_reference's
    rules (TF32 off, matmul precision "highest").  The model's gradients
    are sensitive to float32 rounding order (the port's CPU step against
    JAX's: 1.4e-3 global relative L2), so the float32 step keeps the
    card's other arithmetic near the CPU's:

      * the SPP branches are off: at 64x128 they pool to 1x2 maps whose
        GroupNorm groups hold 2 values (JAX's jitted step against its own
        eager step: 1.2e-2 of the gradients with them);
      * cuDNN is off for the float32 step: its float32 conv algorithms
        moved the gradients by 3.9e-3 from the CPU's, 7.5e-4 without it,
        with K3, K4 and their backwards on the card or their plain
        versions alike (NVIDIA H100 80GB HBM3, 700.00 W).  The cuDNN
        step's drift is printed beside, not gated.

    Neither path runs a kernel of this phase."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_stereo_config(z_max=38.0, max_depth=40.0, branch=False)
    ref = stereo_two_steps(small, "cpu")
    assert ref["losses"]["num_pos"] > 0 and ref["losses"]["depth"] > 0
    reset_counts()
    torch.backends.cudnn.enabled = False
    try:
        got = stereo_two_steps(small, dev)
    finally:
        torch.backends.cudnn.enabled = True
    counts = read_counts()
    assert counts == counts_of(K3=2, K3_bwd=2, K4=2, K4_bwd=2), \
        f"f32 launch counts {counts}"
    fields = assert_f32_step(ref, got, learning_rate(REF_STEREO_TRAIN, 1))
    fields["f32_cudnn_grad_rel_l2"] = \
        f"{rel_l2(stereo_two_steps(small, dev)['grads'], ref['grads']):.2e}"

    bf16 = small.replace(compute_dtype="bfloat16")
    cpu_bf16 = stereo_two_steps(bf16, "cpu")
    reset_counts()
    got = stereo_two_steps(bf16, dev)
    counts = read_counts()
    assert counts == counts_of(K3=2, K3_bwd=2, K4=2, K4_bwd=2), \
        f"bf16 launch counts {counts}"
    fields.update(assert_bf16_step(ref, cpu_bf16, got))
    phase("stereo_train_reference", t, tf32="off",
          matmul_precision="highest", **fields)


def check_stereo_train(dev, profile: bool = False, steps: int = 12) -> dict:
    """StereoConfig() at full width and depth, batch 1 (the JAX CLI's
    default), on one seeded training frame with 4 cars; rate warm-up 2
    steps (500 would keep the rate ~0)."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True  # the card's defaults
    cfg = StereoConfig()
    tc = TrainConfig(warmup_steps=2)
    model = StereoNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    state = create_stereo_state(model, tc)
    step = make_stereo_train_step(cfg, tc, dev)
    batch = stereo_batch_to_device(
        synthetic_stereo_request(cfg, seed=0, boxes_per_frame=4), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses = [], []
    for _ in range(steps):
        t_step = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t_step) * 1e3)
        losses.append(float(m["total"]))
    counts = read_counts()
    n = steps
    assert counts == counts_of(K3=n, K3_bwd=n, K4=n, K4_bwd=n), \
        f"launch counts {counts}"
    assert all(math.isfinite(v) for v in losses), f"losses {losses}"
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    assert float(m["num_pos"]) > 0 and float(m["depth"]) > 0, m
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 2 ** 30
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    phase("stereo_train", t, note="TrainConfig.warmup_steps=2",
          loss=",".join(f"{v:.4f}" for v in losses),
          step_ms=",".join(f"{v:.1f}" for v in times),
          median_ms=f"{med:.1f}", q1_ms=f"{q1:.1f}", q3_ms=f"{q3:.1f}",
          pairs_per_s=f"{1e3 / med:.2f}", peak_mem_gb=f"{peak_gb:.2f}",
          card_mem_gb=f"{card_gb:.1f}", num_pos=f"{float(m['num_pos']):.0f}",
          launches_per_step=json.dumps(
              {k: v // n for k, v in counts.items()}).replace(" ", ""))
    if profile:
        profile_request(lambda: step(state, batch))
    del state, model, step, batch
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms=times)


# --------------------------------------------------------- two_stage ----
TREE_FRAMES, TREE_BOXES, TREE_SEED = 4, 3, 0
# Car AP3D [easy, moderate, hard] under AP11 and AP40 that the JAX
# package's evaluator (snvc_tpu/eval/kitti_ap.py on cpp/kitti_eval.cpp)
# gives on the seeded tree for its GT labels as predictions and
# for write_predictions' noisy proposals; tests/test_torch_serve_run.py
# holds both to JAX's on the CPU.  With 12 cars the protocol's recall
# sampling stops at 12 of its 41 points, so the GT scores 27.27 (AP11).
GT_AS_PRED_AP3D = {"ap11": [27.2727, 27.2727, 27.2727],
                   "ap40": [20.0, 27.5, 27.5]}
PROPOSALS_AP3D = {"ap11": [16.6667, 15.9091, 15.9091],
                  "ap40": [10.2083, 13.6364, 13.6364]}


def write_kitti_tree(root: str, frames: int = TREE_FRAMES,
                     boxes_per_frame: int = TREE_BOXES,
                     seed: int = TREE_SEED) -> dict:
    """A seeded KITTI tree under ``root`` (split "val"): per frame a
    375x1242 stereo pair written by ``encode_png`` with the row filter
    cycling through all five types (a gradient, seeded noise and a flat
    patch over each car's projected box), the default calibration,
    ``boxes_per_frame`` random cars as labels and LiDAR points on the cars
    and the ground.  Returns {"boxes": [[B, 7]], "images": {path: the
    array written}}."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "training")
    for d in ("image_2", "image_3", "calib", "label_2", "velodyne"):
        os.makedirs(os.path.join(base, d), exist_ok=True)
    cl, cr = Calibration.default(), Calibration.default_right()
    grad = np.linspace(40, 200, IMG_H)[:, None, None] * np.ones((1, IMG_W, 3))
    all_boxes, images = [], {}
    for fi in range(frames):
        name = f"{fi:06d}"
        boxes = np.stack([random_box(rng) for _ in range(boxes_per_frame)])
        colors = rng.integers(0, 256, size=(boxes_per_frame, 3))
        all_boxes.append(boxes)
        for d, calib in (("image_2", cl), ("image_3", cr)):
            img = grad + rng.integers(0, 24, size=(IMG_H, IMG_W, 3))
            for b, c in zip(boxes, colors):
                x1, y1, x2, y2 = box2d_of(b, calib).astype(int)
                img[y1:y2 + 1, x1:x2 + 1] = c
            img = np.clip(img, 0, 255).astype(np.uint8)
            path = os.path.join(base, d, name + ".png")
            encode_png(path, img, filters=(0, 1, 2, 3, 4))
            images[path] = img
        with open(os.path.join(base, "calib", name + ".txt"), "w") as f:
            f.write(calib_text())
        lines = [format_label(KittiLabel(
            type="Car", truncation=0.0, occlusion=0,
            alpha=ry_to_alpha(b[3], b[5], b[6]),
            box2d=box2d_of(b, cl).astype(np.float32), box3d=b))
            for b in boxes]
        with open(os.path.join(base, "label_2", name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        pts = np.concatenate(
            [surface_points(b, rng) for b in boxes]
            + [np.stack([rng.uniform(-20, 20, 2000), np.full(2000, 1.7),
                         rng.uniform(5, 45, 2000)], axis=1)])
        pc = np.zeros((len(pts), 4), np.float32)
        pc[:, :3] = cl.rect_to_velo(pts)
        pc[:, 3] = 0.5
        pc.tofile(os.path.join(base, "velodyne", name + ".bin"))
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(f"{i:06d}" for i in range(frames)) + "\n")
    return dict(boxes=all_boxes, images=images)


def write_gt_as_predictions(gt_dir: str, out_dir: str) -> None:
    """The GT label files under ``out_dir/data``, each line with a score
    of its own (1, 0.99, 0.98, ... over the files in order: equal scores
    would cut the protocol's recall sampling short)."""
    os.makedirs(os.path.join(out_dir, "data"))
    k = 0
    for f in sorted(os.listdir(gt_dir)):
        labs = read_label(os.path.join(gt_dir, f))
        for lab in labs:
            lab.score = 1.0 - 0.01 * k
            k += 1
        with open(os.path.join(out_dir, "data", f), "w") as fh:
            fh.write("\n".join(format_label(lab) for lab in labs) + "\n")


def read_dir(d: str) -> dict:
    return {f: open(os.path.join(d, f)).read() for f in sorted(os.listdir(d))}


def check_two_stage(dev, root: str) -> dict:
    """Two-stage serving over a seeded KITTI tree (written under ``root``)
    through the port's CLIs (``main(argv)``), at full width: the detect CLI with a seeded
    StereoConfig() model (K3, K4), the inference_agnostic CLI with a
    seeded flagship Vernier model (K1, K2) over noisy-GT proposals and
    over stage 1's own, and the evaluate CLI.  Seeded weights, so the
    scores are no measure of the model: the gates are the decoder, the
    counters, the files and the evaluator's value on the GT."""
    t = time.perf_counter()
    smi = nvidia_smi()
    tree = write_kitti_tree(root)
    # g++ builds the native loader (and PNG row filter) at first use:
    # time it apart
    t_png = time.perf_counter()
    native_loader.available()
    png_build_s = time.perf_counter() - t_png
    t_dec = time.perf_counter()
    decoded = {path: decode_png(path) for path in tree["images"]}
    decode_ms = (time.perf_counter() - t_dec) * 1e3 / TREE_FRAMES
    for path, img in tree["images"].items():
        assert np.array_equal(decoded[path], img), \
            f"decode_png differs: {path}"
    props = os.path.join(root, "props", "data")
    write_predictions(props, tree["boxes"])

    scfg = StereoConfig()
    save_checkpoint(os.path.join(root, "stereo"), create_stereo_state(
        StereoNet(scfg, device=dev,
                  generator=torch.Generator().manual_seed(0)),
        TrainConfig()), scfg, 0)
    # the filter gate opened, so the seeded model's updates are
    # written (its NCF would reject them all)
    vcfg = flagship_vernier_config(filter_min=-1e9, filter_max=1e9)
    save_checkpoint(os.path.join(root, "vernier"), create_train_state(
        VernierScale(vcfg, device=dev,
                     generator=torch.Generator().manual_seed(0)),
        vcfg, TrainConfig()), vcfg, 0)
    torch.cuda.empty_cache()

    # stage 1: detect the split
    max_boxes = 8
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cli_detect.main([
        "--device", str(dev),
        "--model_dir", os.path.join(root, "stereo"), "--data_path", root,
        "--output_dir", os.path.join(root, "stage1"),
        "--score_threshold", "0", "--max_boxes", str(max_boxes),
        "--prefetch", "2"])
    torch.cuda.synchronize()
    s1 = time.perf_counter() - t1
    counts1 = read_counts()
    assert counts1 == counts_of(K3=TREE_FRAMES, K4=TREE_FRAMES), \
        f"stage 1 launch counts {counts1}"
    stage1 = os.path.join(root, "stage1", "data")
    n_props = []
    for f in sorted(os.listdir(stage1)):
        labs = read_label(os.path.join(stage1, f))
        assert len(labs) <= max_boxes, f"{f}: {len(labs)} lines"
        assert all(np.isfinite(l.box3d).all() for l in labs), f
        n_props.append(len(labs))
    assert len(n_props) == TREE_FRAMES, n_props

    # stage 2 (a): refine the noisy-GT proposals, prefetch 2 and 0
    def refine(pred_dir, out, prefetch, *extra):
        reset_counts()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cli_refine.main([
            "--device", str(dev),
            "--model_dir", os.path.join(root, "vernier"),
            "--data_path", root, "--pred_dir", pred_dir,
            "--output_dir", os.path.join(root, out),
            "--pred_type", "one_part", "all_parts",
            "--prefetch", str(prefetch), *extra])
        torch.cuda.synchronize()
        return time.perf_counter() - t2, read_counts()

    s2, counts2 = refine(props, "refined", 2)
    n_inst = TREE_FRAMES * TREE_BOXES
    batches = TREE_FRAMES  # one frame a batch: 3 cars in 4 slots
    assert counts2 == counts_of(K1=batches, K2=3 * batches), \
        f"stage 2 launch counts {counts2}"
    refined = read_dir(os.path.join(root, "refined", "all_parts", "data"))
    assert refined != read_dir(props), "no box moved"
    for f, text in read_dir(props).items():
        assert len(refined[f].splitlines()) == len(text.splitlines()), f
    s2_sync, _ = refine(props, "refined_sync", 0)
    for t_ in ("one_part", "all_parts"):
        a = read_dir(os.path.join(root, "refined", t_, "data"))
        b = read_dir(os.path.join(root, "refined_sync", t_, "data"))
        assert a == b, f"{t_}: prefetch 2 and 0 wrote different files"

    # stage 2 (b): stage 1's own proposals, 2 batches
    _, counts3 = refine(stage1, "chained", 2, "--max_batches", "2")
    assert counts3 == counts_of(K1=2, K2=6), f"chained counts {counts3}"

    # score: the evaluator (built here with g++) on the GT as
    # predictions and on the noisy proposals, each against JAX's
    # value, then on stage 2 (a)'s output
    t_build = time.perf_counter()
    build_evaluator()
    build_s = time.perf_counter() - t_build
    gt_dir = os.path.join(root, "training", "label_2")
    write_gt_as_predictions(gt_dir, os.path.join(root, "gt_as_pred"))
    for res_dir, want in (("gt_as_pred", GT_AS_PRED_AP3D),
                          ("props", PROPOSALS_AP3D)):
        got = cli_evaluate.main([gt_dir, os.path.join(
            root, res_dir)])["car"]["detection_3d"]
        assert got == want, f"{res_dir}: AP3D {got} != JAX's {want}"
    res = cli_evaluate.main([gt_dir, os.path.join(root, "refined",
                                                  "all_parts")])
    metrics = ("detection", "detection_ground", "detection_3d",
               "orientation")
    assert all(len(res["car"][m]["ap40"]) == 3 for m in metrics), res
    phase("two_stage", t, decode_ms_per_frame=f"{decode_ms:.2f}",
          stage1_cli_wall_s=f"{s1:.3f}",
          stage1_proposals=",".join(map(str, n_props)),
          stage2_cli_wall_s_prefetch2=f"{s2:.3f}",
          stage2_cli_wall_s_prefetch0=f"{s2_sync:.3f}",
          evaluator_build_s=f"{build_s:.2f}",
          png_helper_build_s=f"{png_build_s:.2f}",
          refined_ap3d_ap40=",".join(map(
              str, res["car"]["detection_3d"]["ap40"])),
          note=repr(f"CLI wall seconds for {TREE_FRAMES} frames / "
                    f"{n_inst} instances, checkpoint load and first "
                    "call included"),
          nvidia_smi=repr(smi),
          launches=json.dumps(dict(stage1=counts1, refine=counts2,
                                   chained=counts3)).replace(" ", ""))
    check_two_stage_warm(root, props, dev)
    torch.cuda.empty_cache()
    return dict(counts=counts2)


@contextlib.contextmanager
def no_host_sync():
    """Fails if the block makes a CUDA call that waits for the card
    (torch's sync debug mode), naming the Python stack of each."""
    syncs = set()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            stack = [f for f in traceback.extract_stack()
                     if not f.filename.endswith("warnings.py")][:-1]
            syncs.add(" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                                  for f in reversed(stack[-6:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert not syncs, f"host syncs: {sorted(syncs)}"


def queue_and_wait(requests) -> tuple:
    """Queues every request (each a call that must not wait for the card)
    and then waits: (host ms to queue them all, ms until the card is
    done), from an idle card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    with no_host_sync():
        for request in requests:
            request()
    queued = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    return queued, (time.perf_counter() - t) * 1e3


def alternate(run, reps: int = 3) -> dict:
    """Median wall ms of ``run(prefetch)`` at prefetch 2 and 0, run in
    the order 2 0 0 2 2 0 ... so that drift falls on both."""
    times = {2: [], 0: []}
    for r in range(reps):
        for p in ((2, 0) if r % 2 == 0 else (0, 2)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(p)
            torch.cuda.synchronize()
            times[p].append((time.perf_counter() - t) * 1e3)
    return {p: sorted(v)[len(v) // 2] for p, v in times.items()}


def check_two_stage_warm(root: str, props: str, dev) -> None:
    """The two runners with the phase's checkpoints loaded and warm, on
    the same tree: every request of the split queued with no host sync
    (the host's queueing ms beside the ms until the card is done), and
    ``run`` over the split at --prefetch 2 and 0 (medians of 3, host
    batch building included)."""
    t = time.perf_counter()
    try:  # the check itself must see a known sync
        with no_host_sync():
            torch.ones(1, device=dev).item()
    except AssertionError:
        pass
    else:
        raise AssertionError("no_host_sync missed the sync of .item()")
    ds = KittiDataset(root, "val")
    cfg, model, _ = load_model(os.path.join(root, "vernier"), VernierConfig,
                               VernierScale, dev)
    runner = RefineRunner(model, cfg, device=dev)
    pipe = RefinementPipeline(build_db_from_predictions(ds, cfg, props), cfg,
                              training=False, seed=1, load_lidar=False)
    batches = list(pipe.batches())
    runner.step(batches[0])  # warm-up
    q2, d2 = queue_and_wait(
        [lambda b=b: runner.step(b, host_outputs=()) for b in batches])
    r2 = alternate(lambda p: runner.run(pipe, progress=False, prefetch=p))
    del runner, model
    torch.cuda.empty_cache()

    scfg, smodel, _ = load_model(os.path.join(root, "stereo"), StereoConfig,
                                 StereoNet, dev)
    drunner = DetectRunner(smodel, scfg, max_boxes=8, score_threshold=0.0,
                           device=dev)
    frames = [b.arrays() for b in
              StereoPipeline(ds, scfg, training=False).batches()]
    drunner.forward(frames[0])  # warm-up
    q1, d1 = queue_and_wait([lambda b=b: drunner.forward(b) for b in frames])
    out = os.path.join(root, "stage1_warm")
    r1 = alternate(lambda p: drunner.run(ds, out, prefetch=p))
    del drunner, smodel
    phase("two_stage_warm", t,
          stage1_queue_ms=f"{q1:.1f}", stage1_done_ms=f"{d1:.1f}",
          stage1_run_ms_prefetch2=f"{r1[2]:.1f}",
          stage1_run_ms_prefetch0=f"{r1[0]:.1f}",
          stage2_queue_ms=f"{q2:.1f}", stage2_done_ms=f"{d2:.1f}",
          stage2_run_ms_prefetch2=f"{r2[2]:.1f}",
          stage2_run_ms_prefetch0=f"{r2[0]:.1f}",
          note=repr(f"{len(frames)} frames / {len(batches)} batches of "
                    f"{sum(int(b.valid.sum()) for b in batches)} "
                    "instances, models loaded and warm"),
          nvidia_smi=repr(nvidia_smi()))


# --------------------------------------------------------- train_cli ----
def check_train_cli(dev, root: str) -> dict:
    """Both training CLIs (``main(argv)``) on the tree ``check_two_stage``
    wrote under ``root``, at full width, each run into an experiment
    directory under ``root`` (a temporary directory): train_vernier at its
    default config (VernierConfig(usage="train", sup_type="synthetic"), 8
    instances, bf16) for 4 steps and then --resume to 6; with the offset
    and bbox heads for 2 steps; train_stereo at StereoConfig(), batch 1,
    --augment_flip --photometric_aug, for 4 steps; then detect on the
    trained stereo directory and inference_agnostic --report_loss on the
    trained Vernier one (the GT as proposals).  Warm-up 500 steps, so the
    rate stays near 0: the gates are the counters, finite losses and
    gradients, the resume and the files, not a falling loss."""
    t = time.perf_counter()
    smi = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = True  # the card's defaults
    runs = os.path.join(root, "runs")
    common = ["--device", str(dev), "--data_path", root, "--split", "val",
              "--log_every", "1"]
    total = counts_of()
    timing = {}

    def run(name, cli, argv, steps, want):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = cli(common + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert counts == want, f"{name}: launch counts {counts}"
        for k, v in counts.items():
            total[k] += v
        assert rec["step"] - rec["start_step"] == steps, name
        assert len(rec["metrics"]) == steps, name
        for m in rec["metrics"]:
            assert all(math.isfinite(v) for v in m.values()), f"{name}: {m}"
        ckpt = os.path.join(argv[argv.index("--model_dir") + 1],
                            "checkpoints", f"{rec['step']}.pt")
        timing[name] = dict(
            median_step_ms=float(np.median(rec["step_s"])) * 1e3,
            wall_s=wall, save_s=rec["save_s"][-1],
            checkpoint_mb=os.path.getsize(ckpt) / 2 ** 20)
        return rec

    def per_step(n, **kw):
        return counts_of(**{k: v * n for k, v in kw.items()})

    vernier = dict(K1=1, K1_bwd=1, K2=3, K2_dx=3, K2_dw=3)
    vdir = os.path.join(runs, "vernier")
    r1 = run("train_vernier", cli_train_vernier.main,
             ["--model_dir", vdir, "--steps", "4"], 4, per_step(4, **vernier))
    # what --resume loads is the state the run ended with, bit for bit
    cfg = VernierConfig(usage="train", sup_type="synthetic")
    fresh = create_train_state(VernierScale(cfg, device=dev), cfg,
                               TrainConfig())
    _, at = load_checkpoint(os.path.join(vdir, "checkpoints"), fresh)
    assert at == 4 and fresh.step == r1["state"].step == 4
    assert_states_equal(fresh, r1["state"])
    del fresh, r1
    r2 = run("train_vernier_resume", cli_train_vernier.main,
             ["--model_dir", vdir, "--steps", "6", "--resume"], 2,
             per_step(2, **vernier))
    assert r2["start_step"] == 4 and r2["step"] == 6
    with open(os.path.join(vdir, "metrics.jsonl")) as fh:
        steps = [json.loads(line)["step"] for line in fh]
    assert steps == [1, 2, 3, 4, 5, 6], steps
    ckpts = sorted(os.listdir(os.path.join(vdir, "checkpoints")))
    assert ckpts == ["4.pt", "6.pt", "config.json"], ckpts
    del r2

    heads = os.path.join(root, "heads.json")
    with open(heads, "w") as fh:
        json.dump(dataclasses.asdict(cfg.replace(
            use_bbox_head=True, use_part_reg_head=True)), fh)
    r3 = run("train_vernier_heads", cli_train_vernier.main,
             ["--model_dir", os.path.join(runs, "heads"), "--config", heads,
              "--steps", "2"], 2, per_step(2, **vernier))
    assert all("offset" in m and "bbox" in m for m in r3["metrics"])
    head_grads = [p.grad for n, p in r3["state"].model.named_parameters()
                  if "FCModel" in n or "Conv3d_1" in n or "ConvNorm3d_5" in n]
    assert head_grads and all(torch.isfinite(g).all() for g in head_grads)
    del r3, head_grads
    torch.cuda.empty_cache()

    sdir = os.path.join(runs, "stereo")
    r4 = run("train_stereo", cli_train_stereo.main,
             ["--model_dir", sdir, "--steps", "4", "--augment_flip",
              "--photometric_aug"], 4,
             per_step(4, K3=1, K3_bwd=1, K4=1, K4_bwd=1))
    assert all(m["depth"] > 0 and m["num_pos"] > 0 for m in r4["metrics"])
    del r4
    torch.cuda.empty_cache()

    # the serving CLIs take the trained directories
    reset_counts()
    cli_detect.main(["--device", str(dev), "--model_dir", sdir,
                     "--data_path", root, "--output_dir",
                     os.path.join(root, "stage1_trained")])
    counts = read_counts()
    assert counts == counts_of(K3=TREE_FRAMES, K4=TREE_FRAMES), counts
    for k, v in counts.items():
        total[k] += v
    reset_counts()
    t0 = time.perf_counter()
    res = cli_refine.main([
        "--device", str(dev), "--model_dir", vdir, "--data_path", root,
        "--pred_dir", os.path.join(root, "gt_as_pred", "data"),
        "--output_dir", os.path.join(root, "refined_trained"),
        "--report_loss"])
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    counts = read_counts()
    batches = TREE_FRAMES  # one frame a batch
    assert counts == counts_of(K1=batches, K2=3 * batches), counts
    for k, v in counts.items():
        total[k] += v
    assert len(res["losses"]) == batches, res["losses"]
    for m in res["losses"]:
        assert all(math.isfinite(v) for v in m.values()), m
    torch.cuda.empty_cache()
    phase("train_cli", t,
          **{f"{name}_{k}": f"{v:.3f}" for name, d in timing.items()
             for k, v in d.items()},
          report_loss_wall_s=f"{report_s:.3f}",
          val_total=",".join(f"{m['total']:.4f}" for m in res["losses"]),
          note=repr("median step ms: wall per step, batch building "
                    "included (--log_every 1 syncs each step); save_s / "
                    "checkpoint_mb: the last checkpoint; wall_s: the CLI, "
                    "model build and data included"),
          nvidia_smi=repr(smi),
          launches=json.dumps(total).replace(" ", ""))
    return dict(counts=total)


# ---------------------------------------------------------- variants ----
# the Vernier variants of the serving and training phases: name ->
# (VernierConfig fields, K2 launches a request or step); "w48" is
# BEV_type3 with the widest backbone, the coordinate-map input and the
# gated aggregation
W48 = dict(backbone=BackboneConfig(name="hrnet-w48", add_xy=True),
           feature_aggregation="concat-atten")
VARIANTS = {"BEV_type2": (dict(vernier_type="BEV_type2"), 3),
            "BEV": (dict(vernier_type="BEV"), 0),
            "w48": (W48, 3)}
TRAIN_VARIANTS = {"3D": (dict(vernier_type="3D", grid_type="3D"), 0),
                  **VARIANTS}
VARIANT_STEPS = 8


def check_variants(gen, dev) -> dict:
    """Phase ``variants``: the kernels at the w48 widths, a small model of
    each head on the card against the CPU, flagship serving of BEV_type2,
    BEV and w48, the 3D head's forward (and RefineRunner's refusal of
    it), and VARIANT_STEPS training steps of each variant at
    VernierConfig().  Returns the kernel numbers and the summed launch
    counts of the serving and training runs."""
    t = time.perf_counter()
    kernels = check_variant_kernels(gen, dev)
    check_variant_reference(dev)
    counts = counts_of()
    with torch.inference_mode():
        for name, (kw, k2) in VARIANTS.items():
            res = serve(flagship_vernier_config(**kw), dev,
                        f"variants serving {name}", k2)
            counts = {k: v + res["counts"][k] for k, v in counts.items()}
        res = check_3d_forward(dev)
        counts = {k: v + res[k] for k, v in counts.items()}
    for name, (kw, k2) in TRAIN_VARIANTS.items():
        res = train_steps(VernierConfig(**kw), dev, f"variants train {name}",
                          k2, VARIANT_STEPS)
        counts = {k: v + res["counts"][k] for k, v in counts.items()}
    phase("variants", t, nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(counts).replace(" ", ""))
    return dict(counts=counts, **kernels)


def check_variant_kernels(gen, dev) -> dict:
    """K1 and its backward at C = 48, and K2 / dx / dw at the w48 head's
    widths (96 -> 48 at k7, 48 -> 48 at k5 and k5 d2: F = 48 takes a full
    and a half-empty 32-wide feature block), each against its plain
    version at the w48 paths' shapes, with kernel / plain / library ms
    and the bound."""
    t = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = flagship_vernier_config(**W48)
    C = cfg.backbone.output_channel
    grid, roi = cfg.grid_resolution, cfg.resolution
    lf, rf, _, _ = k1_case(gen, cfg.max_instances, 64, 64, C, (1, 1, 1),
                           roi, bf16, dev)
    gl, gr = batch_projections(cfg, 0, dev)
    err = assert_k1("K1 w48", lf, rf, gl, gr, roi, grid)
    k1 = dict(max_abs_err=err, **k1_times(lf, rf, gl, gr, roi, grid))
    phase("variants K1 w48", t, **times_fields(k1))
    del lf, rf, gl, gr
    tc = time.perf_counter()
    tcfg = VernierConfig(**W48)
    N, tgrid = tcfg.max_instances, tcfg.grid_resolution
    gl, gr = batch_projections(tcfg, 0, dev)
    lf, rf, _, _ = k1_case(gen, N, 64, 64, C, (1, 1, 1), roi, bf16, dev)
    g = torch.randn((N,) + tgrid + (2 * C,), generator=gen).to(dev, bf16)
    err = assert_k1_bwd("K1_bwd w48", lf, rf, gl, gr, g, roi)
    k1_bwd = dict(max_abs_err=err, **k1_bwd_times(lf, rf, gl, gr, g, roi))
    phase("variants K1_bwd w48", tc, **times_fields(k1_bwd))
    del lf, rf, gl, gr, g
    torch.cuda.empty_cache()
    tot = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                   max_abs_err=0.0) for k in ("K2", "dx", "dw")}
    serve_shape = (cfg.max_instances,) + grid
    train_shape = (N,) + tgrid
    convs = (("conv1_k7", 2 * C, (7, 7, 7), 1), ("conv2_k5", C, (5, 5, 5), 1),
             ("conv3_k5_d2", C, (5, 5, 5), 2))
    for name, cin, kernel, dil in convs:
        err, times = run_k2_case(gen, dev, f"w48 {name}",
                                 serve_shape + (cin,), kernel, C, dil, True)
        results = dict(K2=dict(max_abs_err=err, **times))
        results.update(run_k2_bwd_case(gen, dev, f"w48 {name}",
                                       train_shape + (cin,), kernel, C, dil,
                                       True))
        for k, d in results.items():
            for key, v in d.items():
                tot[k][key] = (max(tot[k][key], v) if key == "max_abs_err"
                               else tot[k][key] + v)
    for k, d in tot.items():
        phase(f"variants {k} w48", t, **times_fields(d))
    return dict(K1=k1, K1_bwd=k1_bwd, **tot)


def check_3d_forward(dev) -> dict:
    """The 3D head at the flagship width (9 parts): RefineRunner refuses
    it before any device work (JAX's _finalize fails on its 5-D fields),
    then one forward through the runner's encode and heads gives finite
    fields [4, 9, 32, 192, 192] with K1 once and K2 never.  Returns the
    counts."""
    t = time.perf_counter()
    cfg = flagship_vernier_config(vernier_type="3D")
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    runner = RefineRunner(model, cfg, device=dev)
    batch = synthetic_batch_arrays(cfg, seed=1)
    reset_counts()
    try:
        runner.step(batch)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("RefineRunner served the 3D head")
    assert read_counts() == counts_of(), "the refusal launched kernels"
    arrays = batch_to_device(batch, dev)
    runner.heads(runner.encode(arrays))  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t_fwd = time.perf_counter()
    out = runner.heads(runner.encode(arrays))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_fwd) * 1e3
    counts = read_counts()
    nh, nw, nl = cfg.grid_resolution
    shape = (cfg.max_instances, cfg.num_parts, nh, nw, nl)
    assert tuple(out["ncf"].shape) == shape, tuple(out["ncf"].shape)
    assert bool(torch.isfinite(out["ncf"]).all()), "3D ncf is not finite"
    assert all(out[k] is None for k in out if k != "ncf"), "3D outputs"
    assert counts == counts_of(K1=1), f"3D launch counts {counts}"
    phase("variants 3D", t, ncf=list(shape), forward_ms=f"{ms:.1f}",
          refused=repr(refusal[:40]))
    del runner, model, out
    torch.cuda.empty_cache()
    return counts


def check_variant_reference(dev) -> None:
    """A small model of each head (hrnet-tiny, 8x32x32 grid: 3D, BEV,
    BEV_type2, and BEV_type3 with add_xy and concat-atten) on the card
    against the same weights on the CPU: in float32 (TF32 off) within
    1e-3 of each output's scale (float32 reordering through ~60 layers),
    then in bf16 within three times the CPU's own bf16 drift plus 1 % of
    the scale (phase ``reference``'s rule)."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    heads = {"3D": (dict(vernier_type="3D"), 0),
             "BEV": (dict(vernier_type="BEV"), 0),
             "BEV_type2": (dict(vernier_type="BEV_type2"), 3),
             "xy_atten": (dict(
                 backbone=BackboneConfig(name="hrnet-tiny", add_xy=True),
                 feature_aggregation="concat-atten"), 3)}
    fields = {}
    for name, (kw, k2) in heads.items():
        small = tiny_vernier_config(grid_resolution=(8, 32, 32),
                                    image_size=(128, 256), max_instances=2,
                                    **kw)
        batch = synthetic_batch_arrays(small, seed=7)

        def run(cfg, device):
            model = VernierScale(cfg, device=device,
                                 generator=torch.Generator().manual_seed(1))
            runner = RefineRunner(model, cfg, device=device)
            with torch.inference_mode():
                out = runner.heads(runner.encode(
                    batch_to_device(batch, device)))
            return {k: v.cpu().numpy() for k, v in out.items()
                    if v is not None}

        bf16 = small.replace(compute_dtype="bfloat16")
        ref = run(small, "cpu")
        reset_counts()
        got32 = run(small, dev)
        assert read_counts() == counts_of(K1=1), f"{name} f32 launches"
        cpu_bf16 = run(bf16, "cpu")
        reset_counts()
        got = run(bf16, dev)
        assert read_counts() == counts_of(K1=1, K2=k2), f"{name} launches"
        for k in ref:
            scale = max(float(np.abs(ref[k]).max()), 1e-6)
            err32 = float(np.abs(got32[k] - ref[k]).max()) / scale
            err = float(np.abs(got[k] - ref[k]).max()) / scale
            drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
            assert np.isfinite(got[k]).all(), f"{name} {k} not finite"
            assert err32 <= 1e-3, f"{name} {k}: f32 card rel err {err32}"
            assert err <= 3.0 * drift + 0.01, \
                f"{name} {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
            fields[f"{name}_{k}"] = f"{err32:.1e}/{err:.4f}/{drift:.4f}"
    phase("variants reference", t, note="f32_err/bf16_err/cpu_bf16_drift",
          **fields)


# --------------------------------------------------- synthetic world ----
WORLD_FRAMES, SEQ_FRAMES = 4, 6


def check_synthetic_world(root: str) -> dict:
    """Phase ``synthetic_world``: a WORLD_FRAMES-frame tree (3 cars a
    frame, seed 7) and a SEQ_FRAMES-frame sequence (seed 99) rendered by
    the port on the host; the tree rendered again gives the same bytes;
    each PNG decodes to the array rendered.  Returns the sequence's root
    and GT boxes."""
    t = time.perf_counter()
    rendered, render_s = [], []
    real = synthetic.render_scene

    def capture(*args, **kw):
        t0 = time.perf_counter()
        img = real(*args, **kw)
        render_s.append(time.perf_counter() - t0)
        rendered.append(img)
        return img

    synthetic.render_scene = capture
    try:
        tree, seq = os.path.join(root, "world"), os.path.join(root, "seq")
        t0 = time.perf_counter()
        make_synthetic_kitti(tree, WORLD_FRAMES, 3, seed=7, reuse=False)
        tree_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seq_boxes = make_synthetic_sequence(seq, SEQ_FRAMES, seed=99)
        seq_s = time.perf_counter() - t0
    finally:
        synthetic.render_scene = real
    assert len(rendered) == 2 * (WORLD_FRAMES + SEQ_FRAMES), len(rendered)
    views = [(tree, i) for i in range(WORLD_FRAMES)] + \
        [(seq, i) for i in range(SEQ_FRAMES)]
    t0 = time.perf_counter()
    for k, (r, i) in enumerate(views):
        for v, cam in enumerate(("image_2", "image_3")):
            png = os.path.join(r, "training", cam, f"{i:06d}.png")
            assert np.array_equal(decode_png(png), rendered[2 * k + v]), png
    decode_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(views))
    again = os.path.join(root, "world_again")
    make_synthetic_kitti(again, WORLD_FRAMES, 3, seed=7, reuse=False)
    assert tree_bytes(tree) == tree_bytes(again), "a second render differs"
    phase("synthetic_world", t, tree_s_per_frame=f"{tree_s / WORLD_FRAMES:.3f}",
          seq_s_per_frame=f"{seq_s / SEQ_FRAMES:.3f}",
          render_s_per_view=f"{np.median(render_s):.3f}",
          decode_ms_per_view=f"{decode_ms:.2f}",
          frames=f"{WORLD_FRAMES}+{SEQ_FRAMES}",
          note=repr("s a frame: both views, labels, calib, LiDAR and PNG "
                    "writes; render alone: median a view; host CPU"))
    return dict(seq=seq, seq_boxes=seq_boxes,
                tree_s=tree_s / WORLD_FRAMES, seq_s=seq_s / SEQ_FRAMES)


def tree_bytes(root: str) -> dict:
    """{path under ``root``: bytes} of every file below ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def check_track(dev, root: str, world: dict) -> dict:
    """Phase ``track``: tools/track.py over the sequence with a seeded
    flagship model saved as a model directory, at --motion static and cv
    (K1 = frames, K2 = 3 x frames a run, finite boxes), then the loaded
    tracker warm, ms a frame.  Returns the summed counts."""
    t = time.perf_counter()
    cfg = flagship_vernier_config()
    mdir = os.path.join(root, "flagship_model")
    os.makedirs(mdir)
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    torch.save({"step": 0, "model": model.state_dict()},
               os.path.join(mdir, "0.pt"))
    save_config(cfg, os.path.join(mdir, "config.json"))
    del model
    n = SEQ_FRAMES
    init = world["seq_boxes"][0][0]
    total = counts_of()
    fields = {}

    def counted(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        assert counts == counts_of(K1=n, K2=3 * n), f"{label}: {counts}"
        for k, v in counts.items():
            total[k] += v
        assert len(states) == n and all(
            st.box.shape == (7,) and np.isfinite(st.box).all()
            for st in states), label
        return states, wall

    for motion in ("static", "cv"):
        argv = ["--model_dir", mdir, "--data_path", world["seq"],
                "--frames", *[str(i) for i in range(n)], "--init_box",
                *[str(float(v)) for v in init], "--motion", motion,
                "--device", str(dev)]
        states, wall = counted(f"track {motion}",
                               lambda: cli_track.main(argv))
        fields[f"cli_{motion}_wall_s"] = f"{wall:.3f}"
        fields[f"{motion}_kept"] = sum(st.kept for st in states)
    cfg1, model, _ = load_model(mdir, VernierConfig, VernierScale, dev)
    cfg1 = cfg1.replace(max_instances=1)
    tracker = Tracker(RefineRunner(model, cfg1, device=dev), cfg1)
    scenes = KittiDataset(world["seq"], "val").scenes()
    tracker.step_frame(scenes[0], init)  # warm-up
    _, warm = counted("track warm", lambda: tracker.track(scenes, init))
    del tracker, model
    torch.cuda.empty_cache()
    phase("track", t, frames=n, ms_per_frame=f"{warm * 1e3 / n:.1f}",
          **fields, nvidia_smi=repr(nvidia_smi()),
          note=repr("cli wall: model load and first call included; "
                    "ms_per_frame: warm, a synchronized step a frame"),
          launches=json.dumps(total).replace(" ", ""))
    return dict(counts=total, ms_per_frame=warm * 1e3 / n)


# the keys of JAX's result JSON (tools/demo_ap_lift.py:178-198,
# demo_tracking.py:225-236, demo_two_stage.py:526-553)
DEMO_KEYS = {
    "demo_ap_lift": (
        "ap3d_proposals", "apbev_proposals", "steps", "noise_m",
        "ap3d_refined_one_part", "apbev_refined_one_part",
        "ap3d_refined_all_parts", "apbev_refined_all_parts",
        "lift_3d_moderate", "mean_center_err_proposal_m",
        "mean_center_err_refined_m"),
    "demo_tracking": (
        "seq_frames", "motion_m_per_frame", "tracker_err_m",
        "static_prior_err_m", "tracker_err_mean_m", "tracker_err_max_m",
        "static_prior_err_final_m", "kept_frames", "train_steps", "motion"),
    "demo_two_stage": (
        "ap3d_proposals", "apbev_proposals", "ap3d_proposals_iou50",
        "stereo_steps", "vernier_steps", "proposal_noise_loc_m",
        "proposal_noise_rot_deg", "ncf_decode", "ncf_subvoxel",
        "ap3d_refined_one_part", "apbev_refined_one_part",
        "ap3d_refined_one_part_iou50", "ap3d_refined_all_parts",
        "apbev_refined_all_parts", "ap3d_refined_all_parts_iou50",
        "ap3d_moderate_proposals", "ap3d_moderate_refined_best",
        "lift_3d_moderate"),
}
# each demo's cut: its flags (the JAX defaults are 3000 / 600 / 6000 +
# 1500 steps over 48 / 48 / 192 train frames)
DEMO_CUTS = {
    "demo_ap_lift": ["--steps", "20", "--train_frames", "4",
                     "--val_frames", "2"],
    "demo_tracking": ["--steps", "20", "--train_frames", "4",
                      "--seq_frames", "4"],
    "demo_two_stage": ["--stereo_steps", "10", "--vernier_steps", "10",
                       "--train_frames", "4", "--val_frames", "2"],
}
VERNIER_STEP = dict(K1=1, K1_bwd=1, K2=3, K2_dx=3, K2_dw=3)


def demo_counts(name: str, work: str) -> dict:
    """The launches a demo's cut must make: its training steps, and K1 x1,
    K2 x3 a refined batch (one frame's proposals) / K3, K4 x1 a detected
    frame."""
    def per(n, **kw):
        return {k: v * n for k, v in kw.items()}

    def plus(*ds):
        return counts_of(**{k: sum(d.get(k, 0) for d in ds)
                            for k in KERNELS})

    if name == "demo_ap_lift":  # 2 val frames, refined then re-served
        return plus(per(20, **VERNIER_STEP), per(2 * 2, K1=1, K2=3))
    if name == "demo_tracking":  # one request a sequence frame
        return plus(per(20, **VERNIER_STEP), per(4, K1=1, K2=3))
    data = os.path.join(work, "proposals", "data")
    batches = sum(1 for f in os.listdir(data)
                  if open(os.path.join(data, f)).read().strip())
    return plus(per(10, K3=1, K3_bwd=1, K4=1, K4_bwd=1),
                per(2, K3=1, K4=1), per(10, **VERNIER_STEP),
                per(batches, K1=1, K2=3))


def check_demos(dev, root: str) -> dict:
    """Phase ``demos``: each end-metric demo at its cut (DEMO_CUTS):
    JAX's JSON keys with finite values, the launch counts of its steps
    and requests, its wall seconds.  Returns the summed counts."""
    t = time.perf_counter()
    total = counts_of()
    fields = {}
    for name, mod in (("demo_ap_lift", demo_ap_lift),
                      ("demo_tracking", demo_tracking),
                      ("demo_two_stage", demo_two_stage)):
        work = os.path.join(root, name)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = mod.main(DEMO_CUTS[name] + ["--work_dir", work,
                                             "--log_every", "10",
                                             "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert set(result) == set(DEMO_KEYS[name]), \
            f"{name}: keys {sorted(set(result) ^ set(DEMO_KEYS[name]))}"
        for k, v in result.items():
            if not isinstance(v, str):
                assert np.isfinite(np.asarray(v, np.float64)).all(), (name, k)
        counts = read_counts()
        want = demo_counts(name, work)
        assert counts == want, f"{name}: launch counts {counts} != {want}"
        for k, v in counts.items():
            total[k] += v
        fields[f"{name}_wall_s"] = f"{wall:.2f}"
        fields[f"{name}_cut"] = repr(" ".join(DEMO_CUTS[name]))
        key = {"demo_ap_lift": "lift_3d_moderate",
               "demo_tracking": "tracker_err_mean_m",
               "demo_two_stage": "ap3d_moderate_proposals"}[name]
        fields[f"{name}_{key}"] = f"{result[key]:.4f}"
        torch.cuda.empty_cache()
    phase("demos", t, **fields, nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(total).replace(" ", ""))
    return dict(counts=total)


# ------------------------------------------------ release_checkpoint ----
# phase release_checkpoint's seeded val tree: frames x cars, its seed
RELEASE_FRAMES, RELEASE_CARS, RELEASE_SEED = 4, 3, 19
RELEASE_KEYS = {"proposals", "one_part", "all_parts"}


def check_converted_reference(dev) -> dict:
    """A fabricated reference checkpoint of a small BEV_type3 model
    (hrnet-tiny, 8x32x32 grid, the part-offset and bbox heads) converted
    by ``utils/convert_torch`` and run on the card against the same
    converted weights on the CPU: float32 (TF32 off) within 1e-3 of each
    output's scale, bf16 under phase ``reference``'s rule (three times
    the CPU's own bf16 drift plus 1 % of the scale)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    small = tiny_vernier_config(grid_resolution=(8, 32, 32),
                                image_size=(128, 256), max_instances=2,
                                use_part_reg_head=True, use_bbox_head=True)
    target = VernierScale(small, device="cpu").state_dict()
    sd = convert_vernier_checkpoint(
        fabricate_vernier_state_dict(target, True, True,
                                     np.random.default_rng(0)),
        target, use_part_reg_head=True, use_bbox_head=True)
    batch = synthetic_batch_arrays(small, seed=7)

    def run(cfg, device):
        model = VernierScale(cfg, device=device)
        model.load_state_dict(sd, strict=True)
        runner = RefineRunner(model, cfg, device=device)
        with torch.inference_mode():
            out = runner.heads(runner.encode(batch_to_device(batch, device)))
        return {k: v.cpu().numpy() for k, v in out.items() if v is not None}

    bf16 = small.replace(compute_dtype="bfloat16")
    ref = run(small, "cpu")
    assert set(ref) == {"ncf", "occupancy", "offset", "coordinates", "bbox"}
    reset_counts()
    got32 = run(small, dev)
    assert read_counts() == counts_of(K1=1), "converted f32 launches"
    cpu_bf16 = run(bf16, "cpu")
    reset_counts()
    got = run(bf16, dev)
    assert read_counts() == counts_of(K1=1, K2=3), "converted launches"
    fields = {}
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        err32 = float(np.abs(got32[k] - ref[k]).max()) / scale
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert np.isfinite(got[k]).all(), f"converted {k} not finite"
        assert err32 <= 1e-3, f"converted {k}: f32 card rel err {err32}"
        assert err <= 3.0 * drift + 0.01, \
            f"converted {k}: card rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"small_{k}"] = f"{err32:.1e}/{err:.4f}/{drift:.4f}"
    return fields


def release_batch_ms(model, cfg, val_root, pred_dir, dev) -> float:
    """Median ms a warm refinement batch of the converted release model
    over the tree's proposals (each batch served twice, the second
    timed, synchronized)."""
    ds = KittiDataset(val_root, "val")
    pipe = RefinementPipeline(build_db_from_predictions(ds, cfg, pred_dir),
                              cfg, training=False, load_lidar=False)
    runner = RefineRunner(model, cfg, device=dev)
    times = []
    with torch.inference_mode():
        for batch in pipe.batches():
            runner.step(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def roiaware_on_card(dev, work: str) -> dict:
    """``roiaware_pool3d`` on the card against the CPU on a diagnosed
    frame's LiDAR, its proposals and its GT boxes enlarged by 10 % (the
    synthetic points lie on the GT boxes' faces, where float32 rounding
    decides; an untrained model's proposals may hold no point), max and
    avg of random features: the voxels that differ (a point within
    rounding of a voxel edge lands on either side) and the largest
    difference elsewhere; avg twice on the card gives the same bits."""
    ds = KittiDataset(os.path.join(work, "kitti_val"), "val")
    scene = ds.scene(ds.indices[0])
    pts = scene.calibration("left").velo_to_rect(
        scene.lidar()[:, :3]).astype(np.float32)
    lines = open(os.path.join(work, "diag_val_props", "data",
                              scene.name + ".txt")).read().split("\n")
    gt = np.array([lb.box3d for lb in scene.labels()], np.float32)
    gt[:, :3] *= 1.1
    boxes = np.concatenate([np.array(
        [[float(v) for v in ln.split()[8:15]] for ln in lines if ln.strip()],
        np.float32).reshape(-1, 7), gt])
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((len(pts), 4)).astype(np.float32)
    valid = np.ones(len(pts), bool)
    args = [torch.from_numpy(a) for a in (pts, feats, valid, boxes)]
    out = {"roiaware_boxes": len(boxes)}
    for mode in ("max", "avg"):
        ref = roiaware_pool3d(*args, (6, 6, 6), mode=mode)
        out[f"roiaware_{mode}_filled"] = int((ref != 0).any(-1).sum())
        assert out[f"roiaware_{mode}_filled"] > 0, "roiaware: nothing pooled"
        got = roiaware_pool3d(*(a.to(dev) for a in args), (6, 6, 6),
                              mode=mode)
        if mode == "avg":
            again = roiaware_pool3d(*(a.to(dev) for a in args), (6, 6, 6),
                                    mode=mode)
            assert torch.equal(got, again), "roiaware avg not deterministic"
        diff = (got.cpu() - ref).abs().amax(dim=-1)
        moved = int((diff > 1e-5).sum())
        assert moved <= 2, f"roiaware {mode}: {moved} voxels differ"
        out[f"roiaware_{mode}_voxels_moved"] = moved
        out[f"roiaware_{mode}_max_err"] = (
            f"{float(diff[diff <= 1e-5].max()):.1e}")
    return out


def seeded_stage1_dir(work: str, dev) -> None:
    """A stage-1 work directory like ``demo_two_stage``'s cut run: a
    seeded StereoNet at its config saved as ``stereo_ckpt`` (step 0) and
    its 4-frame train and 2-frame val trees."""
    scfg = demo_two_stage.stereo_config(demo_two_stage.parse_args([]))
    model = StereoNet(scfg, device=dev,
                      generator=torch.Generator().manual_seed(5))
    save_checkpoint(os.path.join(work, "stereo_ckpt"),
                    create_stereo_state(model, TrainConfig()), scfg, 0)
    make_synthetic_kitti(os.path.join(work, "kitti_train"), 4, 3, seed=0,
                         split="train")
    make_synthetic_kitti(os.path.join(work, "kitti_val"), 2, 3, seed=1000,
                         split="val")


def check_release_checkpoint(dev, root: str) -> dict:
    """Phase ``release_checkpoint``: (a) a small converted model on the
    card against the CPU; (b) a fabricated release-shaped tar at
    ``validate_epoch80.release_config`` (hrnet-w48, GroupNorm, 32x192x192,
    256x256 ROIs, 8 instances, bf16) through ``validate_epoch80.main``
    over a seeded 4-frame x 3-car val tree with noisy-GT proposals (K1 =
    batches, K2 = 3 x batches; validation.json with JAX's keys, finite);
    (c) ``diagnose_proposals.main`` on phase ``demos``' demo_two_stage
    work directory (a seeded one if it is gone): K3 = K4 = frames decoded,
    the coverage keys present, ``roiaware_pool3d`` on the card.  Returns
    the launches of (b) and (c)."""
    t = time.perf_counter()
    fields = check_converted_reference(dev)
    work = os.path.join(root, "release_checkpoint")
    os.makedirs(work, exist_ok=True)

    # (b) the release path
    argv = ["--device", str(dev)]
    args = validate_epoch80.parse_args(argv)
    cfg = validate_epoch80.release_config(args)
    tb = time.perf_counter()
    sd = fabricate_vernier_state_dict(
        VernierScale(cfg, device="cpu").state_dict())
    tar = os.path.join(work, "epoch_80.tar")
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in sd.items()}}, tar)
    fab_s = time.perf_counter() - tb
    val_root = os.path.join(work, "kitti_val")
    boxes = make_synthetic_kitti(val_root, RELEASE_FRAMES, RELEASE_CARS,
                                 seed=RELEASE_SEED, split="val")
    pred_dir = os.path.join(work, "proposals")
    write_predictions(pred_dir, boxes, noise=0.2)
    out_dir = os.path.join(work, "validation")
    batches = sum(1 for f in os.listdir(pred_dir)
                  if open(os.path.join(pred_dir, f)).read().strip())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = validate_epoch80.main(
        ["--checkpoint", tar, "--data_path", val_root, "--split", "val",
         "--pred_dir", pred_dir, "--out_dir", out_dir] + argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = counts_of(K1=batches, K2=3 * batches)
    assert counts == want, f"validate_epoch80 launches {counts} != {want}"
    with open(os.path.join(out_dir, "validation.json")) as f:
        written = json.load(f)
    assert written == result and set(result) == RELEASE_KEYS, sorted(result)
    for k, v in result.items():
        assert set(v) == {"ap3d_40", "apbev_40"}, (k, v)
        assert np.isfinite(np.asarray(list(v.values()), np.float64)).all()
    # the conversion alone, and the converted model's warm batches
    tl = time.perf_counter()
    state_dict = load_torch_checkpoint(tar)
    load_s = time.perf_counter() - tl
    torch.cuda.synchronize()
    tc = time.perf_counter()
    model, rcfg = validate_epoch80.convert(args, cfg, state_dict,
                                           lambda m: None)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - tc
    batch_ms = release_batch_ms(model, rcfg, val_root, pred_dir, dev)
    del model
    torch.cuda.empty_cache()
    fields.update(
        tar_tensors=len(sd), fabricate_s=f"{fab_s:.2f}",
        tar_load_s=f"{load_s:.2f}", convert_s=f"{convert_s:.2f}",
        batches=batches, batch_ms_median=f"{batch_ms:.1f}",
        validate_peak_gb=f"{peak_gb:.2f}", validate_wall_s=f"{wall:.2f}",
        ap3d_refined_all_parts=repr(result["all_parts"]["ap3d_40"]))
    total = dict(counts)

    # (c) the stage-1 diagnostic
    diag = os.path.join(root, "demo_two_stage")
    if not os.path.isdir(os.path.join(diag, "stereo_ckpt")):
        diag = os.path.join(work, "stage1")
        seeded_stage1_dir(diag, dev)
        fields["diagnosed"] = "seeded"
    frames = sum(len(KittiDataset(os.path.join(diag, f"kitti_{sp}"), sp))
                 for sp in ("train", "val"))
    reset_counts()
    t0 = time.perf_counter()
    # demo_two_stage's stage 1 trains with its depth offset head
    stats = diagnose_proposals.main(
        ["--work_dir", diag, "--depth_offset", "--score_threshold", "0.0"]
        + argv)
    torch.cuda.synchronize()
    diag_wall = time.perf_counter() - t0
    counts = read_counts()
    want = counts_of(K3=frames, K4=frames)
    assert frames > 0 and counts == want, \
        f"diagnose_proposals launches {counts} != {want}"
    assert set(stats) == {"train", "val"}, sorted(stats)
    for split, d in stats.items():
        missing = {"n_proposals", "n_gt", "center_med_m", "within_1m",
                   "pts_in_proposal_med", "pts_in_gt_med",
                   "coverage_ratio_med", "occ_frac_med"} - set(d)
        assert not missing, (split, missing)
        assert all(np.isfinite(v) for v in d.values()), (split, d)
    fields.update(roiaware_on_card(dev, diag))
    for k, v in counts.items():
        total[k] += v
    fields.update(diagnose_frames=frames, diagnose_wall_s=f"{diag_wall:.2f}",
                  val_coverage_ratio_med=stats["val"]["coverage_ratio_med"])
    phase("release_checkpoint", t, **fields, nvidia_smi=repr(nvidia_smi()),
          note=repr("small_*: f32_err/bf16_err/cpu_bf16_drift; "
                    "convert_s: model build on the card + conversion + "
                    "load; batch_ms: warm, synchronized; validate_wall_s: "
                    "tar load, conversion, 4 batches, 3 evaluations"),
          launches=json.dumps(total).replace(" ", ""))
    return dict(counts=total)


# ------------------------------------------------- trained_two_stage ----
# JAX's trained two-stage run (artifacts/two_stage_r4: demo_two_stage's
# 128-frame val split, its stage-1 proposals and recorded AP) scored
# through the port's CLIs with the committed conversions of its two
# checkpoints (artifacts/two_stage_r4_torch) and held to the JAX float32
# CPU witnesses committed beside them.
REPO = os.path.dirname(os.path.abspath(__file__))
TRAINED = os.path.join(REPO, "artifacts", "two_stage_r4_torch")
WITNESS = os.path.join(TRAINED, "witness")
JAX_RUN = os.path.join(REPO, "artifacts", "two_stage_r4")
VAL_FRAMES, VAL_CARS, VAL_SEED = 128, 3, 1000
# demo_two_stage's stage-1 settings (--max_proposals, --score_threshold,
# --nms_iou) and its refinement config (scripts/two_stage_parity._infer_cfg)
STAGE1_ARGS = ["--max_boxes", "8", "--score_threshold", "0.02",
               "--nms_iou", "0.25"]
STAGE1_THRESHOLD = 0.02
REFINE_FIELDS = dict(usage="inference", sup_type="real", augment=False,
                     pred_type=["one_part", "all_parts"],
                     ncf_decode="argmax")
PRED_TYPES = ("one_part", "all_parts")
WITNESS_FRAMES = 16  # stage 1's float32 witness
VIZ_FRAMES = 4


def start_val_render(root: str) -> subprocess.Popen:
    """The val split of JAX's trained run, ``make_synthetic_kitti(root,
    128, 3, seed=1000, split="val")``, rendered by a child process on the
    host while the phases before ``trained_two_stage`` use the card; it
    prints its wall seconds as JSON."""
    code = ("import json, sys, time\n"
            "from snvc_tpu_torch.data.synthetic import make_synthetic_kitti\n"
            "t = time.perf_counter()\n"
            f"make_synthetic_kitti(sys.argv[1], {VAL_FRAMES}, {VAL_CARS}, "
            f"seed={VAL_SEED}, split='val')\n"
            "print(json.dumps({'render_s': time.perf_counter() - t}))\n")
    return subprocess.Popen([sys.executable, "-c", code, root], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


class ValRender:
    """``start_val_render`` into a temporary directory; the child is
    stopped and the directory removed when the script exits."""

    def __init__(self):
        self.root = tempfile.mkdtemp(prefix="snvc_val_")
        self.proc = start_val_render(self.root)
        self.render_s = None
        atexit.register(self.close)

    def wait(self) -> float:
        """The render's wall seconds; raises if it failed."""
        if self.render_s is None:
            out, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, \
                f"val render failed: {err[-2000:]}"
            self.render_s = float(
                json.loads(out.strip().splitlines()[-1])["render_s"])
        return self.render_s

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        shutil.rmtree(self.root, ignore_errors=True)


def model_dir_with(src: str, dst: str, **fields) -> str:
    """A model directory ``dst``: ``src``'s config.json with ``fields``
    replaced, beside a link to each of ``src``'s checkpoints."""
    os.makedirs(dst)
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg.update(fields)
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    for name in os.listdir(src):
        if name.endswith(".pt"):
            os.symlink(os.path.join(src, name), os.path.join(dst, name))
    return dst


def refine_batches(val_root: str, pred_dir: str, model_dir: str) -> int:
    """The refinement batches of ``pred_dir``'s proposals: a frame's
    proposals in batches of ``max_instances`` (frames_per_batch 1)."""
    cfg = load_config(os.path.join(model_dir, "config.json"), VernierConfig)
    db = build_db_from_predictions(KittiDataset(val_root, "val"), cfg,
                                   pred_dir)
    per_frame = {}
    for rec in db:
        per_frame[rec.scene.index] = per_frame.get(rec.scene.index, 0) + 1
    assert cfg.frames_per_batch == 1, cfg.frames_per_batch
    return sum(-(-n // cfg.max_instances) for n in per_frame.values())


def moderate(res: dict, metric: str = "detection_3d") -> float:
    return res["car"][metric]["ap40"][1]


def timed(fn, *args):
    """(fn(*args), wall seconds, launch counts), the card synchronized."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts()


def check_viz(val_root: str, pred_dir: str, work: str) -> dict:
    """``tools/visualize.py`` in both modes over VIZ_FRAMES frames: every
    PNG decodes at its size (the frame's, TopViewSpec's 501 x 301), and in
    the camera renders a pixel within 1 px of each projected corner of a
    drawn edge differs from the frame."""
    from snvc_tpu_torch.tools import visualize as cli_visualize
    from snvc_tpu_torch.viz.tracebox import box_edges_2d

    cam, top = os.path.join(work, "viz"), os.path.join(work, "viz_top")
    assert cli_visualize.main(["--pred_dir", pred_dir, "--data_path",
                               val_root, "--out_dir", cam, "--max_frames",
                               str(VIZ_FRAMES)]) == VIZ_FRAMES
    assert cli_visualize.main(["--pred_dir", pred_dir, "--data_path",
                               val_root, "--out_dir", top, "--top_view",
                               "--max_frames", str(VIZ_FRAMES)]) == VIZ_FRAMES
    ds = KittiDataset(val_root, "val")
    corners = 0
    for name in sorted(os.listdir(cam)):
        scene = ds.scene(int(name[:6]))
        frame = scene.load_image("left")
        img = decode_png(os.path.join(cam, name))
        assert img.shape == frame.shape, (name, img.shape)
        labels = read_label(os.path.join(pred_dir, name[:6] + ".txt"))
        boxes = np.array([lb.box3d for lb in labels]).reshape(-1, 7)
        h, w = img.shape[:2]
        for _, uv0, uv1, _ in box_edges_2d(boxes, scene.calibration("left")):
            for x, y in (np.round(uv0).astype(int), np.round(uv1).astype(int)):
                if 0 <= x < w and 0 <= y < h:
                    ys = slice(max(y - 1, 0), y + 2)
                    xs = slice(max(x - 1, 0), x + 2)
                    assert (img[ys, xs] != frame[ys, xs]).any(), \
                        f"visualize {name}: corner ({x}, {y}) not drawn"
                    corners += 1
    assert corners > 0, "visualize: no corner in the frames"
    for name in os.listdir(top):
        assert decode_png(os.path.join(top, name)).shape == (501, 301, 3)
    return dict(viz_pngs=len(os.listdir(cam)) + len(os.listdir(top)),
                viz_corners_checked=corners)


def check_debug_panels(paths: dict, model_dir: str, val_root: str,
                       pred_dir: str, dev) -> None:
    """``--debug``'s panels: each decodes; in the NCF panel the brightest
    pixel of each part's map lies on its argmax cell (the batch's NCF
    computed again); the update panel holds the proposals' and both
    refinements' colours."""
    from snvc_tpu_torch.viz import debug

    cfg, model, _ = load_model(model_dir, VernierConfig, VernierScale, dev)
    pipe = RefinementPipeline(build_db_from_predictions(
        KittiDataset(val_root, "val"), cfg, pred_dir), cfg, training=False,
        load_lidar=False)
    out = RefineRunner(model, cfg, device=dev).step(
        next(iter(pipe.batches())), host_outputs=("ncf",))
    maps = debug.ncf_maps(out["ncf"])
    img = decode_png(paths["ncf"])
    px = debug.CELL_PX
    h, w = maps.shape[1] * px, maps.shape[2] * px
    for p, m in enumerate(maps):
        y, x = debug.panel_origin(p, 3, (h, w))
        panel = img[y:y + h, x:x + w].astype(np.int64).sum(-1)
        i, j = np.unravel_index(np.argmax(m), m.shape)
        row = (m.shape[0] - 1 - i) * px
        assert panel[row:row + px, j * px:(j + 1) * px].min() == \
            panel.max(), f"--debug NCF part {p}: peak off its argmax cell"
    decode_png(paths["occupancy"])
    upd = decode_png(paths["update"])
    for key in ("proposal", "one_part", "all_parts"):
        assert (upd == debug.UPDATE_COLORS[key]).all(-1).any(), key


def check_trained_two_stage(dev, root: str, render: ValRender) -> dict:
    """Phase ``trained_two_stage``: JAX's trained checkpoints, converted
    and committed (artifacts/two_stage_r4_torch), served on the card over
    the 128-frame val split that ``render`` drew.
    bf16 (the checkpoints' dtype): the detect CLI over every frame (K3 =
    K4 = 128), its AP beside JAX's recorded bf16 TPU run (a witness, not a
    gate); the inference_agnostic CLI on JAX's 181 committed proposals and
    on the port's own (K1 = batches, K2 = 3 x batches), their AP beside
    JAX's.  Float32 with TF32 off: the refinement of the 181 proposals
    held to witness (a) (AP3D moderate within 0.05 of JAX's float32 CPU
    value for each pred type; boxes over 1e-3 and the largest field
    difference printed); with cuDNN off too, stage 1 on the first 16
    frames held to witness (b) (boxes paired by nearest BEV centre, every
    field within 1e-3 m / rad; a box on one side only within 1e-3 of the
    0.02 threshold).  Then diagnose_refinement over the run's work dir
    (each decode's row), visualize in both modes over 4 frames and
    inference_agnostic --debug over one batch.  Returns the launches."""
    t = time.perf_counter()
    render_s = render.wait()
    val_root = render.root
    gt_dir = os.path.join(val_root, "training", "label_2")
    assert len(os.listdir(gt_dir)) == VAL_FRAMES
    work = os.path.join(root, "trained_two_stage")
    os.makedirs(work)
    with open(os.path.join(JAX_RUN, "two_stage.json")) as f:
        jax_run = json.load(f)
    with open(os.path.join(WITNESS, "witness.json")) as f:
        witness = json.load(f)
    jax_props = os.path.join(work, "jax_proposals")
    shutil.copytree(os.path.join(JAX_RUN, "proposals", "data"),
                    os.path.join(jax_props, "data"))
    jax_props = os.path.join(jax_props, "data")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fields = dict(render_s=f"{render_s:.1f}")
    total = counts_of()

    def add(counts, want, what):
        assert counts == want, f"{what} launches {counts} != {want}"
        for k, v in counts.items():
            total[k] += v

    # bf16: stage 1 over the split, scored
    s1 = os.path.join(work, "stage1")
    n_props, secs, counts = timed(cli_detect.main, [
        "--model_dir", os.path.join(TRAINED, "stereo"), "--data_path",
        val_root, "--output_dir", s1, "--device", str(dev)] + STAGE1_ARGS)
    add(counts, counts_of(K3=VAL_FRAMES, K4=VAL_FRAMES), "stage 1")
    assert len(os.listdir(os.path.join(s1, "data"))) == VAL_FRAMES
    ap = cli_evaluate.main([gt_dir, s1, "--json"])
    fields.update(
        stage1_s=f"{secs:.1f}/one_view:{ONE_VIEW_STAGE_S['stage1']}",
        stage1_proposals=n_props,
        stage1_ap3d_mod=f"{moderate(ap)}/jax_tpu_bf16:"
        f"{jax_run['ap3d_proposals'][1]}",
        stage1_apbev_mod=f"{moderate(ap, 'detection_ground')}/jax_tpu_bf16:"
        f"{jax_run['apbev_proposals'][1]}")

    # bf16: stage 2 on JAX's proposals, then on the port's own
    vdir = model_dir_with(os.path.join(TRAINED, "vernier"),
                          os.path.join(work, "vernier_bf16"), **REFINE_FIELDS)
    for tag, props in (("jax_props", jax_props),
                       ("own_props", os.path.join(s1, "data"))):
        b = refine_batches(val_root, props, vdir)
        out = os.path.join(work, f"refined_{tag}")
        res, secs, counts = timed(cli_refine.main, [
            "--model_dir", vdir, "--data_path", val_root, "--pred_dir",
            props, "--output_dir", out, "--pred_type", *PRED_TYPES,
            "--evaluate", "--device", str(dev)])
        add(counts, counts_of(K1=b, K2=3 * b), f"stage 2 {tag}")
        fields[f"stage2_{tag}_s"] = (
            f"{secs:.1f}/one_view:{ONE_VIEW_STAGE_S[f'stage2_{tag}']}")
        fields[f"stage2_{tag}_batches"] = b
        for pt in PRED_TYPES:
            fields[f"{tag}_{pt}_ap3d_mod"] = (
                f"{moderate(res[pt])}/jax_tpu_bf16:"
                f"{jax_run[f'ap3d_refined_{pt}'][1]}")
    refined_jax_props = os.path.join(work, "refined_jax_props")

    # float32: stage 2 on JAX's proposals against witness (a)
    failed = []
    vdir32 = model_dir_with(os.path.join(TRAINED, "vernier"),
                            os.path.join(work, "vernier_f32"),
                            compute_dtype="float32", **REFINE_FIELDS)
    b = refine_batches(val_root, jax_props, vdir32)
    out32 = os.path.join(work, "refined_f32")
    res, secs, counts = timed(cli_refine.main, [
        "--model_dir", vdir32, "--data_path", val_root, "--pred_dir",
        jax_props, "--output_dir", out32, "--pred_type", *PRED_TYPES,
        "--evaluate", "--device", str(dev)])
    add(counts, counts_of(K1=b), "stage 2 float32")
    fields["stage2_f32_s"] = (
        f"{secs:.1f}/one_view:{ONE_VIEW_STAGE_S['stage2_f32']}")
    for pt in PRED_TYPES:
        cmp = compare_ordered(os.path.join(out32, pt, "data"),
                              os.path.join(WITNESS, pt, "data"))
        want = witness["refine"][pt]["ap3d_jax"][1]
        got = moderate(res[pt])
        fields[f"f32_{pt}"] = (f"ap3d_mod:{got}/jax_cpu_f32:{want},"
                               f"boxes:{cmp['boxes']},over_1e-3:"
                               f"{cmp['over_tol']},max_diff:"
                               f"{cmp['max_diff']:.2e}")
        if not abs(got - want) <= 0.05:
            failed.append(f"f32 {pt} AP3D {got} vs witness {want}")

    # float32, cuDNN off: stage 1 on the first frames against witness (b)
    s1_32 = os.path.join(work, "stage1_f32")
    sdir32 = model_dir_with(os.path.join(TRAINED, "stereo"),
                            os.path.join(work, "stereo_f32"),
                            compute_dtype="float32")
    torch.backends.cudnn.enabled = False
    try:
        _, secs, counts = timed(cli_detect.main, [
            "--model_dir", sdir32, "--data_path", val_root, "--output_dir",
            s1_32, "--max_frames", str(WITNESS_FRAMES), "--device",
            str(dev)] + STAGE1_ARGS)
    finally:
        torch.backends.cudnn.enabled = True
    add(counts, counts_of(K3=WITNESS_FRAMES, K4=WITNESS_FRAMES),
        "stage 1 float32")
    frames = sorted(f[:-4] for f in os.listdir(
        os.path.join(WITNESS, "stage1", "data")))[:WITNESS_FRAMES]
    assert len(frames) == WITNESS_FRAMES, frames
    cmp = compare_matched(os.path.join(s1_32, "data"),
                          os.path.join(WITNESS, "stage1", "data"), frames,
                          STAGE1_THRESHOLD)
    fields.update(stage1_f32_s=f"{secs:.1f}",
                  stage1_f32=f"matched:{cmp['matched']},over_1e-3:"
                  f"{cmp['over_tol']},max_diff:{cmp['max_diff']:.2e},"
                  f"max_score_diff:{cmp['max_score_diff']:.2e}",
                  stage1_f32_one_sided=repr(cmp["one_sided"]))
    if cmp["over_tol"]:
        failed.append(f"f32 stage 1: {cmp['over_tol']} boxes over 1e-3")
    failed += [f"f32 stage 1: one-sided box {box}"
               for box in cmp["one_sided"] if not box[3]]

    # diagnose_refinement over the run's work dir (the port's proposals)
    diag = os.path.join(work, "diag")
    model_dir_with(os.path.join(TRAINED, "vernier"),
                   os.path.join(diag, "vernier_ckpt"))
    os.symlink(val_root, os.path.join(diag, "kitti_val"))
    shutil.copytree(os.path.join(s1, "data"),
                    os.path.join(diag, "proposals", "data"))
    b = refine_batches(val_root, os.path.join(s1, "data"), vdir)
    report, secs, counts = timed(diagnose_refinement.main,
                                 ["--work_dir", diag, "--device", str(dev)])
    add(counts, counts_of(K1=3 * b, K2=9 * b), "diagnose_refinement")
    fields["diagnose_s"] = f"{secs:.1f}"
    for key, row in report.items():
        if key == "step":
            continue
        assert set(row) == {"center_med_m", "yaw_med_deg", "update_med_m",
                            "n", "ap3d", "apbev", "ap3d_iou50"}, (key, row)
        fields[f"diag_{key}"] = (
            f"c{row['center_med_m']:.3f}/y{row['yaw_med_deg']:.2f}/"
            f"u{row['update_med_m']:.3f}/n{row['n']}/"
            f"ap3d{row['ap3d'][1]}/bev{row['apbev'][1]}")

    # the visualisations
    tv = time.perf_counter()
    fields.update(check_viz(val_root, os.path.join(refined_jax_props,
                                                   "all_parts", "data"),
                            work))
    fields["viz_s"] = f"{time.perf_counter() - tv:.1f}"
    res, secs, counts = timed(cli_refine.main, [
        "--model_dir", vdir, "--data_path", val_root, "--pred_dir",
        jax_props, "--output_dir", os.path.join(work, "debug_run"),
        "--pred_type", *PRED_TYPES, "--debug", "--device", str(dev)])
    add(counts, counts_of(K1=1, K2=3), "--debug")
    check_debug_panels(res["debug"], vdir, val_root, jax_props, dev)
    fields["debug_s"] = f"{secs:.1f}"
    phase("trained_two_stage", t, **fields, nvidia_smi=repr(nvidia_smi()),
          note=repr("*_ap3d_mod: AP40 moderate, the port / JAX's witness; "
                    "render_s: the val split drawn by a child process "
                    "during the earlier phases; *_s: CLI wall seconds, "
                    "model load and first call included; one_view: the "
                    "same stage when png.py decoded each view alone"),
          launches=json.dumps(total).replace(" ", ""))
    assert not failed, f"trained_two_stage: {failed}"
    return dict(counts=total)


# ------------------------------------------------------ native_loader ----
LOADER_BATCH = 8  # views a decode_batch_padded call of the phase
# kind -> (colour type, bit depth, tRNS chunk, Adam7): every colour type
# at every bit depth the PNG specification allows it, PLTE and tRNS, and
# Adam7, beside the 8-bit RGB(A) the renderer writes
PNG_KINDS = {
    **{f"grey{d}": (0, d, False, False) for d in (1, 2, 4, 8, 16)},
    "rgb16": (2, 16, False, False),
    **{f"palette{d}": (3, d, False, False) for d in (1, 2, 4, 8)},
    "grey_alpha8": (4, 8, False, False),
    "grey_alpha16": (4, 16, False, False),
    "rgba16": (6, 16, False, False),
    "grey8_trns": (0, 8, True, False),
    "grey16_trns": (0, 16, True, False),
    "rgb8_trns": (2, 8, True, False),
    "palette2_trns": (3, 2, True, False),
    "palette8_trns": (3, 8, True, False),
    "rgb8_adam7": (2, 8, False, True),
    "grey1_adam7": (0, 1, False, True),
    "palette4_trns_adam7": (3, 4, True, True),
    "grey_alpha16_adam7": (4, 16, False, True),
    "rgba8_adam7": (6, 8, False, True),
}
# (h, w) of the files of each kind: the Adam7 passes of a 3 x 2 image
# are partly empty, 37 x 53 fills every pass with ragged rows
PNG_KIND_SIZES = ((3, 2), (37, 53))
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def write_png_kind(path: str, kind: str, hw, rng) -> np.ndarray:
    """Writes a PNG of ``kind`` (PNG_KINDS) with ``rng``'s samples, rows
    filtered with ``rng``'s filter types and the image data in two IDAT
    chunks, and returns the 8-bit RGB [h, w, 3] that cv2.imread(
    IMREAD_COLOR) + BGR->RGB gives for it: grey replicated, 16-bit
    samples' high bytes, grey below 8 bits scaled to 0-255, palette
    entries looked up, alpha and tRNS dropped."""
    from snvc_tpu_torch.data.png import (
        PNG_SIGNATURE,
        _chunk,
        _filter_rows,
    )

    color, depth, trns, adam7 = PNG_KINDS[kind]
    h, w = hw
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = 1 << depth
    extra = b""
    if color == 3:
        n = int(rng.integers(1, min(256, top) + 1))
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        samples = rng.integers(0, n, (h, w, 1))
        rgb = palette[samples[..., 0]]
        extra = _chunk(b"PLTE", palette.tobytes())
        if trns:
            extra += _chunk(b"tRNS", rng.integers(
                0, 256, int(rng.integers(1, n + 1)), dtype=np.uint8)
                .tobytes())
    else:
        samples = rng.integers(0, top, (h, w, ch))
        eight = (samples >> 8 if depth == 16 else
                 samples * (255 // (top - 1)) if depth < 8 else samples)
        rgb = (np.repeat(eight[..., :1], 3, -1) if color in (0, 4)
               else eight[..., :3]).astype(np.uint8)
        if trns:  # a key colour of the image's own
            extra = _chunk(b"tRNS", samples[0, 0, :(1 if color == 0 else 3)]
                           .astype(">u2").tobytes())
    bpp = max(1, ch * depth // 8)

    def scanlines(sub):
        ph, pw = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(ph, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(ph, -1)
        else:
            bits = (sub.reshape(ph, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(ph, -1).astype(np.uint8), axis=1)
        filters = [int(f) for f in rng.integers(0, 5, ph)]
        return _filter_rows(rows.reshape(ph, -1, bpp), filters)

    passes = _ADAM7 if adam7 else ((0, 0, 1, 1),)
    raw = b"".join(scanlines(samples[y0::dy, x0::dx])
                   for x0, y0, dx, dy in passes
                   if samples[y0::dy, x0::dx].size)
    idat = zlib.compress(raw, 6)
    cut = len(idat) // 2
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(adam7))
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + extra
                 + _chunk(b"IDAT", idat[:cut]) + _chunk(b"IDAT", idat[cut:])
                 + _chunk(b"IEND", b""))
    return rgb
# the wall seconds of phase trained_two_stage's stages when data/png.py
# decoded each view alone (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W),
# printed beside this run's
ONE_VIEW_STAGE_S = dict(stage1=12.5, stage2_jax_props=9.5,
                    stage2_own_props=9.1, stage2_f32=7.5)


def check_native_loader(render: ValRender) -> None:
    """Phase ``native_loader``: the 256 PNGs of phase trained_two_stage's
    val split (both views of 128 frames) decoded three ways into the
    trained Vernier config's canvas, which must give the same bytes:
    ``png.decode_png`` + ``kitti._place`` (the plain reader), one view at
    a time with ``native_loader.decode_png_padded``, and in batches of 8
    with ``decode_batch_padded`` (its default 4 threads); ms a view of
    each on the card's host, beside nproc.  One ``load_velodyne`` equals
    ``np.fromfile``; a missing path raises.  Every other kind of PNG
    (``check_png_kinds``: each colour type and bit depth, PLTE, tRNS,
    Adam7) decodes to its known RGB in the three readers."""
    from snvc_tpu_torch.data.kitti import _place

    t = time.perf_counter()
    render.wait()
    cfg = load_config(os.path.join(TRAINED, "vernier", "config.json"),
                      VernierConfig)
    hw = tuple(cfg.image_size)
    train = os.path.join(render.root, "training")
    paths = [os.path.join(train, d, n) for d in ("image_2", "image_3")
             for n in sorted(os.listdir(os.path.join(train, d)))]
    assert len(paths) == 2 * VAL_FRAMES, len(paths)
    t_build = time.perf_counter()
    native_loader.available()
    build_s = time.perf_counter() - t_build

    def ms_a_view(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3 / len(paths)

    plain, plain_ms = ms_a_view(lambda: np.stack(
        [_place(decode_png(p), hw) for p in paths]))
    single, single_ms = ms_a_view(lambda: np.stack(
        [native_loader.decode_png_padded(p, hw) for p in paths]))
    batch, batch_ms = ms_a_view(lambda: np.concatenate(
        [native_loader.decode_batch_padded(paths[i:i + LOADER_BATCH], hw)
         for i in range(0, len(paths), LOADER_BATCH)]))
    assert np.array_equal(single, plain), "decode_png_padded != decode_png"
    assert np.array_equal(batch, plain), "decode_batch_padded != decode_png"
    velo = os.path.join(train, "velodyne", "000000.bin")
    assert np.array_equal(native_loader.load_velodyne(velo),
                          np.fromfile(velo, np.float32).reshape(-1, 4))
    missing = os.path.join(train, "image_2", "missing.png")
    for fn in (lambda: native_loader.decode_png_padded(missing, hw),
               lambda: native_loader.decode_batch_padded([paths[0], missing],
                                                         hw)):
        try:
            fn()
        except FileNotFoundError:
            continue
        raise AssertionError("a missing PNG did not raise")
    kinds = check_png_kinds(os.path.join(render.root, "png_kinds"))
    phase("native_loader", t, views=len(paths), canvas=f"{hw[0]}x{hw[1]}",
          png_kinds=len(PNG_KINDS), png_kind_files=kinds,
          png_py_ms_per_view=f"{plain_ms:.2f}",
          single_ms_per_view=f"{single_ms:.2f}",
          batch8_ms_per_view=f"{batch_ms:.2f}", nproc=os.cpu_count(),
          build_s=f"{build_s:.2f}", nvidia_smi=repr(nvidia_smi()),
          note=repr("host wall ms a view, file reads warm (the render "
                    "wrote them); the three decodes give the same bytes"))


def check_png_kinds(root: str) -> int:
    """Every kind of PNG_KINDS at each of PNG_KIND_SIZES, written from
    seeded samples whose RGB is known (``write_png_kind``), decoded by
    ``png.decode_png``, ``decode_png_padded`` (at its size and into a
    larger canvas) and one ``decode_batch_padded`` of all of them: each
    the known RGB bit for bit.  Returns the files' count."""
    from snvc_tpu_torch.data.kitti import _place

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    files = []
    for kind in PNG_KINDS:
        for hw in PNG_KIND_SIZES:
            path = os.path.join(root, f"{kind}_{hw[0]}x{hw[1]}.png")
            files.append((path, write_png_kind(path, kind, hw, rng)))
    canvas = (40, 60)
    batch = native_loader.decode_batch_padded([p for p, _ in files], canvas)
    for (path, rgb), got in zip(files, batch):
        assert np.array_equal(decode_png(path), rgb), f"decode_png {path}"
        assert np.array_equal(native_loader.decode_png_padded(
            path, rgb.shape[:2]), rgb), f"decode_png_padded {path}"
        assert np.array_equal(got, _place(rgb, canvas)), f"batch {path}"
    return len(files)


# ------------------------------------------------------------ profile ----
# a profiler's run in a child process, then the launches of the path's
# kernels in that process (each wrapper's counter starts at 0 there)
PROFILE_CHILD = (
    "import json, sys\n"
    "from snvc_tpu_torch.tools import {tool} as tool\n"
    "from snvc_tpu_torch.ops.stereo_sample_cuda import stereo_voxel_sample\n"
    "from snvc_tpu_torch.ops.conv3d_fold import conv3d_large_tap\n"
    "from snvc_tpu_torch.ops.cost_volume import plane_sweep_volume_k3\n"
    "from snvc_tpu_torch.ops.frustum import frustum_to_voxel_k4\n"
    "tool.main(sys.argv[1:])\n"
    "print(json.dumps({{'launches': dict(\n"
    "    K1=stereo_voxel_sample.launches, K2=conv3d_large_tap.launches,\n"
    "    K3=plane_sweep_volume_k3.launches,\n"
    "    K4=frustum_to_voxel_k4.launches)}}))\n")


def run_profiler(tool: str, args, want) -> dict:
    """``tools/<tool>.py args`` in a child process: its stage lines and
    JSON printed here; its kernel launches (printed after its run) must
    include every kernel of ``want``.  Returns the tool's JSON."""
    res = subprocess.run(
        [sys.executable, "-c", PROFILE_CHILD.format(tool=tool), *args],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"{tool} failed:\n{res.stderr[-4000:]}"
    lines = res.stdout.strip().splitlines()
    for ln in lines[:-1]:
        print(f"  {tool}: {ln}")
    report = json.loads(lines[-2])
    launches = json.loads(lines[-1])["launches"]
    moved = {k: v for k, v in launches.items() if v}
    assert all(launches[k] > 0 for k in want), f"{tool} launches {launches}"
    print(f"  {tool}: launches {json.dumps(moved)}")
    return report


def check_profile(dev, root: str) -> dict:
    """Phase ``profile``: the two profilers in child processes at full
    width (profile_vernier --config flagship --batch 4: K1 and K2 move;
    profile_stereo at StereoConfig() bf16: K3 and K4 move), then one
    flagship refinement request (seeded weights, after a warm-up) under
    ``utils.profiling.trace``: its trace file must name the K1 and K2
    CUDA kernels; ``device_memory_stats()`` after it, with its peak.
    Returns the request's launches."""
    from snvc_tpu_torch.utils import profiling

    t = time.perf_counter()
    vern = run_profiler("profile_vernier", ["--config", "flagship",
                                            "--batch", "4"], ("K1", "K2"))
    ster = run_profiler("profile_stereo", [], ("K3", "K4"))
    cfg = flagship_vernier_config()
    model = VernierScale(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    runner = RefineRunner(model, cfg, device=dev)
    batch = synthetic_batch_arrays(cfg, seed=5)
    runner.step(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    log_dir = os.path.join(root, "profile_trace")
    with profiling.trace(log_dir):
        out = runner.step(batch)
    counts = read_counts()
    assert counts == counts_of(K1=1, K2=3), f"traced request {counts}"
    assert np.isfinite(out["all_parts"]).all()
    (name,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, name)) as fh:
        kernels = {e["name"] for e in json.load(fh)["traceEvents"]
                   if e.get("cat") == "kernel"}
    for want in ("stereo_voxel_sample", "conv3d_large_tap"):
        assert any(want in k for k in kernels), \
            f"trace names no {want} kernel: {sorted(kernels)[:20]}"
    mem = profiling.device_memory_stats()
    peak = mem[str(dev)]["allocated_bytes.all.peak"]
    del runner, model
    torch.cuda.empty_cache()
    phase("profile", t,
          vernier_sum_of_stages_ms=vern["sum_of_stages_ms"],
          vernier_encoder_full_ms=vern["encoder_full"],
          stereo_full_model_ms=ster["full_model_ms"],
          stereo_accounted_ms=ster["accounted_ms"],
          trace_kernels=len(kernels), trace_file=repr(name),
          peak_allocated_mib=f"{peak:.1f}",
          memory_keys=len(mem[str(dev)]), nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(counts).replace(" ", ""))
    return dict(counts=counts)


# ---------------------------------------------------------- parallel ----
# Two gloo ranks share the one card (NCCL refuses two ranks on one GPU):
# no scaling figure, the two processes share the card's SMs.
DP_RANKS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rank_main(fn, rank, n, port, out_dir, args, n_model=1):
    """A rank as a launcher starts one: RANK / WORLD_SIZE / MASTER_* in
    its environment, the group joined by ``initialize_multihost`` (gloo
    on cuda:0, ``n_model`` ranks a data position); ``fn(mesh, *args)``'s
    result saved for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    mesh = initialize_multihost("gloo", "cuda:0", n_model=n_model)
    assert mesh.rank == rank and mesh.n_data * n_model == n, mesh
    torch.save(fn(mesh, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()


def run_dp_ranks(fn, *args, timeout: float = 300.0, n_model: int = 1
                 ) -> list:
    """``fn(mesh, *args)`` on DP_RANKS spawned ranks (``n_model`` of them
    a data position); their results in rank order.  A rank that fails,
    or ranks past ``timeout``, fail the phase, and every rank still
    running is stopped."""
    import multiprocessing
    import multiprocessing.connection

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        port = free_port()
        procs = [ctx.Process(target=dp_rank_main,
                             args=(fn, r, DP_RANKS, port, d, args, n_model))
                 for r in range(DP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            running = list(procs)
            while running and time.monotonic() < deadline:
                multiprocessing.connection.wait(
                    [p.sentinel for p in running],
                    max(deadline - time.monotonic(), 0.0))
                running = [p for p in procs if p.exitcode is None]
                if any(p.exitcode for p in procs):
                    break
            codes = [p.exitcode for p in procs]
            assert codes == [0] * DP_RANKS, f"rank exit codes {codes}"
            return [torch.load(os.path.join(d, f"rank{r}.pt"),
                               weights_only=False) for r in range(DP_RANKS)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def dp_steps(kind: str, dev, mesh=None, float32: bool = False,
             steps: int = 2, cfg=None, frames: int = 2,
             weights=None) -> dict:
    """``steps`` steps of the flagship training config on its global
    batch: the Vernier model (VernierConfig(), 8 instances) or
    StereoConfig() (``frames`` pairs, 4 cars each), seeded weights
    (``weights``: a state dict loaded over them), TrainConfig with
    warmup_steps=2; ``cfg`` replaces the config; parallel over ``mesh``;
    with ``float32``, the config in float32 with TF32 off.  Step 0's
    metrics (rate 0: the same parameters on every side), each step's ms,
    peak memory, counters."""
    # the card's defaults, or float32 work that is float32
    torch.backends.cudnn.allow_tf32 = not float32
    torch.backends.cuda.matmul.allow_tf32 = False
    tc = TrainConfig(warmup_steps=2)
    gen = torch.Generator().manual_seed(0)
    if kind == "vernier":
        cfg = cfg or VernierConfig()
        if float32:
            cfg = cfg.replace(compute_dtype="float32")
        model = VernierScale(cfg, device=dev, generator=gen)
        if weights is not None:
            model.load_state_dict(weights, strict=True)
        state = create_train_state(model, cfg, tc)
        step = make_train_step(cfg, tc, dev, mesh=mesh)
        batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)
    else:
        cfg = cfg or StereoConfig()
        if float32:
            cfg = cfg.replace(compute_dtype="float32")
        state = create_stereo_state(StereoNet(cfg, device=dev,
                                              generator=gen), tc)
        step = make_stereo_train_step(cfg, tc, dev, mesh=mesh)
        batch = stereo_batch_to_device(synthetic_stereo_request(
            cfg, seed=0, frames=frames, boxes_per_frame=4), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for _ in range(steps):
        t = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    res = dict(metrics=metrics[0], step_ms=times, counts=read_counts(),
               peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del state, step, batch
    torch.cuda.empty_cache()
    return res


DP_KINDS = ("vernier", "stereo")


def dp_rank_steps(mesh) -> dict:
    """Each path on this rank in bf16 (2 steps: the path as it trains,
    timed) and in float32 (step 0)."""
    dev = mesh.devices[mesh.rank]
    return {kind: dict(bf16=dp_steps(kind, dev, mesh),
                       f32=dp_steps(kind, dev, mesh, float32=True, steps=1))
            for kind in DP_KINDS}


def check_dp_training(dev, train: dict, f32: dict) -> dict:
    """Each training path on DP_RANKS gloo ranks sharing the card against
    the one-process step on the same global batch.  In float32 (TF32
    off) step 0's losses within 1e-4 and its grad_norm within 3e-3 of the
    one-process step's, phase train_reference's rule (losses 1e-4,
    gradients 3e-3): the split changes only the order of the sums and
    cuDNN's algorithms.  In bf16, the path as it trains, the card's
    convolutions at 4 instances a rank give other bits than at 8 (the
    flagship's eval forward: NCF 13 % of scale apart in bf16, 1.2 % in
    float32, measured on one H100), so the bf16 metrics' distance from the
    one-process float32 step is printed and the gates there are finite
    metrics, the ranks agreeing and per rank and step K1 1 + 1, K2 3 + 3
    dx, dw 3 / K3 1 + 1, K4 1 + 1.  The bf16 step's ms (the second, warm
    step) and peak memory a rank beside the one-process step's: phase
    ``train``'s (``train``, at the same global batch of 8) and a 2-pair
    stereo step's.  ``f32``: the one-process float32 steps
    (``dp_steps(kind, dev, float32=True, steps=1)``)."""
    one = dict(vernier=dict(f32=f32["vernier"],
                            bf16=dict(step_ms=[0.0, float(np.median(
                                train["step_ms"]))],
                                      peak_gb=train["peak_gb"])),
               stereo=dict(f32=f32["stereo"], bf16=dp_steps("stereo", dev)))
    ranks = run_dp_ranks(dp_rank_steps)
    want = dict(vernier=counts_of(K1=2, K1_bwd=2, K2=6, K2_dx=6, K2_dw=6),
                stereo=counts_of(K3=2, K3_bwd=2, K4=2, K4_bwd=2))
    total = counts_of()
    fields, failed = {}, []
    for kind in DP_KINDS:
        for r, res in enumerate(ranks):
            got = res[kind]["bf16"]
            assert got["counts"] == want[kind], \
                f"{kind} rank {r} launch counts {got['counts']}"
            for dt in ("bf16", "f32"):
                assert res[kind][dt]["metrics"] == \
                    ranks[0][kind][dt]["metrics"], f"{kind} {dt}: ranks"
            for k, v in got["counts"].items():
                total[k] += v
        ref = one[kind]["f32"]["metrics"]
        for dt in ("bf16", "f32"):
            got = ranks[0][kind][dt]["metrics"]
            assert all(math.isfinite(v) for v in got.values()), got
            errs = {k: abs(got[k] - v) / max(abs(v), 1e-12)
                    for k, v in ref.items()}
            fields[f"{kind}_{dt}_vs_one_f32"] = \
                f"{max(errs.values()):.2e}({max(errs, key=errs.get)})"
            fields[f"{kind}_{dt}_grad_norm"] = f"{got['grad_norm']:.5g}"
            if dt == "f32":
                failed += [f"{kind} {k} {e:.2e}" for k, e in errs.items()
                           if e > (3e-3 if k == "grad_norm" else 1e-4)]
        fields[f"{kind}_one_f32_grad_norm"] = f"{ref['grad_norm']:.5g}"
        ranks_b = [res[kind]["bf16"] for res in ranks]
        one_b = one[kind]["bf16"]
        fields[f"{kind}_step_ms"] = ",".join(
            f"{res['step_ms'][1]:.1f}" for res in ranks_b)
        fields[f"{kind}_step_ms_one"] = f"{one_b['step_ms'][1]:.1f}"
        fields[f"{kind}_peak_gb"] = ",".join(
            f"{res['peak_gb']:.2f}" for res in ranks_b)
        fields[f"{kind}_peak_gb_one"] = f"{one_b['peak_gb']:.2f}"
    assert not failed, f"float32 ranks vs one process: {failed} " \
        + json.dumps(fields)
    return dict(counts=total, fields=fields)


def check_dp_cli(root: str, meanwhile) -> tuple:
    """train_vernier through torchrun in a one-rank NCCL group on the card
    (2 steps of a small config, hrnet-tiny, so that the phase's seconds go
    to the group, not to the flagship's steps) on a seeded 1-frame tree,
    while this process runs ``meanwhile()`` (untimed work: the CLI's wall
    is mostly its processes' start).  Returns (fields, its result)."""
    d = os.path.join(root, "runs", "vernier_nccl")
    cfg_path = os.path.join(root, "vernier_small.json")
    save_config(tiny_vernier_config(max_instances=4, image_size=(384, 1248),
                                    usage="train", sup_type="synthetic"),
                cfg_path)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out_path = os.path.join(root, "torchrun.out")
    t = time.perf_counter()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
             "--master_port", str(free_port()), "-m",
             "snvc_tpu_torch.tools.train_vernier", "--model_dir", d,
             "--data_path", root, "--split", "val", "--config", cfg_path,
             "--steps", "2", "--log_every", "1"],
            cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT)
        try:
            result = meanwhile()
            code = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t
    with open(out_path) as fh:
        assert code == 0, fh.read()[-6000:]
    with open(os.path.join(d, "training.log")) as fh:
        log = fh.read()
    assert "data parallel over 1 ranks (nccl)" in log, log
    with open(os.path.join(d, "metrics.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    assert [m["step"] for m in lines] == [1, 2], lines
    assert all(math.isfinite(v) for m in lines for v in m.values()), lines
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "2.pt", "config.json"]
    return dict(nccl_cli_wall_s=f"{wall:.1f}",
                nccl_cli_total=f"{lines[-1]['total']:.4f}"), result


def mesh_serving_err(kind: str, dev) -> dict:
    """Phase reference's small models on a mesh [dev, dev] in bf16: each
    runner against the same weights on the CPU in float32 under
    reference's rule (within 3x the CPU's own bf16 drift + 1 % of scale),
    and the largest difference from the one-device runner on the card.
    Of the detector's proposals the sorted top scores are gated; its boxes
    follow the ranking, which a rounding can reorder, so their difference
    from the one-device runner is printed alone."""
    mesh = make_mesh(2, [dev, dev])
    if kind == "refine":
        small = tiny_vernier_config(grid_resolution=(8, 32, 32),
                                    image_size=(128, 256), max_instances=2)
        batch = synthetic_batch_arrays(small, seed=7)
        keys = ("ncf", "occupancy", "coordinates")

        def run(cfg, device, m=None):
            model = VernierScale(cfg, device=device,
                                 generator=torch.Generator().manual_seed(1))
            out = RefineRunner(model, cfg, device=device, mesh=m).step(
                batch, host_outputs=keys)
            return {k: out[k] for k in keys}
    else:
        small = tiny_stereo_config(z_max=38.0, max_depth=40.0)
        req = synthetic_stereo_request(small, seed=3, frames=2)
        keys = ("scores",)

        def run(cfg, device, m=None):
            model = StereoNet(cfg, device=device,
                              generator=torch.Generator().manual_seed(1))
            out = DetectRunner(model, cfg, score_threshold=0.0,
                               device=device, mesh=m).forward(req)
            return dict(boxes=out[0].float().cpu().numpy(),
                        scores=out[1].float().cpu().numpy())
    bf16 = small.replace(compute_dtype="bfloat16")
    ref, cpu_bf16 = run(small, "cpu"), run(bf16, "cpu")
    card = run(bf16, dev)
    reset_counts()
    got = run(bf16, dev, mesh)
    counts = read_counts()
    want = (counts_of(K1=2, K2=6) if kind == "refine"
            else counts_of(K3=2, K4=2))
    assert counts == want, f"{kind} mesh launch counts {counts}"
    fields = {}
    for k in got:
        scale = max(float(np.abs(ref[k]).max()), 1e-6)
        fields[f"{kind}_{k}_vs_one_device"] = \
            f"{float(np.abs(got[k] - card[k]).max()) / scale:.2e}"
        assert np.isfinite(got[k]).all(), f"{kind} mesh {k} not finite"
        if k not in keys:
            continue
        err = float(np.abs(got[k] - ref[k]).max()) / scale
        drift = float(np.abs(cpu_bf16[k] - ref[k]).max()) / scale
        assert err <= 3.0 * drift + 0.01, \
            f"{kind} mesh {k}: rel err {err:.4f}, cpu bf16 {drift:.4f}"
        fields[f"{kind}_{k}_rel_err"] = f"{err:.4f}"
        fields[f"{kind}_{k}_cpu_bf16_rel_err"] = f"{drift:.4f}"
    return fields


def check_mesh_serving(dev) -> dict:
    """The flagship RefineRunner and the full-width DetectRunner on a mesh
    [dev, dev] (two replicas on the card, a request split in two): one
    warm-up and two requests each against the one-device runner on the
    same requests (largest difference of the outputs printed; finite,
    shapes), the counters (two K1 and six K2 / two K3 and two K4 a
    request), request ms beside the one-device runner's."""
    mesh = make_mesh(2, [dev, dev])
    fields, total = {}, counts_of()
    cfg = flagship_vernier_config()
    batches = [synthetic_batch_arrays(cfg, seed=s) for s in (1, 2)]
    keys = ("one_part", "all_parts", "confidence")
    outs = {}
    for label, m in (("one", None), ("mesh", mesh)):
        model = VernierScale(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
        runner = RefineRunner(model, cfg, device=dev, mesh=m)
        runner.step(synthetic_batch_arrays(cfg, seed=100))  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        times, outs[label] = [], []
        for b in batches:
            t = time.perf_counter()
            out = runner.step(b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            outs[label].append(out)
        counts = read_counts()
        fields[f"refine_{label}_ms"] = ",".join(f"{v:.1f}" for v in times)
        del runner, model
        torch.cuda.empty_cache()
    assert counts == counts_of(K1=4, K2=12), f"refine mesh counts {counts}"
    for k, v in counts.items():
        total[k] += v
    for k in keys:
        a = np.stack([o[k] for o in outs["mesh"]])
        b = np.stack([o[k] for o in outs["one"]])
        assert a.shape == b.shape and np.isfinite(a).all(), k
        fields[f"refine_{k}_max_diff"] = f"{float(np.abs(a - b).max()):.2e}"

    scfg = StereoConfig()
    reqs = [synthetic_stereo_request(scfg, seed=s, frames=2)
            for s in (1, 2)]
    for label, m in (("one", None), ("mesh", mesh)):
        model = StereoNet(scfg, device=dev,
                          generator=torch.Generator().manual_seed(0))
        runner = DetectRunner(model, scfg, device=dev, mesh=m)
        runner.forward(synthetic_stereo_request(scfg, seed=100, frames=2))
        torch.cuda.synchronize()
        reset_counts()
        times, outs[label] = [], []
        for r in reqs:
            t = time.perf_counter()
            out = runner.forward(r)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            outs[label].append([o.float().cpu().numpy() for o in out])
        counts = read_counts()
        fields[f"detect_{label}_ms"] = ",".join(f"{v:.1f}" for v in times)
        del runner, model
        torch.cuda.empty_cache()
    assert counts == counts_of(K3=4, K4=4), f"detect mesh counts {counts}"
    for k, v in counts.items():
        total[k] += v
    valid = np.stack([o[3] for o in outs["mesh"]]) > 0
    both = valid & (np.stack([o[3] for o in outs["one"]]) > 0)
    for j, name in enumerate(("boxes", "scores")):
        a = np.stack([o[j] for o in outs["mesh"]])
        b = np.stack([o[j] for o in outs["one"]])
        assert a.shape == b.shape and a.shape[1] == 2, name
        assert np.isfinite(a[valid]).all(), name
        fields[f"detect_{name}_max_diff"] = \
            f"{float(np.abs(a[both] - b[both]).max(initial=0.0)):.2e}"
    t = time.perf_counter()
    for kind in ("refine", "detect"):
        fields.update(mesh_serving_err(kind, dev))
    fields["reference_s"] = f"{time.perf_counter() - t:.1f}"
    return dict(counts=total, fields=fields)


def check_parallel(dev, train: dict) -> dict:
    """Phase 25: data parallelism (parallel/api.py); ``train``: phase
    train's result, the one-process Vernier step's ms and peak memory."""
    t = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        write_kitti_tree(root, frames=1)
        cli, f32 = check_dp_cli(root, lambda: {
            kind: dp_steps(kind, dev, float32=True, steps=1)
            for kind in DP_KINDS})
    t_train = time.perf_counter()
    train = check_dp_training(dev, train, f32)
    t_serve = time.perf_counter()
    serve_ = check_mesh_serving(dev)
    secs = dict(cli_s=f"{t_train - t:.1f}",
                train_s=f"{t_serve - t_train:.1f}",
                serve_s=f"{time.perf_counter() - t_serve:.1f}")
    counts = {k: train["counts"][k] + serve_["counts"][k] for k in KERNELS}
    phase("parallel", t, ranks=DP_RANKS, backend="gloo",
          note="two ranks share one card: no scaling figure", **secs,
          **train["fields"], **serve_["fields"], **cli,
          nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(counts).replace(" ", ""))
    return dict(counts=counts)


# --------------------------------------------------- tensor_parallel ----
# The mesh's "model" axis (parallel/tensor.py): DP_RANKS gloo ranks share
# the card at n_data = 1, n_model = 2, so their times are no scaling
# figure.  The Vernier path trains the flagship grid at the default
# training batch (TrainConfig().batch_size).
TP_VERNIER = flagship_vernier_config(max_instances=TrainConfig().batch_size)
TP_NOTE = "two ranks share one card: no scaling figure"


def tp_slab_kernels(gen, dev) -> dict:
    """Each kernel of the split paths against its plain version at the
    shape the split gives it: K1 and its backward on the nl slab of a
    flagship request (4 instances, grid 32 x 192 x 96, the batch's own
    projections), K2 / dx / dw on the three prelude convs' widened slabs
    (96 + 6, 4, 8 lengths: tilings depend on the width, not the batch),
    K3 and its backward on each D slab of StereoConfig() (32 of 64
    planes) and K4 and its backward on the gathered volume.  Times at
    those shapes (K2's beside phase K2's at the full width)."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out, fields = {}, {}
    cfg = flagship_vernier_config()
    (nh, nw, nl), roi = cfg.grid_resolution, cfg.resolution
    half = (nh, nw, nl // DP_RANKS)
    N = cfg.max_instances
    gl, gr = (g.reshape(N, nh, nw, nl, 2)[:, :, :, :half[2]]
              .reshape(N, -1, 2).contiguous()
              for g in batch_projections(cfg, 0, dev))
    lf, rf, _, _ = k1_case(gen, N, 64, 64, 32, (1, 1, 1), roi,
                           torch.bfloat16, dev)
    err = assert_k1("tp K1 slab", lf, rf, gl, gr, roi, half)
    out["K1"] = dict(max_abs_err=err, **k1_times(lf, rf, gl, gr, roi, half))
    g = torch.randn((N,) + half + (64,), generator=gen).to(dev,
                                                          torch.bfloat16)
    err = assert_k1_bwd("tp K1_bwd slab", lf, rf, gl, gr, g, roi)
    out["K1_bwd"] = dict(max_abs_err=err,
                         **k1_bwd_times(lf, rf, gl, gr, g, roi))
    del lf, rf, gl, gr, g
    slab = (N, nh, nw)
    k2 = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  max_abs_err=0.0) for k in ("K2", "K2_dx", "K2_dw")}
    for name, C, kernel, dil in (("conv1_k7", 64, (7, 7, 7), 1),
                                 ("conv2_k5", 32, (5, 5, 5), 1),
                                 ("conv3_k5_d2", 32, (5, 5, 5), 2)):
        W = nl // DP_RANKS + (kernel[2] - 1) * dil  # slab + both halos
        shape = slab + (W, C)
        err, times = run_k2_case(gen, dev, f"tp {name} W={W}", shape,
                                 kernel, 32, dil, True)
        times["max_abs_err"] = err
        bwd = run_k2_bwd_case(gen, dev, f"tp {name} W={W}", shape, kernel,
                              32, dil, True)
        for key, d in (("K2", times), ("K2_dx", bwd["dx"]),
                       ("K2_dw", bwd["dw"])):
            for k, v in d.items():
                k2[key][k] = (max(k2[key][k], v) if k == "max_abs_err"
                              else k2[key][k] + v)
    out.update(k2)
    scfg = StereoConfig()
    H, W = scfg.input_size[0] // 4, scfg.input_size[1] // 4
    C, D = 32, scfg.num_depths
    lf = torch.randn((1, H, W, C), generator=gen).to(dev, torch.bfloat16)
    rf = torch.randn((1, H, W, C), generator=gen).to(dev, torch.bfloat16)
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    depths = torch.from_numpy(depth_hypotheses(scfg)).to(dev)
    shifts = plane_shifts(Pl, Pr, depths)
    slabs, errs, berrs = [], [], []
    d = D // DP_RANKS
    for m in range(DP_RANKS):  # rank m's planes
        s_m = shifts[:, m * d:(m + 1) * d].contiguous()
        v = plane_sweep_volume_k3(lf, rf, s_m)
        errs.append(assert_within_ulps(f"tp K3 slab {m}", v,
                                       plane_sweep_shifted(lf, rf, s_m)))
        slabs.append(v)
        gv = torch.randn(v.shape, generator=gen).to(dev, torch.bfloat16)
        for name, a, b in zip(("dleft", "dright"),
                              plane_sweep_volume_k3_bwd(gv, s_m, W),
                              plane_sweep_shifted_bwd(gv, s_m, W)):
            berrs.append(assert_within_ulps(f"tp K3_bwd slab {m} {name}",
                                            a, b))
    s0 = shifts[:, :d].contiguous()  # the near planes: the largest shifts
    out["K3"] = dict(max_abs_err=max(errs), **k3_times(lf, rf, s0))
    gv = torch.randn(slabs[0].shape, generator=gen).to(dev, torch.bfloat16)
    out["K3_bwd"] = dict(max_abs_err=max(berrs), **k3_bwd_times(gv, s0, W))
    del gv
    # K4 on the gathered volume: the post-stack volume's two slabs in rank
    # order (32 channels)
    vol = torch.cat([v[..., :C] for v in slabs], dim=1).contiguous()
    del slabs
    tabs = k4_tables(depth_hypotheses(scfg), *_bev_axes(scfg), dev)
    got = frustum_to_voxel_k4(vol, Pl, *tabs, 4)
    err = assert_within_ulps("tp K4 gathered", got,
                             frustum_to_voxel_separable(vol, Pl, *tabs, 4))
    g4 = torch.randn(got.shape, generator=gen).to(dev, torch.bfloat16)
    berr = assert_within_ulps(
        "tp K4_bwd gathered",
        frustum_to_voxel_k4_bwd(g4, Pl, *tabs, (D, H, W), 4),
        frustum_to_voxel_separable_bwd(g4, Pl, *tabs, (D, H, W), 4))
    out["K4"] = dict(max_abs_err=err, ms=cuda_ms(
        lambda: frustum_to_voxel_k4(vol, Pl, *tabs, 4), 20))
    out["K4_bwd"] = dict(max_abs_err=berr, ms=cuda_ms(
        lambda: frustum_to_voxel_k4_bwd(g4, Pl, *tabs, (D, H, W), 4), 20))
    del vol, got, g4
    torch.cuda.empty_cache()
    for k, d in out.items():
        fields.update({f"{k}_{key}": (f"{v:.3e}" if key == "max_abs_err"
                                      else f"{v:.4f}")
                       for key, v in d.items()})
    phase("tensor_parallel kernels", t, **fields)
    return out


def tp_detect(dev, mesh=None, cfg=None, frames: int = 2) -> dict:
    """The full-width DetectRunner (``cfg``, StereoConfig() by default,
    seeded weights) on one warm-up and ``frames`` seeded frames in bf16
    (request ms, counters, peak memory), then one frame in float32 (TF32
    off); split over ``mesh``'s model axis with a mesh.  Outputs as
    numpy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    base = cfg or StereoConfig()
    res = {}
    for label, cfg in (("bf16", base),
                       ("f32", base.replace(compute_dtype="float32"))):
        torch.backends.cudnn.allow_tf32 = label == "bf16"
        model = StereoNet(cfg, device=dev,
                          generator=torch.Generator().manual_seed(0))
        runner = DetectRunner(model, cfg, device=dev, mesh=mesh)
        seeds = tuple(range(1, frames + 1)) if label == "bf16" else (1,)
        if label == "bf16":
            runner.forward(synthetic_stereo_request(cfg, seed=100))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, outs = [], []
        for s in seeds:
            t = time.perf_counter()
            o = runner.forward(synthetic_stereo_request(cfg, seed=s))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            outs.append([x.float().cpu().numpy() for x in o])
        res[label] = dict(
            outs=outs, ms=times, counts=read_counts(),
            peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        del runner, model
        torch.cuda.empty_cache()
    return res


def tp_k2_widths():
    """Records the width (axis 3) of every input the Vernier head's K2
    convs take while open: ``Conv3d`` calls ``conv3d_large_tap`` through
    models/layers.py's name for it."""
    from snvc_tpu_torch.models import layers

    widths = []
    fn = layers.conv3d_large_tap

    def recording(x, w, dil=1):
        widths.append(int(x.shape[3]))
        return fn(x, w, dil)

    layers.conv3d_large_tap = recording
    return widths, lambda: setattr(layers, "conv3d_large_tap", fn)


@contextlib.contextmanager
def counting_collectives():
    """Counts the calls to ``torch.distributed.all_gather`` and
    ``all_reduce`` (the collectives of parallel/api.py and
    parallel/tensor.py) and the bytes they are given while open."""
    dist = torch.distributed
    seen = {name: [0, 0] for name in ("all_gather", "all_reduce")}
    orig = {name: getattr(dist, name) for name in seen}

    def counting(name):
        def call(*args, **kw):
            t = args[1] if name == "all_gather" else args[0]
            seen[name][0] += 1
            seen[name][1] += t.numel() * t.element_size()
            return orig[name](*args, **kw)
        return call

    for name in seen:
        setattr(dist, name, counting(name))
    try:
        yield seen
    finally:
        for name, fn in orig.items():
            setattr(dist, name, fn)


def tp_collective_ms(mesh, dev) -> dict:
    """ms a call, through gloo on the shared card, of the stereo stack's
    k3 halo exchange ([1, 32, 96, 312, 32] bf16 slab, a plane each way)
    and of a GroupNorm's moment sum ([2, 1, 32] float32), each synced."""
    from snvc_tpu_torch.parallel.tensor import halo_exchange, model_sum

    x = torch.randn((1, 32, 96, 312, 32), device=dev, dtype=torch.bfloat16)
    moments = torch.randn((2, 1, 32), device=dev)
    res = {}
    for name, fn, reps in (("halo", lambda: halo_exchange(x, 1, 1, 1, mesh),
                            20),
                           ("moments", lambda: model_sum(moments, mesh), 50)):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t) * 1e3 / reps
    return res


def tp_paths(dev, mesh=None, kinds=("stereo", "vernier")) -> dict:
    """Every path of the phase on this process: serving (``tp_detect``),
    the stereo step (StereoConfig(), batch 1) and the flagship-grid
    Vernier step (TP_VERNIER) in bf16 (2 steps, the second warm) and in
    float32 (step 0), the training paths those of ``kinds``; split over
    ``mesh``'s model axis with a mesh; the K2 input widths of the bf16
    Vernier steps and the collectives (calls, MB) a bf16 step or
    request."""
    with counting_collectives() as seen:
        res = dict(detect=tp_detect(dev, mesh))
    res["detect"]["collectives"] = {k: (n // 4, b / 4e6)
                                    for k, (n, b) in seen.items()}
    for kind, cfg in (("stereo", StereoConfig()), ("vernier", TP_VERNIER)):
        if kind not in kinds:
            continue
        widths, restore = tp_k2_widths()
        try:
            with counting_collectives() as seen:
                res[kind] = dict(bf16=dp_steps(kind, dev, mesh, cfg=cfg,
                                               frames=1))
        finally:
            restore()
        res[kind]["collectives"] = {k: (n // 2, b / 2e6)
                                    for k, (n, b) in seen.items()}
        res[kind]["k2_widths"] = sorted(set(widths))
        res[kind]["f32"] = dp_steps(kind, dev, mesh, float32=True, steps=1,
                                    cfg=cfg, frames=1)
    return res


def tp_rank(mesh) -> dict:
    assert (mesh.n_data, mesh.n_model) == (1, DP_RANKS), mesh
    dev = mesh.devices[mesh.rank]
    res = tp_paths(dev, mesh)
    res["collective_ms"] = tp_collective_ms(mesh, dev)
    return res


def check_tensor_parallel(gen, dev) -> dict:
    """Phase 26: tensor parallelism, the "model" axis (parallel/tensor.py).
    The kernels at the split paths' shapes (``tp_slab_kernels``); every
    path on this process (``tp_paths``); then on DP_RANKS gloo ranks
    sharing the card at n_data 1, n_model 2 (``initialize_multihost``):
    the ranks agree bit for bit; the float32 steps' metrics within
    phase train_reference's rule of this process's (losses 1e-4,
    grad_norm 3e-3), the float32 detections' sorted valid scores within
    1e-3 of the largest (bf16 differences printed: the slabs' convs take
    other algorithms); the ranks' metrics and scores within 1e-5
    relative in float32, 1e-2 in bf16 (each rank computes the replicated
    layers itself); per rank K3 = K4 = 2 for two bf16 requests, per
    bf16 stereo step K3 1 + 1, K4 1 + 1 and Vernier step K1 1 + 1, K2 /
    dx / dw 3, with each K2 input 96 lengths + the halo (102, 100, 104);
    peak memory a rank beside this process's."""
    t = time.perf_counter()
    torch.cuda.empty_cache()
    kern = tp_slab_kernels(gen, dev)
    t_one = time.perf_counter()
    one = tp_paths(dev)
    torch.cuda.empty_cache()
    t_ranks = time.perf_counter()
    ranks = run_dp_ranks(tp_rank, n_model=DP_RANKS, timeout=600.0)
    t_end = time.perf_counter()
    fields, failed = {}, []
    total = counts_of()
    want = dict(detect=counts_of(K3=2, K4=2),
                stereo=counts_of(K3=2, K3_bwd=2, K4=2, K4_bwd=2),
                vernier=counts_of(K1=2, K1_bwd=2, K2=6, K2_dx=6, K2_dw=6))
    for r, res in enumerate(ranks):
        got = dict(detect=res["detect"]["bf16"]["counts"],
                   stereo=res["stereo"]["bf16"]["counts"],
                   vernier=res["vernier"]["bf16"]["counts"])
        for k, c in got.items():
            if c != want[k]:
                failed.append(f"rank {r} {k} launch counts {c}")
            for key, v in c.items():
                total[key] += v
        if res["vernier"]["k2_widths"] != [100, 102, 104]:
            failed.append(f"rank {r} K2 widths {res['vernier']['k2_widths']}")
    # the model ranks compute the replicated layers (the encoder, the BEV
    # head, the layers after the gather) each on its own: the card may
    # round them apart, so their agreement is printed, and gated at 1e-5
    # relative in float32, 1e-2 in bf16
    b = ranks[-1]
    for dt, tol in (("bf16", 1e-2), ("f32", 1e-5)):
        diffs = {}
        for kind in ("stereo", "vernier"):
            m0, m1 = ranks[0][kind][dt]["metrics"], b[kind][dt]["metrics"]
            diffs[kind] = max(abs(m0[k] - m1[k]) / max(abs(m0[k]), 1e-12)
                              for k in m0)
        o0, o1 = ranks[0]["detect"][dt]["outs"], b["detect"][dt]["outs"]
        diffs["detect_scores"] = max(
            float(np.abs(x[1] - y[1]).max()) / max(float(np.abs(x[1]).max()),
                                                   1e-12)
            for x, y in zip(o0, o1))
        fields[f"ranks_{dt}_rel_diff"] = ",".join(
            f"{k}:{v:.2e}" for k, v in diffs.items())
        failed += [f"ranks {dt} {k} {v:.2e}" for k, v in diffs.items()
                   if not v <= tol]
    for kind in ("detect", "stereo", "vernier"):
        fields[f"{kind}_collectives"] = ",".join(
            f"{k}:{n}x/{mb:.1f}MB" for k, (n, mb) in
            ranks[0][kind]["collectives"].items())
    fields["collective_ms"] = ",".join(
        f"{k}:{v:.2f}" for k, v in ranks[0]["collective_ms"].items())
    fields["k2_widths_a_rank"] = ",".join(
        str(r["vernier"]["k2_widths"]) for r in ranks).replace(" ", "")
    r0 = ranks[0]
    for kind in ("stereo", "vernier"):
        ref = one[kind]["f32"]["metrics"]
        for dt in ("bf16", "f32"):
            got = r0[kind][dt]["metrics"]
            assert all(math.isfinite(v) for v in got.values()), got
            errs = {k: abs(got[k] - v) / max(abs(v), 1e-12)
                    for k, v in ref.items()}
            fields[f"{kind}_{dt}_vs_one_f32"] = \
                f"{max(errs.values()):.2e}({max(errs, key=errs.get)})"
            if dt == "f32":
                failed += [f"{kind} {k} {e:.2e}" for k, e in errs.items()
                           if e > (3e-3 if k == "grad_norm" else 1e-4)]
        fields[f"{kind}_step_ms"] = ",".join(
            f"{r[kind]['bf16']['step_ms'][1]:.1f}" for r in ranks)
        fields[f"{kind}_step_ms_one"] = \
            f"{one[kind]['bf16']['step_ms'][1]:.1f}"
        fields[f"{kind}_peak_gb"] = ",".join(
            f"{r[kind]['bf16']['peak_gb']:.2f}" for r in ranks)
        fields[f"{kind}_peak_gb_one"] = f"{one[kind]['bf16']['peak_gb']:.2f}"
    for dt in ("bf16", "f32"):
        got, ref = r0["detect"][dt]["outs"], one["detect"][dt]["outs"]
        for a, b in zip(got, ref):
            boxes, scores, _, valid = a
            assert np.isfinite(boxes[valid > 0]).all() and valid.any(), dt
            sa = np.sort(a[1][a[3] > 0])[::-1]
            sb = np.sort(b[1][b[3] > 0])[::-1]
            n = min(len(sa), len(sb))
            err = float(np.abs(sa[:n] - sb[:n]).max(initial=0.0))
            fields[f"detect_{dt}_scores_max_diff"] = f"{err:.2e}"
            fields[f"detect_{dt}_valid"] = f"{len(sa)}/{len(sb)}"
            if dt == "f32" and (len(sa) != len(sb)
                                or err > 1e-3 * float(sb.max())):
                failed.append(f"detect f32 scores {err:.2e}")
    fields["detect_ms"] = ",".join(
        "/".join(f"{v:.1f}" for v in r["detect"]["bf16"]["ms"])
        for r in ranks)
    fields["detect_ms_one"] = "/".join(
        f"{v:.1f}" for v in one["detect"]["bf16"]["ms"])
    fields["detect_peak_gb"] = ",".join(
        f"{r['detect']['bf16']['peak_gb']:.2f}" for r in ranks)
    fields["detect_peak_gb_one"] = f"{one['detect']['bf16']['peak_gb']:.2f}"
    phase("tensor_parallel", t, ranks=DP_RANKS, n_model=DP_RANKS,
          backend="gloo", note=repr(TP_NOTE),
          kernels_s=f"{t_one - t:.1f}", one_s=f"{t_ranks - t_one:.1f}",
          ranks_s=f"{t_end - t_ranks:.1f}", **fields,
          nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(total).replace(" ", ""))
    assert not failed, f"tensor_parallel: {failed}"
    return dict(counts=total, kernels=kern, one=one, rank0=ranks[0])


# the uneven splits: StereoConfig()'s 64 planes over 3 positions (units of
# 4: 24 / 20 / 20), the flagship grid's 192 lengths over 5 (units of 16:
# 48 / 48 / 32 / 32 / 32)
TPL_STEREO_N, TPL_VERNIER_N = 3, 5
TPL_PLANES, TPL_LENGTHS = (24, 20, 20), (48, 48, 32, 32, 32)
# the batch of the n_model 5 Vernier steps: every position runs the HRNet
# on the whole batch and keeps its own activations
TPL_VERNIER_BATCH = 4
TPL_NOTE = "positions share one card: no scaling figure"


@contextlib.contextmanager
def position_launches():
    """Counts the forward kernels' launches (K1-K4, through the names the
    models call them by) by the thread that made them, and K2's input
    widths, while open: parallel/local.run_positions names each
    position's thread ``position-<p>``.  Yields {thread: {kernel: n}} and
    the set of K2 widths."""
    from snvc_tpu_torch.models import layers, stereonet, vernier

    seen, widths = {}, set()
    names = ((vernier, "stereo_voxel_sample", "K1"),
             (layers, "conv3d_large_tap", "K2"),
             (stereonet, "plane_sweep_volume_k3", "K3"),
             (stereonet, "frustum_to_voxel_k4", "K4"))
    orig = [getattr(mod, name) for mod, name, _ in names]

    def counting(fn, key):
        def call(*args, **kw):
            c = seen.setdefault(threading.current_thread().name, {})
            c[key] = c.get(key, 0) + 1
            if key == "K2":
                widths.add(int(args[0].shape[3]))
            return fn(*args, **kw)
        return call

    for (mod, name, key), fn in zip(names, orig):
        setattr(mod, name, counting(fn, key))
    try:
        yield seen, widths
    finally:
        for (mod, name, _), fn in zip(names, orig):
            setattr(mod, name, fn)


@contextlib.contextmanager
def remat_witness():
    """Counts, while open, the meetings the one-process rendezvous holds
    and the forwards of each 3D hourglass module (the Vernier head's
    rematerialized block, by module): yields [meetings] and {id: n}."""
    from snvc_tpu_torch.models import layers
    from snvc_tpu_torch.parallel import local

    lock, meetings, forwards = threading.Lock(), [0], {}
    meet = local.Rendezvous.meet
    fwd = {cls: cls.forward for cls in (layers.Hourglass,
                                        layers.HourglassDeep)}

    def counting_meet(self, *args, **kw):
        with lock:
            meetings[0] += 1
        return meet(self, *args, **kw)

    def counting(fn):
        def forward(self, *args, **kw):
            if isinstance(self._convs[0], layers.ConvNorm3d):
                with lock:
                    forwards[id(self)] = forwards.get(id(self), 0) + 1
            return fn(self, *args, **kw)
        return forward

    local.Rendezvous.meet = counting_meet
    for cls, fn in fwd.items():
        cls.forward = counting(fn)
    try:
        yield meetings, forwards
    finally:
        local.Rendezvous.meet = meet
        for cls, fn in fwd.items():
            cls.forward = fn


# bf16 steps of each Vernier step with and without remat on two
# positions: the first steps warm the positions' threads
TPL_REMAT_STEPS = 4


def tpl_remat_steps(dev, mesh, failed: list) -> dict:
    """The flagship-grid Vernier step (TP_VERNIER) on the one-process
    ``mesh`` with ``cfg.remat`` (as it trains) and without:
    TPL_REMAT_STEPS bf16 steps (launches a position, K2 widths,
    hourglass forwards, meetings, ms, peak memory) and a float32 step 0
    each; the float32 step with remat under train_reference's rule of
    the one without.  Returns the fields, the run with remat (as
    ``tp_paths`` gives a path) and the launches of the one without."""
    res, fields = {}, {}
    for remat in (True, False):
        cfg = TP_VERNIER.replace(remat=remat)
        with remat_witness() as (meetings, forwards), \
                position_launches() as (seen, widths):
            bf16 = dp_steps("vernier", dev, mesh, cfg=cfg, frames=1,
                            steps=TPL_REMAT_STEPS)
        res[remat] = dict(
            bf16=bf16, meetings=meetings[0], k2_widths=sorted(widths),
            forwards=sorted(forwards.values()),
            by_pos=[seen.get(f"position-{p}", {}) for p in range(2)],
            f32=dp_steps("vernier", dev, mesh, float32=True, steps=1,
                         cfg=cfg, frames=1))
    on, off = res[True], res[False]
    fields["remat_f32_vs_no_remat"] = tpl_check_f32(
        "remat vs no remat", on["f32"]["metrics"], off["f32"]["metrics"],
        failed)
    S = TPL_REMAT_STEPS
    want = counts_of(K1=2 * S, K1_bwd=2 * S, K2=6 * S, K2_dx=6 * S,
                     K2_dw=6 * S)
    for remat, r in res.items():
        label = "remat" if remat else "no_remat"
        if r["bf16"]["counts"] != want:
            failed.append(f"{label} launch counts {r['bf16']['counts']}")
        if r["by_pos"] != [{"K1": S, "K2": 3 * S}] * 2:
            failed.append(f"{label} launches a position {r['by_pos']}")
        # each position's hourglass: a forward a step, and a recompute
        if r["forwards"] != [(2 if remat else 1) * S] * 2:
            failed.append(f"{label} hourglass forwards {r['forwards']}")
        ms = r["bf16"]["step_ms"]
        fields[f"{label}_hourglass_forwards"] = "/".join(
            map(str, r["forwards"]))
        fields[f"{label}_meetings"] = r["meetings"]
        fields[f"{label}_step_ms"] = "/".join(f"{v:.1f}" for v in ms)
        fields[f"{label}_warm_median_ms"] = f"{float(np.median(ms[1:])):.1f}"
        fields[f"{label}_peak_gb"] = f"{r['bf16']['peak_gb']:.2f}"
        fields[f"{label}_f32_peak_gb"] = f"{r['f32']['peak_gb']:.2f}"
    if on["meetings"] != off["meetings"]:
        failed.append(f"meetings {on['meetings']} with remat, "
                      f"{off['meetings']} without")
    return dict(fields=fields, vernier=dict(
        bf16=on["bf16"], f32=on["f32"], k2_widths=on["k2_widths"]),
        no_remat_counts=off["bf16"]["counts"])


# the flagship prelude's conv3_k5_d2 input, 8 of its lengths
TPL_WIDE_SHAPE = (4, 32, 192, 8, 32)


def assert_split_sum(label, got, ref, parts: int) -> float:
    """A bf16 gradient that the split adds from ``parts`` bf16 partials
    (each rounded, then added in bf16) against the whole layer's (one
    rounding): 2^-7 relative plus ``parts`` x 2^-8 of the scale."""
    err = (got.float() - ref).abs()
    tol = 2.0 ** -7 * ref.abs() + parts * 2.0 ** -8 * ref.abs().max()
    assert bool((err <= tol).all()), f"{label}: max err {err.max().item()}"
    return err.max().item()


def tpl_wide_halo(gen, dev) -> dict:
    """The flagship prelude's conv3_k5_d2 (32 channels, a 4-length halo)
    on a TPL_WIDE_SHAPE volume split on its 8 lengths over
    make_mesh(1, [dev] * 4, 4): slabs of 2 lengths, each halo reaching
    two slabs; the output, dx and dw (one backward of every position's
    weighted sum) against the whole layer's on the card, each largest
    error of the whole's scale.  In float32 (cuDNN, TF32 off) within
    1e-4 of scale (dw sums 2e5 products a weight, in another order on
    slabs); in bf16 (K2, dx and dw on their kernels) the output under
    K2's rule, and dx (a length adds the partials of up to 5 positions)
    and dw (4) under ``assert_split_sum``."""
    from snvc_tpu_torch.models.layers import Conv3d, tensor_parallel
    from snvc_tpu_torch.parallel.local import replicas, run_positions
    from snvc_tpu_torch.parallel.tensor import shard

    torch.backends.cudnn.allow_tf32 = False
    n, C = 4, TPL_WIDE_SHAPE[-1]
    w0 = torch.randn((C, C, 5, 5, 5), generator=gen) / math.sqrt(125 * C)
    x0 = torch.randn(TPL_WIDE_SHAPE, generator=gen)
    r = torch.randn(TPL_WIDE_SHAPE, generator=gen).to(dev)
    mesh = make_mesh(1, [dev] * n, n)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        whole = Conv3d(C, C, 5, dilation=2, split_axis=3)
        with torch.no_grad():
            whole.weight.copy_(w0)
        whole.to(dev)
        split = copy.deepcopy(whole)
        x = x0.to(dev, dt)
        xw = x.clone().requires_grad_()
        y = whole(xw)
        (y.float() * r).sum().backward()
        reps = replicas(split, mesh)
        xl = x.clone().requires_grad_()

        def position(pos):
            with tensor_parallel(reps[pos.rank], pos):
                ys = reps[pos.rank](shard(xl, 3, pos))
            return ys, (ys.float() * shard(r, 3, pos)).sum()

        outs = run_positions(mesh, position)
        sum(loss for _, loss in outs).backward()
        assert [ys.shape[3] for ys, _ in outs] \
            == [TPL_WIDE_SHAPE[3] // n] * n
        got = dict(out=torch.cat([ys for ys, _ in outs], 3), dx=xl.grad,
                   dw=split.weight.grad)
        ref = dict(out=y, dx=xw.grad, dw=whole.weight.grad)
        name = "f32" if dt == torch.float32 else "bf16"
        for part, g in got.items():
            g, want = g.detach(), ref[part].detach().float()
            label = f"wide halo {name} {part}"
            if dt == torch.float32:
                err = float((g - want).abs().max())
                assert err <= 1e-4 * float(want.abs().max()), (label, err)
            elif part == "out":
                err = assert_conv(label, g, want)
            else:
                err = assert_split_sum(label, g, want,
                                       5 if part == "dx" else n)
            errs[f"{name}_{part}"] = err / float(want.abs().max())
    return errs


def tp_uneven_kernels(gen, dev) -> dict:
    """K1 and its backward on the flagship grid's nl slabs at n_model 5
    (4 instances, the batch's own projections), K2 / dx / dw on the three
    prelude convs' slabs widened by their halos, K3 and its backward on
    each of StereoConfig()'s slabs at n_model 3, against their plain
    versions, each slab width timed with its bound."""
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    cfg = flagship_vernier_config()
    (nh, nw, nl), roi = cfg.grid_resolution, cfg.resolution
    N = cfg.max_instances
    gl_all, gr_all = batch_projections(cfg, 0, dev)
    lf, rf, _, _ = k1_case(gen, N, 64, 64, 32, (1, 1, 1), roi,
                           torch.bfloat16, dev)
    for L in sorted(set(TPL_LENGTHS), reverse=True):
        grid = (nh, nw, L)
        gl, gr = (g.reshape(N, nh, nw, nl, 2)[:, :, :, :L]
                  .reshape(N, -1, 2).contiguous() for g in (gl_all, gr_all))
        err = assert_k1(f"tpl K1 slab {L}", lf, rf, gl, gr, roi, grid)
        out[f"K1_L{L}"] = dict(max_abs_err=err,
                               **k1_times(lf, rf, gl, gr, roi, grid))
        g = torch.randn((N,) + grid + (64,), generator=gen).to(
            dev, torch.bfloat16)
        err = assert_k1_bwd(f"tpl K1_bwd slab {L}", lf, rf, gl, gr, g, roi)
        out[f"K1_bwd_L{L}"] = dict(max_abs_err=err,
                                   **k1_bwd_times(lf, rf, gl, gr, g, roi))
        del gl, gr, g
    del lf, rf, gl_all, gr_all
    for L in sorted(set(TPL_LENGTHS), reverse=True):
        for name, C, kernel, dil in (("conv1_k7", 64, (7, 7, 7), 1),
                                     ("conv2_k5", 32, (5, 5, 5), 1),
                                     ("conv3_k5_d2", 32, (5, 5, 5), 2)):
            W = L + (kernel[2] - 1) * dil  # slab + both halos
            shape = (N, nh, nw, W, C)
            err, times = run_k2_case(gen, dev, f"tpl {name} W={W}", shape,
                                     kernel, 32, dil, True)
            out[f"K2_{name}_W{W}"] = dict(max_abs_err=err, **times)
            bwd = run_k2_bwd_case(gen, dev, f"tpl {name} W={W}", shape,
                                  kernel, 32, dil, True)
            out[f"K2_dx_{name}_W{W}"] = bwd["dx"]
            out[f"K2_dw_{name}_W{W}"] = bwd["dw"]
    scfg = StereoConfig()
    H, W = scfg.input_size[0] // 4, scfg.input_size[1] // 4
    lf = torch.randn((1, H, W, 32), generator=gen).to(dev, torch.bfloat16)
    rf = torch.randn((1, H, W, 32), generator=gen).to(dev, torch.bfloat16)
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    shifts = plane_shifts(Pl, Pr, torch.from_numpy(
        depth_hypotheses(scfg)).to(dev))
    d0 = 0
    for m, d in enumerate(TPL_PLANES):  # position m's planes
        s_m = shifts[:, d0:d0 + d].contiguous()
        d0 += d
        v = plane_sweep_volume_k3(lf, rf, s_m)
        err = assert_within_ulps(f"tpl K3 slab {m}", v,
                                 plane_sweep_shifted(lf, rf, s_m))
        gv = torch.randn(v.shape, generator=gen).to(dev, torch.bfloat16)
        berr = max(assert_within_ulps(f"tpl K3_bwd slab {m} {name}", a, b)
                   for name, a, b in zip(
                       ("dleft", "dright"),
                       plane_sweep_volume_k3_bwd(gv, s_m, W),
                       plane_sweep_shifted_bwd(gv, s_m, W)))
        if m < 2:  # one slab of each width: 24 planes, 20 planes
            out[f"K3_D{d}"] = dict(max_abs_err=err, **k3_times(lf, rf, s_m))
            out[f"K3_bwd_D{d}"] = dict(max_abs_err=berr,
                                       **k3_bwd_times(gv, s_m, W))
        del v, gv
    torch.cuda.empty_cache()
    phase("tensor_parallel_local kernels", t, **{
        f"{k}_{key}": (f"{v:.3e}" if key == "max_abs_err" else f"{v:.4f}")
        for k, d in out.items() for key, v in d.items()})
    return out


def tpl_check_f32(label, got: dict, ref: dict, failed: list) -> str:
    """train_reference's rule (losses 1e-4, grad_norm 3e-3 relative) of
    ``got``'s float32 metrics against ``ref``'s; the largest difference
    as a field."""
    assert all(math.isfinite(v) for v in got.values()), (label, got)
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-12) for k, v in ref.items()}
    failed += [f"{label} {k} {e:.2e}" for k, e in errs.items()
               if e > (3e-3 if k == "grad_norm" else 1e-4)]
    worst = max(errs, key=errs.get)
    return f"{errs[worst]:.2e}({worst})"


def f32_step_drift(dev, cfg) -> dict:
    """The one-device float32 Vernier step of ``cfg`` (TF32 off) run twice
    in this process from the same seeded state on the same batch, then
    twice more with ``torch.backends.cudnn.deterministic``: each pair's
    gap in ``grad_norm`` (relative) and the largest gradient difference
    among the encoder's and among the head's parameters (of each
    tensor's scale).  K1's backward is the only kernel between the head
    and the encoder, and it sums in float32 with shared-memory atomics;
    cuDNN's algorithms may add in another order from run to run
    unless deterministic."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tc = TrainConfig(warmup_steps=2)
    cfg = cfg.replace(compute_dtype="float32")
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), dev)

    def run():
        model = VernierScale(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, cfg, tc)
        m = make_train_step(cfg, tc, dev)(state, batch)
        grads = {n: p.grad.detach().clone()
                 for n, p in model.named_parameters()}
        del state, model
        return float(m["grad_norm"]), grads

    def gap(a, b, prefix):
        return max(float((a[k] - b[k]).abs().max())
                   / max(float(b[k].abs().max()), 1e-30)
                   for k in b if k.startswith(prefix))

    was = torch.backends.cudnn.deterministic
    res = {}
    try:
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            (n1, g1), (n2, g2) = run(), run()
            res["deterministic" if det else "default"] = dict(
                grad_norm=abs(n1 - n2) / abs(n2),
                encoder=gap(g1, g2, "encoder."), head=gap(g1, g2, "head."))
            del g1, g2
    finally:
        torch.backends.cudnn.deterministic = was
    torch.cuda.empty_cache()
    return res


def tpl_head_steps(dev, failed: list) -> dict:
    """The 3D and BEV heads at a small config (hrnet-tiny, 4 instances at
    384x1280; 3D on 12 lengths, 8 / 4 a position): a float32 step 0 on
    make_mesh(1, [dev, dev], 2) against the one-device step, each
    position's K1 sampling its slab once."""
    mesh = make_mesh(1, [dev, dev], 2)
    fields = {}
    for vt, kw in (("3D", dict(grid_type="3D", num_parts=3,
                               grid_resolution=(8, 16, 12))),
                   ("BEV", dict(grid_resolution=(8, 16, 16)))):
        cfg = tiny_vernier_config(vernier_type=vt, max_instances=4,
                                  image_size=(384, 1280), **kw)
        one = dp_steps("vernier", dev, None, float32=True, steps=1, cfg=cfg)
        with position_launches() as (seen, _):
            got = dp_steps("vernier", dev, mesh, float32=True, steps=1,
                           cfg=cfg)
        fields[f"head_{vt}_f32_vs_one"] = tpl_check_f32(
            f"head {vt}", got["metrics"], one["metrics"], failed)
        # each position sampled its slab (K1 once)
        pos = [seen.get(f"position-{p}", {}) for p in range(2)]
        if pos != [{"K1": 1}] * 2:
            failed.append(f"head {vt} launches a position {pos}")
    return fields


def check_tensor_parallel_local(gen, dev, tp: dict) -> dict:
    """Phase 27: the one-process data x model mesh (parallel/local.py) on
    the card.  The kernels at the uneven slabs' shapes
    (``tp_uneven_kernels``); phase tensor_parallel's paths on
    make_mesh(1, [dev, dev], 2) (``tp_paths``), the float32 ones held to
    ``tp``'s one-device runs and gloo rank 0 under train_reference's rule
    (losses 1e-4, grad_norm 3e-3), the float32 detection scores within
    1e-3 of the largest; launches in all (detect K3 = K4 = 4 over 2 bf16
    requests, stereo K3 / K3_bwd / K4 / K4_bwd 4 over 2 bf16 steps,
    Vernier K1 / K1_bwd 8, K2 / dx / dw 24 over TPL_REMAT_STEPS) and a
    position (the forward kernels by thread: alike on both), K2 widths
    100 / 102 / 104.  The Vernier path rematerializes its 3D hourglass
    (TP_VERNIER's remat), beside the same step without
    (``tpl_remat_steps``).  The uneven meshes (StereoConfig() at n_model
    3, the flagship grid at n_model 5, K2 widths 54 / 52 / 56 and 38 / 36
    / 40) and the 3D / BEV heads at n_model 2, each float32 step under
    the same rule; the one-device float32 flagship-grid step rerun in
    this process (``f32_step_drift``), its gaps printed; a conv whose
    halo reaches two slabs against the whole layer
    (``tpl_wide_halo``)."""
    t = time.perf_counter()
    torch.cuda.empty_cache()
    kern = tp_uneven_kernels(gen, dev)
    t_paths = time.perf_counter()
    fields, failed = {}, []
    one, rank0 = tp["one"], tp["rank0"]
    total = counts_of()
    mesh = make_mesh(1, [dev, dev], 2)
    with position_launches() as (seen, widths):
        two = tp_paths(dev, mesh, kinds=("stereo",))
        # the Vernier path with remat, beside it without
        remat = tpl_remat_steps(dev, mesh, failed)
    two["vernier"] = remat["vernier"]
    fields.update(remat["fields"])
    for key, v in remat["no_remat_counts"].items():
        total[key] += v
    S = TPL_REMAT_STEPS
    want = dict(detect=counts_of(K3=4, K4=4),
                stereo=counts_of(K3=4, K3_bwd=4, K4=4, K4_bwd=4),
                vernier=counts_of(K1=2 * S, K1_bwd=2 * S, K2=6 * S,
                                  K2_dx=6 * S, K2_dw=6 * S))
    for kind in ("detect", "stereo", "vernier"):
        c = two[kind]["bf16"]["counts"]
        if c != want[kind]:
            failed.append(f"{kind} launch counts {c}")
        for key, v in c.items():
            total[key] += v
    by_pos = [seen.get(f"position-{p}", {}) for p in range(2)]
    if by_pos[0] != by_pos[1] or not all(by_pos[0].get(k) for k in
                                         ("K1", "K2", "K3", "K4")):
        failed.append(f"launches a position {by_pos}")
    fields["launches_a_position"] = json.dumps(by_pos[0]).replace(" ", "")
    if two["vernier"]["k2_widths"] != [100, 102, 104]:
        failed.append(f"K2 widths {two['vernier']['k2_widths']}")
    fields["k2_widths"] = ",".join(map(str, two["vernier"]["k2_widths"]))
    for kind in ("stereo", "vernier"):
        got = two[kind]["f32"]["metrics"]
        fields[f"{kind}_f32_vs_one"] = tpl_check_f32(
            f"{kind} vs one", got, one[kind]["f32"]["metrics"], failed)
        fields[f"{kind}_f32_vs_gloo"] = tpl_check_f32(
            f"{kind} vs gloo", got, rank0[kind]["f32"]["metrics"], failed)
        errs = {k: abs(two[kind]["bf16"]["metrics"][k] - v)
                / max(abs(v), 1e-12)
                for k, v in one[kind]["f32"]["metrics"].items()}
        fields[f"{kind}_bf16_vs_one_f32"] = f"{max(errs.values()):.2e}"
        for src, res in (("", two), ("_one", one), ("_gloo", rank0)):
            fields[f"{kind}_step_ms{src}"] = \
                f"{res[kind]['bf16']['step_ms'][1]:.1f}"
            fields[f"{kind}_peak_gb{src}"] = \
                f"{res[kind]['bf16']['peak_gb']:.2f}"
    for dt in ("bf16", "f32"):
        for a, b in zip(two["detect"][dt]["outs"], one["detect"][dt]["outs"]):
            assert np.isfinite(a[0][a[3] > 0]).all() and a[3].any(), dt
            sa = np.sort(a[1][a[3] > 0])[::-1]
            sb = np.sort(b[1][b[3] > 0])[::-1]
            n = min(len(sa), len(sb))
            err = float(np.abs(sa[:n] - sb[:n]).max(initial=0.0))
            fields[f"detect_{dt}_scores_max_diff"] = f"{err:.2e}"
            if dt == "f32" and (len(sa) != len(sb)
                                or err > 1e-3 * float(sb.max())):
                failed.append(f"detect f32 scores {err:.2e}")
    for src, res in (("", two), ("_one", one), ("_gloo", rank0)):
        fields[f"detect_ms{src}"] = "/".join(
            f"{v:.1f}" for v in res["detect"]["bf16"]["ms"])
        fields[f"detect_peak_gb{src}"] = \
            f"{res['detect']['bf16']['peak_gb']:.2f}"
    t_uneven = time.perf_counter()
    # uneven slabs
    mesh3 = make_mesh(1, [dev] * TPL_STEREO_N, TPL_STEREO_N)
    vcfg = flagship_vernier_config(max_instances=TPL_VERNIER_BATCH)
    mesh5 = make_mesh(1, [dev] * TPL_VERNIER_N, TPL_VERNIER_N)
    ref = dict(stereo=one["stereo"]["f32"]["metrics"],
               vernier=dp_steps("vernier", dev, None, float32=True, steps=1,
                                cfg=vcfg)["metrics"])
    # the one-device float32 step against itself: the drift's source
    for mode, gaps in f32_step_drift(dev, vcfg).items():
        for part, v in gaps.items():
            fields[f"vernier_f32_rerun_{mode}_{part}_gap"] = f"{v:.3e}"
    for kind, cfg, m, n in (("stereo", StereoConfig(), mesh3, TPL_STEREO_N),
                            ("vernier", vcfg, mesh5, TPL_VERNIER_N)):
        with position_launches() as (seen, widths):
            bf16 = dp_steps(kind, dev, m, cfg=cfg, frames=1, steps=1)
        f32 = dp_steps(kind, dev, m, float32=True, steps=1, cfg=cfg,
                       frames=1)
        for key, v in bf16["counts"].items():
            total[key] += v
        fields[f"{kind}_n{n}_f32_vs_one"] = tpl_check_f32(
            f"{kind} n{n}", f32["metrics"], ref[kind], failed)
        fields[f"{kind}_n{n}_step_ms"] = f"{bf16['step_ms'][0]:.1f}"
        fields[f"{kind}_n{n}_peak_gb"] = f"{bf16['peak_gb']:.2f}"
        fields[f"{kind}_n{n}_launches"] = json.dumps(
            {k: v for k, v in bf16["counts"].items() if v}).replace(" ", "")
        pos = [seen.get(f"position-{p}", {}) for p in range(n)]
        if any(p != pos[0] for p in pos) or not pos[0]:
            failed.append(f"{kind} n{n} launches a position {pos}")
        if kind == "vernier":
            fields["vernier_n5_k2_widths"] = ",".join(map(str,
                                                          sorted(widths)))
            if sorted(widths) != [36, 38, 40, 52, 54, 56]:
                failed.append(f"vernier n5 K2 widths {sorted(widths)}")
            fields["vernier_n5_f32_peak_gb"] = f"{f32['peak_gb']:.2f}"
    t_heads = time.perf_counter()
    fields.update(tpl_head_steps(dev, failed))
    t_wide = time.perf_counter()
    for part, err in tpl_wide_halo(gen, dev).items():
        fields[f"wide_halo_{part}_err"] = f"{err:.3e}"
    t_end = time.perf_counter()
    phase("tensor_parallel_local", t, n_model="2,3,4,5", note=repr(TPL_NOTE),
          kernels_s=f"{t_paths - t:.1f}", paths_s=f"{t_uneven - t_paths:.1f}",
          uneven_s=f"{t_heads - t_uneven:.1f}",
          heads_s=f"{t_wide - t_heads:.1f}",
          wide_halo_s=f"{t_end - t_wide:.1f}", **fields,
          nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(total).replace(" ", ""))
    assert not failed, f"tensor_parallel_local: {failed}"
    return dict(counts=total, kernels=kern)


# ------------------------------------------------ tensor_parallel_padded ----
# the repo's trained Vernier model (BEV_type3, hrnet-tiny, 8 x 48 x 48,
# HourglassDeep: units of 16 lengths) on (n_model, nl): 3 units over 4
# positions (16 / 16 / 16 / 0), over 2 (32 / 16), and its weights on a
# 44-length grid (the CoordHead's shapes are 48's), 16 / 16 / 12 / 0
TPP_TRAINED = ((4, 48), (2, 48), (4, 44))
# StereoConfig() at 8 planes, 2 units of 4 over three positions: 4 / 4 /
# 0 (both packages refuse a num_depths that 4 does not divide)
TPP_STEREO = StereoConfig(num_depths=8)
TPP_STEREO_N = 3
# the forward kernels' libraries (models call them on the positions'
# threads; the backward runs on autograd's)
TPP_LIBS = dict(stereo_voxel_sample="K1", conv3d_large_tap="K2",
                plane_sweep_volume="K3", frustum_to_voxel="K4")


@contextlib.contextmanager
def thread_launches():
    """Counts kernel launches by the thread that made them while open:
    every wrapper loads its library (``_build.load_library``) once a
    launch, after the checks that return an empty output without one.
    Yields {thread: {kernel: n}} (the forward kernels, TPP_LIBS)."""
    seen = {}
    orig = _build.load_library

    def counting(name):
        c = seen.setdefault(threading.current_thread().name, {})
        key = TPP_LIBS.get(name, name)
        c[key] = c.get(key, 0) + 1
        return orig(name)

    _build.load_library = counting
    try:
        yield seen
    finally:
        _build.load_library = orig


def trained_vernier(nl: int):
    """(config, float32 state dict) of the repo's trained Vernier model
    on an 8 x 48 x ``nl`` grid."""
    from snvc_tpu_torch.tools._model_dir import read_model_dir

    cfg, tree, _ = read_model_dir(os.path.join(TRAINED, "vernier"),
                                  VernierConfig)
    grid = tuple(cfg.grid_resolution[:2]) + (nl,)
    return cfg.replace(grid_resolution=grid), tree["model"]


def tpp_kernels(gen, dev) -> dict:
    """K1 / K1 bwd on the trained model's slabs of lengths (32, 16 and the
    short 12 of the 44-length grid; a seeded batch's own projections, 8
    instances), K2 / dx / dw on its prelude convs' slabs widened by their
    halos (L + 6, + 4, + 8), K3 / K3 bwd on TPP_STEREO's 4-plane slab,
    against their plain versions, each timed with its bound; and the
    wrappers on an empty slab, which return without a launch."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for nl, lengths in ((48, (32, 16)), (44, (12,))):
        cfg, _ = trained_vernier(nl)
        (nh, nw, _), roi = cfg.grid_resolution, cfg.resolution
        N, C = cfg.max_instances, cfg.backbone.output_channel
        gl_all, gr_all = batch_projections(cfg, 0, dev)
        lf, rf, _, _ = k1_case(gen, N, roi[0] // 4, roi[1] // 4, C,
                               (1, 1, 1), roi, torch.bfloat16, dev)
        for L in lengths:
            a = nl - L  # the last slab's lengths
            grid = (nh, nw, L)
            gl, gr = (g.reshape(N, nh, nw, nl, 2)[:, :, :, a:]
                      .reshape(N, -1, 2).contiguous() for g in (gl_all,
                                                                 gr_all))
            err = assert_k1(f"tpp K1 slab {L}", lf, rf, gl, gr, roi, grid)
            out[f"K1_L{L}"] = dict(max_abs_err=err,
                                   **k1_times(lf, rf, gl, gr, roi, grid))
            g = torch.randn((N,) + grid + (2 * C,), generator=gen).to(
                dev, torch.bfloat16)
            err = assert_k1_bwd(f"tpp K1_bwd slab {L}", lf, rf, gl, gr, g,
                                roi)
            out[f"K1_bwd_L{L}"] = dict(max_abs_err=err,
                                       **k1_bwd_times(lf, rf, gl, gr, g,
                                                      roi))
            for name, cin, kernel, dil in (("conv1_k7", 2 * C, (7, 7, 7), 1),
                                           ("conv2_k5", C, (5, 5, 5), 1),
                                           ("conv3_k5_d2", C, (5, 5, 5), 2)):
                W = L + (kernel[2] - 1) * dil  # slab + both halos
                shape = (N, nh, nw, W, cin)
                err, times = run_k2_case(gen, dev, f"tpp {name} W={W}",
                                         shape, kernel, C, dil, True)
                out[f"K2_{name}_W{W}"] = dict(max_abs_err=err, **times)
                bwd = run_k2_bwd_case(gen, dev, f"tpp {name} W={W}", shape,
                                      kernel, C, dil, True)
                out[f"K2_dx_{name}_W{W}"] = bwd["dx"]
                out[f"K2_dw_{name}_W{W}"] = bwd["dw"]
        # the empty slab: no launch, the empty voxel / zero gradients
        reset_counts()
        empty = gl_all[:, :0].contiguous()
        v = stereo_voxel_sample(lf, rf, empty, empty, roi, (nh, nw, 0))
        dl, dr, dpl, _ = stereo_voxel_sample_bwd(lf, rf, empty, empty, v,
                                                 roi)
        x0 = torch.zeros((N, nh, nw, 0, C), device=dev, dtype=torch.bfloat16)
        w = torch.zeros((5, 5, 5, C, C), device=dev, dtype=torch.bfloat16)
        assert (v.shape == (N, nh, nw, 0, 2 * C) and not dl.any()
                and not dr.any() and dpl.shape == (N, 0, 2))
        assert conv3d_large_tap(x0, w).shape == x0.shape
        assert conv3d_input_grad(x0, w).shape == x0.shape
        assert not conv3d_weight_grad(x0, x0, (5, 5, 5)).any()
        assert read_counts() == counts_of(), f"empty slab {read_counts()}"
        del lf, rf, gl_all, gr_all, gl, gr, g
    scfg = TPP_STEREO
    H, W = scfg.input_size[0] // 4, scfg.input_size[1] // 4
    lf = torch.randn((1, H, W, 32), generator=gen).to(dev, torch.bfloat16)
    rf = torch.randn((1, H, W, 32), generator=gen).to(dev, torch.bfloat16)
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    shifts = plane_shifts(Pl, Pr, torch.from_numpy(
        depth_hypotheses(scfg)).to(dev))
    s_m = shifts[:, 4:8].contiguous()  # position 1's planes
    v = plane_sweep_volume_k3(lf, rf, s_m)
    err = assert_within_ulps("tpp K3 slab 4", v,
                             plane_sweep_shifted(lf, rf, s_m))
    gv = torch.randn(v.shape, generator=gen).to(dev, torch.bfloat16)
    berr = max(assert_within_ulps(f"tpp K3_bwd slab 4 {name}", a, b)
               for name, a, b in zip(
                   ("dleft", "dright"), plane_sweep_volume_k3_bwd(gv, s_m, W),
                   plane_sweep_shifted_bwd(gv, s_m, W)))
    out["K3_D4"] = dict(max_abs_err=err, **k3_times(lf, rf, s_m))
    out["K3_bwd_D4"] = dict(max_abs_err=berr, **k3_bwd_times(gv, s_m, W))
    none = shifts[:, 8:].contiguous()  # position 2's: none
    reset_counts()
    v0 = plane_sweep_volume_k3(lf, rf, none)
    d0 = plane_sweep_volume_k3_bwd(v0, none, W)
    assert v0.shape == (1, 0, H, W, 64) and not any(d.any() for d in d0)
    assert read_counts() == counts_of(), f"empty slab {read_counts()}"
    del lf, rf, v, gv, v0
    torch.cuda.empty_cache()
    return out


def tpp_vernier(dev, failed: list, fields: dict, total: dict) -> None:
    """The trained model on each (n_model, nl) of TPP_TRAINED: a bf16 step
    (K1 / K2 launches by position thread: none on the empty position; in
    all, a kernel and its backwards once per position that holds
    lengths, K2 three times) and a float32 step 0 on the one-process
    mesh, the float32 one held to the one-device step under
    train_reference's rule; ms, peak memory beside the one-device
    run's."""
    one = {}
    for n, nl in TPP_TRAINED:
        cfg, weights = trained_vernier(nl)
        if nl not in one:
            one[nl] = dict(
                bf16=dp_steps("vernier", dev, None, steps=2, cfg=cfg,
                              weights=weights),
                f32=dp_steps("vernier", dev, None, float32=True, steps=1,
                             cfg=cfg, weights=weights))
            fields[f"vernier_nl{nl}_step_ms_one"] = \
                f"{one[nl]['bf16']['step_ms'][1]:.1f}"
            fields[f"vernier_nl{nl}_peak_gb_one"] = \
                f"{one[nl]['bf16']['peak_gb']:.2f}"
        mesh = make_mesh(1, [dev] * n, n)
        b = slab_bounds(nl, n, 2 ** length_levels(cfg))
        slabs = [hi - lo for lo, hi in zip(b, b[1:])]
        with thread_launches() as seen:
            bf16 = dp_steps("vernier", dev, mesh, steps=2, cfg=cfg,
                            weights=weights)
        f32 = dp_steps("vernier", dev, mesh, float32=True, steps=1, cfg=cfg,
                       weights=weights)
        key = f"vernier_n{n}_nl{nl}"
        held = sum(1 for L in slabs if L)
        want = counts_of(K1=2 * held, K1_bwd=2 * held, K2=6 * held,
                         K2_dx=6 * held, K2_dw=6 * held)
        if bf16["counts"] != want:
            failed.append(f"{key} launches {bf16['counts']}")
        for k, v in bf16["counts"].items():
            total[k] += v
        pos = [seen.get(f"position-{p}", {}) for p in range(n)]
        for L, c in zip(slabs, pos):
            if (c != {}) if not L else (c != {"K1": 2, "K2": 6}):
                failed.append(f"{key} position launches {pos}")
        fields[f"{key}_slabs"] = "/".join(map(str, slabs))
        fields[f"{key}_launches_by_position"] = json.dumps(pos).replace(
            " ", "")
        fields[f"{key}_f32_vs_one"] = tpl_check_f32(
            key, f32["metrics"], one[nl]["f32"]["metrics"], failed)
        fields[f"{key}_step_ms"] = f"{bf16['step_ms'][1]:.1f}"
        fields[f"{key}_peak_gb"] = f"{bf16['peak_gb']:.2f}"


def tpp_stereo(dev, failed: list, fields: dict, total: dict) -> None:
    """TPP_STEREO at n_model TPP_STEREO_N (4 / 4 / 0): DetectRunner (1
    warm-up, 1 bf16 and 1 float32 frame) and one training step (bf16, and
    float32 step 0) on the one-process mesh against the one-device
    runs: float32 detection scores within 1e-3 of the largest, the
    float32 step under train_reference's rule; K3 on the positions that
    hold planes only (K4 on the gathered volume on every position)."""
    mesh = make_mesh(1, [dev] * TPP_STEREO_N, TPP_STEREO_N)
    one = tp_detect(dev, None, TPP_STEREO, frames=1)
    with thread_launches() as seen:
        got = tp_detect(dev, mesh, TPP_STEREO, frames=1)
    pos = [seen.get(f"position-{p}", {}) for p in range(TPP_STEREO_N)]
    # bf16 warm-up + frame and the float32 frame: 3 forwards a position
    if pos[:2] != [{"K3": 3, "K4": 3}] * 2 or pos[2] != {"K4": 3}:
        failed.append(f"stereo detect position launches {pos}")
    fields["stereo_detect_launches_by_position"] = json.dumps(pos).replace(
        " ", "")
    c = got["bf16"]["counts"]
    if c != counts_of(K3=2, K4=3):
        failed.append(f"stereo detect launches {c}")
    for k, v in c.items():
        total[k] += v
    for dt in ("bf16", "f32"):
        a, b = got[dt]["outs"][0], one[dt]["outs"][0]
        assert np.isfinite(a[0][a[3] > 0]).all() and a[3].any(), dt
        sa = np.sort(a[1][a[3] > 0])[::-1]
        sb = np.sort(b[1][b[3] > 0])[::-1]
        k = min(len(sa), len(sb))
        err = float(np.abs(sa[:k] - sb[:k]).max(initial=0.0))
        fields[f"stereo_detect_{dt}_scores_max_diff"] = f"{err:.2e}"
        if dt == "f32" and (len(sa) != len(sb)
                            or err > 1e-3 * float(sb.max())):
            failed.append(f"stereo detect f32 scores {err:.2e}")
    fields["stereo_detect_ms"] = f"{got['bf16']['ms'][0]:.1f}"
    fields["stereo_detect_ms_one"] = f"{one['bf16']['ms'][0]:.1f}"
    fields["stereo_detect_peak_gb"] = f"{got['bf16']['peak_gb']:.2f}"
    ref = dp_steps("stereo", dev, None, float32=True, steps=1,
                   cfg=TPP_STEREO, frames=1)
    bf16_one = dp_steps("stereo", dev, None, steps=1, cfg=TPP_STEREO,
                        frames=1)
    bf16 = dp_steps("stereo", dev, mesh, steps=1, cfg=TPP_STEREO, frames=1)
    f32 = dp_steps("stereo", dev, mesh, float32=True, steps=1,
                   cfg=TPP_STEREO, frames=1)
    if bf16["counts"] != counts_of(K3=2, K3_bwd=2, K4=3, K4_bwd=3):
        failed.append(f"stereo train launches {bf16['counts']}")
    for k, v in bf16["counts"].items():
        total[k] += v
    fields["stereo_f32_vs_one"] = tpl_check_f32(
        "stereo n3", f32["metrics"], ref["metrics"], failed)
    fields["stereo_step_ms"] = f"{bf16['step_ms'][0]:.1f}"
    fields["stereo_step_ms_one"] = f"{bf16_one['step_ms'][0]:.1f}"
    fields["stereo_peak_gb"] = f"{bf16['peak_gb']:.2f}"
    fields["stereo_peak_gb_one"] = f"{bf16_one['peak_gb']:.2f}"


def check_tensor_parallel_padded(gen, dev) -> dict:
    """Phase 28: the model axis at every extent JAX's mesh splits
    (parallel/tensor.py: a short last unit, positions that hold no
    plane), on the one-process mesh on the card.  The kernels at the
    short slab widths and on empty slabs (``tpp_kernels``); the repo's
    trained Vernier model on TPP_TRAINED's meshes (``tpp_vernier``) and
    TPP_STEREO at n_model 3 (``tpp_stereo``), the float32 runs held to
    the one-device runs under phase tensor_parallel's rules, the empty
    positions' launches 0."""
    t = time.perf_counter()
    torch.cuda.empty_cache()
    kern = tpp_kernels(gen, dev)
    phase("tensor_parallel_padded kernels", t, **{
        f"{k}_{key}": (f"{v:.3e}" if key == "max_abs_err" else f"{v:.4f}")
        for k, d in kern.items() for key, v in d.items()})
    t_paths = time.perf_counter()
    fields, failed, total = {}, [], counts_of()
    tpp_vernier(dev, failed, fields, total)
    t_stereo = time.perf_counter()
    tpp_stereo(dev, failed, fields, total)
    t_end = time.perf_counter()
    phase("tensor_parallel_padded", t, note=repr(TPL_NOTE),
          kernels_s=f"{t_paths - t:.1f}",
          vernier_s=f"{t_stereo - t_paths:.1f}",
          stereo_s=f"{t_end - t_stereo:.1f}", **fields,
          nvidia_smi=repr(nvidia_smi()),
          launches=json.dumps(total).replace(" ", ""))
    assert not failed, f"tensor_parallel_padded: {failed}"
    return dict(counts=total, kernels=kern)


def assert_states_equal(a, b) -> None:
    """Two TrainStates with the same step, parameters, BatchNorm
    statistics and AdamW state, bit for bit."""
    assert a.step == b.step, (a.step, b.step)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), f"state differs: {k}"
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"] and list(oa["state"]) == list(ob["state"])
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v.cpu(), ob["state"][i][k].cpu()), \
                f"optimizer state differs: {i} {k}"


def main() -> int:
    t = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    phase("device", t, name=repr(name), nvidia_smi=repr(smi),
          torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    secs = _build.build()
    phase("build", t, build_s=f"{secs:.2f}")
    # phase trained_two_stage's val split, drawn on the host meanwhile
    render = ValRender()
    for lib in _build.LIBRARIES:
        for fn, regs, spills, notes in ptxas_report(_build.build_log(lib)):
            print(f"  ptxas: {lib} {fn} registers={regs} spill_bytes={spills}"
                  + "".join(f" NOTE {n}" for n in notes))
            # the two wgmma conv kernels: no spills, no serialized wgmma;
            # K3 and K4, forward and backward: no spills
            if lib in ("conv3d_large_tap", "conv3d_weight_grad",
                       "plane_sweep_volume", "frustum_to_voxel"):
                assert spills == 0 and not notes, f"ptxas: {lib} {fn}"

    gen = torch.Generator().manual_seed(0)
    profile = "--profile" in sys.argv
    with torch.inference_mode():
        k1 = check_k1(gen, dev)
        k2 = check_k2(gen, dev)
        k3 = check_k3(gen, dev)
        k4 = check_k4(gen, dev)
        serving = check_serving(dev, profile=profile)
        check_reference(dev)
        detect = check_detect(dev, profile=profile)
        check_stereo_reference(dev)
        check_cost(dev)
    # the backward phases build autograd graphs: outside inference mode
    k1_bwd = check_k1_bwd(gen, dev)
    k2_bwd = check_k2_bwd(gen, dev)
    k5 = check_k5(gen, dev)
    check_train_reference(dev)
    train = check_train(dev, profile=profile)
    k3_bwd = check_k3_bwd(gen, dev)
    k4_bwd = check_k4_bwd(gen, dev)
    check_stereo_train_reference(dev)
    stereo_train = check_stereo_train(dev, profile=profile)
    with tempfile.TemporaryDirectory() as root:
        check_two_stage(dev, root)
        cli = check_train_cli(dev, root)["counts"]
    var = check_variants(gen, dev)["counts"]
    with tempfile.TemporaryDirectory() as root:
        world = check_synthetic_world(root)
        trk = check_track(dev, root, world)["counts"]
        demos = check_demos(dev, root)["counts"]
        par = check_parallel(dev, train)["counts"]
        tp_res = check_tensor_parallel(gen, dev)
        tp = tp_res["counts"]
        tpl = check_tensor_parallel_local(gen, dev, tp_res)["counts"]
        del tp_res
        tpp = check_tensor_parallel_padded(gen, dev)["counts"]
        rel = check_release_checkpoint(dev, root)["counts"]
        check_native_loader(render)
        tts = check_trained_two_stage(dev, root, render)["counts"]
        prof = check_profile(dev, root)["counts"]
    # the launches of the phases that drive whole paths, summed a kernel
    late = {k: var[k] + trk[k] + demos[k] + par[k] + tp[k] + tpl[k]
            + tpp[k] + rel[k] + tts[k] + prof[k] for k in KERNELS}

    kernels = [
        dict(name="stereo_voxel_sample", route="cuda",
             source="snvc_tpu_torch/csrc/stereo_voxel_sample.cu",
             replaces="snvc_tpu/ops/grid_sample_pallas.py:217",
             launches=serving["counts"]["K1"] + cli["K1"] + late["K1"],
             bound_by="bytes",
             **k1),
        dict(name="conv3d_large_tap", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:236",
             launches=serving["counts"]["K2"] + cli["K2"] + late["K2"],
             bound_by="operations", **k2),
        dict(name="plane_sweep_volume", route="cuda",
             source="snvc_tpu_torch/csrc/plane_sweep_volume.cu",
             replaces="snvc_tpu/ops/cost_volume.py:119",
             launches=detect["counts"]["K3"] + cli["K3"] + late["K3"],
             bound_by="bytes",
             **k3),
        dict(name="frustum_to_voxel", route="cuda",
             source="snvc_tpu_torch/csrc/frustum_to_voxel.cu",
             replaces="snvc_tpu/ops/frustum_pallas.py:125",
             launches=detect["counts"]["K4"] + cli["K4"] + late["K4"],
             bound_by="bytes",
             **k4),
        dict(name="stereo_voxel_sample_bwd", route="cuda",
             source="snvc_tpu_torch/csrc/stereo_voxel_sample.cu",
             replaces="snvc_tpu/ops/grid_sample_pallas.py:329",
             launches=train["counts"]["K1_bwd"] + cli["K1_bwd"]
             + late["K1_bwd"],
             bound_by="bytes", **k1_bwd),
        dict(name="conv3d_large_tap_dx", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:285",
             launches=train["counts"]["K2_dx"] + cli["K2_dx"]
             + late["K2_dx"],
             bound_by="operations", **k2_bwd["dx"]),
        dict(name="conv3d_weight_grad", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_weight_grad.cu",
             replaces="snvc_tpu/ops/conv3d_fold_pallas.py:285",
             launches=train["counts"]["K2_dw"] + cli["K2_dw"]
             + late["K2_dw"],
             bound_by="operations", **k2_bwd["dw"]),
        dict(name="conv3d_k3", route="cuda",
             source="snvc_tpu_torch/csrc/conv3d_large_tap.cu",
             replaces="snvc_tpu/ops/conv3d_pallas.py:118",
             launches=(train["counts"]["K5"] + serving["counts"]["K5"]
                       + cli["K5"] + late["K5"]), bound_by="operations",
             **k5),
        dict(name="plane_sweep_volume_bwd", route="cuda",
             source="snvc_tpu_torch/csrc/plane_sweep_volume.cu",
             replaces="snvc_tpu/ops/cost_volume.py:160",
             launches=stereo_train["counts"]["K3_bwd"] + cli["K3_bwd"]
             + late["K3_bwd"],
             bound_by="bytes", **k3_bwd),
        dict(name="frustum_to_voxel_bwd", route="cuda",
             source="snvc_tpu_torch/csrc/frustum_to_voxel.cu",
             replaces="snvc_tpu/ops/frustum_pallas.py:271",
             launches=stereo_train["counts"]["K4_bwd"] + cli["K4_bwd"]
             + late["K4_bwd"],
             bound_by="bytes", **k4_bwd),
    ]
    print(f"[total] {time.perf_counter() - T0:.2f}s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
