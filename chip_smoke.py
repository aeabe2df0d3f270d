#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py

Phases, each of which exits nonzero when it fails:
  1. device: a CUDA card must be present; print its name and power limit;
  2. build: compile every kernel source (nvcc, sm_90a) and the native
     post-processing library, all in parallel, from the sources here; each
     kernel's registers, shared memory and spills from its ptxas log;
  3. kernels: each kernel against its plain PyTorch version on the card:
     K1f at the serving shapes, in float32 and bfloat16 and on a permuted
     NCHW view; K1's backward (the self-affinity backward kernel at D = 1)
     through autograd at B=2 544x544, neighbor 8 and 4; K4f (the cross
     forward at D = 1) and its backward through autograd at the BBBC train
     shape B=2 256x256 and at an odd shape, with the teacher as the
     un-flip returns it (the student's strides, checked) and as it
     returned it before (x and y strides swapped), neighbor 4 and 8,
     float32 and bfloat16, with a zero vector, and their times on both
     teachers with L2 flushed; K2f/K2b at the five training scales and
     K3f/K3b at full scale, on the NCHW view, with a zero vector, K3b
     without db (the training steps' form) and with it, K3's times also
     on the swapped teacher; no form of K1f, K2f/K3f, K2b or K3b may
     spill registers (K1f's registers printed beside its times);
  4. fixture: the port's model on the reference golden
     (tests/fixtures/resunet2d_deep.npz) with TF32 off, and the kernel's
     affinities against the golden's circular ones outside the wrap band;
  5. serving: CVPPP serving at full width (filters 16..256, emd 16,
     seeded random weights) on synthetic 530x500 leaf images padded to
     544x544, through run_inference_2d at batch 1 and batch 4, with each
     kernel's launch count read around each run; the served affinities of
     one image against the same model run in float64 on the card;
  6. training: train() on the full-width cvppp preset, B=2, 8 steps from
     the device-resident sampler over 4 synthetic leaf images (uint8,
     padded to 544x544), validation on 2 images (writing its montage)
     and a checkpoint, with every kernel's launch count (the upsampling
     backward's, and CWg's and CXg's, one a conv of the step, CXg not for
     the two convs that read the image) read around the run; the reloaded
     checkpoint's next-step loss; the device time of one step by kernel
     (K3f, K3b: each launch of the wmse kernels in order; the step must
     run K3b without db, once) and one step's
     parameter gradients against the same step in float64
     through the plain path; then 3 steps through the host provider
     (data.device_resident False, worker processes) with the launches
     read around them;
  7. 3D kernels: K5f against its plain version at the serving tile batch
     (4 tiles of 18x160x160, C=16, on the permuted NCDHW view) and the
     training batch (B=2; also channels-last) in
     float32 and bfloat16, at two odd shapes with a zero vector, and
     through autograd (its backward kernel); its times at both batches and
     layouts with L2 flushed. The 3D training kernels, the
     self-affinity backward (K5b), the cross forward (K6f) and the cross
     backward (K6b), against their plain versions at the training shape
     (B=2, 18x160x160, C=16, NCDHW view) and two odd shapes, float32 and
     bfloat16, with a zero vector and a random cotangent; K5b also on a
     channels-last embedding, K6f and K6b (with and without db) on a
     channels-last student with three teachers: channels-last, H/W-swapped
     (what the un-flip made of a channels-last teacher before it kept its
     input's strides) and the NCDHW view, float32 and bfloat16 (the
     16-byte load paths: no main path hands channels-last); their raw
     (normalized) forms; their times with L2 flushed, the cross kernels'
     on each layout;
  8. 3D fixture: the port's UNetPNIEmbeddingDeep on the reference golden
     (tests/fixtures/unet_pni_deep.npz) with TF32 off;
  9. 3D serving: AC3/AC4 serving at full width (ac3ac4 preset, filters
     28..80, emd 16, seeded random weights) on a synthetic 20x1024x1024
     volume (the AC4 validation geometry: 338 tiles, 85 batches), through
     run_inference_3d's defaults (the dense module through the engine's
     run) with the three decoders and K5f's launch count read around the
     run; device time per tile batch, the dense module against the
     folded-BatchNorm fast graph (fast_tiled_infer), in float32 and
     bfloat16, and a profile of a few batches; K5f on each graph's
     embedding against its plain version; one batch's affinities through
     each graph against the dense module in float64; the canvas against
     the same run through the plain affinity, and the fast graph's canvas
     and forward seconds against the main path's; the decoders' time on a
     noisy label-derived canvas of the first 10x512x512;
 10. 3D training: train() on the full-width ac3ac4 preset, B=2 crops of
     18x160x160 from the device-resident sampler over a synthetic
     36x320x320 volume (through load_ac3ac4_arrays), 8 steps, validation
     with waterz on a synthetic 20x256x256 volume (cut from AC4's
     20x1024x1024) and a checkpoint, each kernel's launch count read around
     the run; the reloaded checkpoint's next-step loss; one step's peak
     device memory and device time by kernel, and the layout of the
     embedding it hands the kernels (NCDHW), the un-flipped teacher's
     strides checked equal to the student's; one step's parameter gradients
     against float64; then 3 steps through the host provider with the launches
     read around them;
 11. BBBC training: train() on the full-width bbbc039v1 preset (mask head,
     weight 1000), B=2, 8 steps from the device-resident sampler over 8
     synthetic 520x696 nuclei images, validation on 2 (AJI/F1/PQ) and a
     checkpoint, each kernel's launch count read around the run (CWg and
     CXg as in 6); the reloaded checkpoint's next-step loss; the device
     time of one step by kernel (K3f/K3b as in 6);
 12. the unfused path: 4 steps of the same preset with train.fuse_loss
     False, K1f/K1b/K4f/K4b launched 5/5/1/1 times a step; on one batch the
     unfused step's loss and parameter gradients against the fused step's;
 13. BBBC serving: run_inference_2d on 4 synthetic 520x696 images, seeded
     by the predicted mask, with the timing split and K1f's launches: once
     with the random weights' full mask (the decode's worst case), then with
     the mask head's bias moved so the nuclei's share is foreground, at
     batch 1, 4 and the server's default; one image's served affinities and
     mask logits against a float64 run;
 14. K7, K9a and K9b (one conv kernel, csrc/conv3x3.cu, through three
     wrappers) against their plain versions at the fast forward's
     direct-stage convs, an odd shape and 3 -> 16, float32 and bfloat16;
     K9b chains of 2-4 C -> C convs on a 272x272 image, the canvas exactly
     0 outside the image after every step; times with L2 flushed beside
     cuDNN's conv and the bound;
 15. K8 (csrc/s2d_block.cu) against its plain version at the cvppp model's
     five s2d blocks (the split up3 and up4 included) and two odd shapes,
     float32 and bfloat16; each block's time beside cuDNN's
     direct-resolution form of the same folded block and the bound;
 16. the fast forward: the folded-BatchNorm forward of the full-width cvppp
     model with non-trivial BatchNorm statistics, in the default forms, all
     "pallas" (5 K8 launches a forward), with the s2d input and the
     full-resolution head, against the dense module and float64; the device
     time of the dense module, the default forms and all "pallas" at B=1
     and B=4 with a profile split; run_inference_2d through the fast
     forward at B=1 and B=4 against the dense run's metrics;
 17. the device-resident samplers at the real training geometry: CVPPP's
     108 544x544 uint8 images (12 synthetic ones repeated) and AC4's
     80x1024x1024 split (phase 9's volume stacked 4 times, its border
     widening included): device MB, host and device ms a B=2 batch, device
     operations a batch, the batches' shapes, types, ranges and label ids;
     the card's batches against the CPU sampler's at the same (seed, step)
     (every CVPPP draw, and the AC3/AC4 batches with no draw on the
     device); one full-width cvppp step with the EMA view's noise and blur
     on;
 18. P, the tile copy (csrc/tile_copy.cu), against its plain version bit
     for bit: float32 and bfloat16, the (1, 544, 544, 16) embedding as
     NHWC, NCHW and (B, H, C, W), an odd shape whose bytes are no multiple
     of 16 and views with misaligned storage offsets; its time beside the
     plain version's, copy_'s and the bound, each a call of one CUDA graph
     of 96 calls over 8 inputs (three times L2); the arrangement
     probe (utils/profile_arrange.py) at B=1 and B=4 with P's launches;
 19. quality: the JAX package's three train-to-quality gates
     (tests/test_quality_gate.py, tests/test_quality_gate_bbbc3d.py), each
     through train() on the preset's own path (use_pallas, fuse_loss, the
     device-resident sampler, the EMA view and targets on the card) with
     the JAX gate's overrides, steps, seed and floors: cvppp (filters
     8..32, B=8 128x128 crops, 250 steps, SBD >= 0.55) and bbbc039v1 (the
     same, SBD >= 0.25, AJI >= 0.18) on the files JAX's synthesize writes
     at the gates' arguments (tests/fixtures/quality_2d.npz, decoded by
     cv2 where it was written), ac3ac4 (filters 4..16, B=2 18x64x64 crops
     of a synthetic 30x96x96 volume, 200 steps, mutex validation on its
     first 20 slices, affs_mse <= 0.15, mutex VOI <= 2.8: floors the JAX
     package's own gate misses on the CPU, so their misses are printed);
     each gate's readings that training moves held to the card's plain
     path within three times their spread between runs (the loss at the
     last display; for ac3ac4 also affs_mse and mutex VOI with each tile
     batch's own BatchNorm statistics); each gate's readings, and
     K1f/K2f/K2b/K3f/K3b (2D) and
     K5f/K5b/K6f/K6b (3D) launched and counted around each gate, held to
     their counts;
     tools/quality_card.py runs the same gates on the plain path and at
     the presets' full width;
 20. bf16 (model.dtype "bfloat16", model.bf16_tiled_infer): K2f, K2b, K3f
     and K3b (without db and with it) in bfloat16 against their plain
     versions at B=2 544x544, C=16, K=10 (affinities and gradients at
     8e-3, S at 1e-5 relative), timed as in 3 beside the bound at
     bfloat16 bytes, no bfloat16 form spilling; the full-width cvppp,
     bbbc039v1 and ac3ac4 presets trained 8 steps each in bfloat16 from the
     device-resident samplers (as phases 6, 10 and 11), with validation
     and a float32 checkpoint, every kernel's launches read around each
     run and held to its count, one step's device time by group, the
     bfloat16 kernels it ran, the 3D step's peak memory, and the
     first step's loss against float32's on the same weights and batch
     (2e-2); CVPPP serving in bfloat16 at B=1 and B=4 (ms/img; affinities
     within max 0.05 and mean 0.005 of float32's, the JAX package's bar)
     and through run_inference_2d; the tiled 3D predictor with
     bf16_tiled_infer (ms per batch of 4 tiles; a 20x256x256 canvas against
     float32's at the same bar); the BBBC quality gate in bfloat16 through
     the kernels, its floors held;
 21. training CLI (python -m pixel_embedded_affinity_torch.train, driven
     in-process through its main): the full-width cvppp preset with a
     YAML file (the preset and a poly schedule, warmup 2, decay to step
     6) and -o overrides on tests/fixtures/quality_2d.npz's decoded
     leaves, from the device-resident sampler: 8 steps uninterrupted, and
     4 steps, a msgpack checkpoint, and a resume to 8; every step's logged
     rate held to the schedule, steps 5-8's losses to the uninterrupted
     run's bit for bit, K2f/K2b/K3f/K3b (and K1f in validation)
     held to their counts; 3 SGD steps (losses finite); then each preset
     (cvppp, bbbc039v1 and ac3ac4 at full width) 3 steps from the host
     samplers with the targets and the EMA view built on the host, from
     arrays in memory, with validation: one host batch's targets against
     the device builders on the card (affinities and masks equal, weights
     within HOST_WEIGHT_RTOL), its loss through the kernels against the
     plain path (HOST_PLAIN_RTOL), each kernel's launches per step equal
     to the device-target path's, and data_s of the host samplers beside
     the device samplers';
 22. the model families: the full-width cvppp_resnet50 (8 steps) and
     cvppp_resnet101 (3 steps) presets trained B=2 544x544 from the device
     sampler with the discriminative term, K2f/K2b/K3f/K3b, CWg/CXg and
     the validation's K1f held to their counts, the first loss through the
     kernels against the plain path's, loss_disc finite, step times, one
     step's device time by group, peak memory; 4 images served through
     ResNet-50 at B=1 with K1f's launches; MALA (widths 12..1500) at the
     reference geometry, (1, 1, 53, 268, 268) -> (1, 16, 25, 56, 56),
     against its float64 run on the card, with its time and peak memory,
     and the small golden (tests/fixtures/unet3d_mala_small.npz);
 23. the host library: the deterministic upsampling backward
     (csrc/upsample_bwd.cu, no TPU kernel: the gather that replaces
     F.interpolate's atomic backward in the decoders; phases 6 and 10 hold
     its launches, UP_PER_STEP a step) against its plain version at the
     decoders' eight shapes in float32, bfloat16 and float64, against
     PyTorch's own backward, twice bit for bit, and timed beside both and
     its bound; the ablation losses (the cosine, distance, rescaled and
     orthogonal affinities, the discriminative, local, deep-supervision and
     superpixel losses at B=2 544x544, emd 16, the 10 CVPPP offsets; norm6
     and its EMA form at B=2 18x160x160 with the 23 mutex offsets) forward
     and backward in float32 against float64, with their ms; the decoders
     (seg_waterz, agglomerate_multi at 0.3/0.5/0.7, multicut_multi on the
     waterz fragments, LmcSuperpixel with the long-range channels;
     malis_weights on its first 10 slices) on a 20x512x512 crop of phase
     9's canvas, with seconds
     and VOI/ARAND; cluster_embeddings (DBSCAN, MeanShift) on the card over
     a 544x544 embedding of separable leaves, its clusters the leaves;
     phase 6's validation montage pixel-equal to the host's val_show of
     the same arrays; utils/flops.py's GFLOP beside measured TFLOP/s and
     the share of the float32 peak (CVPPP serving B=4, a 3D tile batch,
     both training steps); phase 10's 3D training run again from its seed,
     losses and parameters bit for bit (else the first operation that
     differs);
 24. data parallelism (torch.distributed): the full-width cvppp (B=2
     544x544), ac3ac4 (B=2 18x160x160) and bbbc039v1 (B=2 256x256, mask
     head) train steps, 2 steps each from the same seeded weights and
     global batches of the resident samplers, on two ranks sharing cuda:0
     over gloo (NCCL refuses two ranks on one card), each rank training on
     its half of the batch with the EMA view drawn on the whole, against
     the single process's step on the same global batch from the same
     state (rank 0 runs it on a copy before each step), float32 with TF32
     off: the loss within DP_LOSS_RTOL; step 1's all-reduced gradients
     against a float64 step (the plain path) no farther than
     DP_GRAD_EXCESS times the single process's float32 gradients are, plus
     DP_GRAD_RTOL (each tensor, relative to its norm), their distance from
     the single process's printed; the parameters and BatchNorm buffers
     bit-equal across the ranks and within tests/test_dp_parity.py's TOL of
     the single process, each rank's kernel launches and step times (a
     record: the ranks share the card); the dense 3D module served tiled
     over a 20x512x512 crop of phase 9's volume, each tile batch split over
     the two ranks, against the single process's canvas (DP_CANVAS_ATOL);
     the training CLI with --distributed under torchrun's environment for
     one process (NCCL at world size 1) on the ac3ac4 preset, 4 steps from
     the device sampler, its losses and parameters bit-equal to the run
     without --distributed and its checkpoint written once; then on one
     NCCL group of world size 1 that the script joins: the capture probe
     (dist.all_reduce by SUM and by PREMUL_SUM(0.5) of the flat gradient's
     size and of a BatchNorm's [sum x, sum x^2, n] vector, float32 and
     float64, captured in a CUDA graph and replayed 20 times on new
     inputs, each replay bit-equal to the eager all-reduces and half its
     input, which only the captured PREMUL_SUM can make (over one rank
     NCCL issues no work for an in-place SUM); the device events of a
     profiled replay printed; capture seconds and replay ms) and the same CLI run at train.steps_per_call=4 (one
     meshed step captured on NCCL and replayed), its parameters bit-equal
     to the run without --distributed at steps_per_call=4 and to the
     steps_per_call=1 run, its logged loss the mean of that run's four;
     then 6 more replays of its graph, timed and profiled, the kernels the
     profiler saw them launch held against the capture's counts; where
     the host has two cards, the cvppp step on NCCL over both, eager and
     as one graphed call of 4 steps (the losses within SPC_STEP_RTOL), its
     replays profiled alike, else "one card here";
 25. int8 serving, serving artifacts, DCP checkpoints:
     I8c and I8q (csrc/conv_i8.cu, no TPU site) at every call of the
     full-width cvppp int8 fast forward (INT8_DEFAULT_SITES; B=1 and B=4,
     float32 and bfloat16 compute) against their plain versions, the int32
     accumulators exact and the outputs and codes equal to the bit; the
     B=1 forward's calls timed by CUDA graph replay, L2 flushed, beside
     their bounds (int8 at 1,979 TOPS against bytes), each I8c call's
     tiling (conv_plan), the plain versions and cuDNN's bf16 and float32
     convs and torch._int_mm on the im2col, and for I8q
     torch.quantize_per_tensor (yardsticks the port never calls); I8c's
     wgmma and TMA instructions in the SASS, registers and spills; the
     floor of one timed call (a one-element kernel, timed alike); a
     profile of one graphed B=4 forward + affinity by kernel group, int8
     beside bf16; run_inference_2d with
     model.int8_infer at B=1 and B=4, each kernel's count set to 0 just
     before and read just after, the int8 embedding and affinities against
     float32's at JAX's bars (cosine > 0.99, max < 0.05, mean < 0.005), ms
     per image beside the float32 and bf16 fast forwards; the percentile
     calibration (INT8_CALIB_PCT) on 8 full-width images, each site's
     kthvalue quantile against a float64 sort within QUANTILE_RTOL; the
     544x544 serving artifact exported on the card (torch.export), loaded
     and run at B=1 and B=4 within EXPORT_ATOL of the serving path, its
     bytes and times; the full-width CVPPP train state through
     save_checkpoint_dcp and back, bit for bit;
 26. train.steps_per_call (the training step as a CUDA graph, replayed
     once a step): AMSGrad and SGD on the full-width cvppp parameters, 5
     updates with the step's scalars read from the device tensor against
     the same updates written with floats, bit for bit; the full-width
     cvppp, bbbc039v1 (fused, and unfused), ac3ac4 and cvppp_resnet50
     presets, B=2, trained 8 steps eagerly and 8 at steps_per_call=4 from
     one seed on the device samplers, float32 and bfloat16: the two runs'
     losses and parameters, held bit for bit where the eager step is
     bit-reproducible (3D, the 2D steps in float32, whose convs' backward
     is CWg and CXg or, for the ResNet's strided and 7x7 convs, cuDNN's
     deterministic algorithms, and the ResUNet's in bfloat16); warm
     median data_s and step_s, capture seconds and peak memory of both;
     then steady steps of each path by CUDA events and a profile of each
     (device busy time, idle share), in which each kernel's launches that
     the profiler saw equal the wrappers' counts plus the captured graph's
     launches a replay; then one step from one state, eagerly on a copy and
     by a replay, held bit for bit where the eager step is bit-reproducible,
     else within SPC_STEP_RTOL, and a replay with the previous step's
     scalars (the planted fault) off by more; the training CLI on ac3ac4 at
     steps_per_call=4: 4 steps, a checkpoint, a resume to 8, bit-equal to
     the uninterrupted graphed run;
 27. CWg and CXg (csrc/conv_grad.cu) at every conv they serve in one
     full-width float32 training step of cvppp, bbbc039v1, cvppp_resnet50
     and cvppp_resnet101, on the step's own inputs and output gradients
     (recorded_convs): each call 3 times bit for bit and against the plain
     version in float64 within GRAD_RTOL; which convs' cuDNN default
     gradients vary; each conv shape's time by CUDA graph replay with L2
     flushed beside cuDNN's default and deterministic backward, the
     float64 plain version, and for CXg at 3x3 its NHWC form (the permutes
     around K7); the sums over each step;
 28. one JSON line listing each kernel: launches (phase 21's also apart,
     cli_launches, phase 24's, dp_launches, and phase 26's, spc_launches),
     error, times, bound, and
     how the times were taken (CUDA graph replay; for the affinity kernels
     CUDA events around the eager call beside; K2f/K2b/K3f/K3b with their
     bfloat16 forms' bf16_* fields and launches), the upsampling backward,
     CWg and CXg (summed over a cvppp step's convs, bbbc039v1's beside),
     then I8c and I8q;
 29. the last line: {"ok": true, "device": {...}}.
It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from pixel_embedded_affinity_torch.utils.flops import H100_PEAKS

# the H100 SXM data sheet's rates (utils/flops.py)
HBM_BYTES_PER_S = H100_PEAKS["hbm"]
F32_FLOPS_PER_S = H100_PEAKS["f32"]  # float32 outside the tensor cores
SEED = 0
REPO = os.path.dirname(os.path.abspath(__file__))
F32_ATOL = 1e-5
BF16_ATOL = 8e-3  # bf16 output rounding is ~2^-8 at |a| <= 1
# bf16 gradients against the plain version on the same bf16 inputs, both
# rounded to bf16 at the end: 2^-8 of the largest, twice over
BF16_GRAD_RTOL = 8e-3
FIXTURE_TOL = dict(atol=2e-4, rtol=1e-3)
AFF_ATOL = 1e-4  # served f32 affinities vs a float64 run, as the CPU parity tests hold them
K1_REPLACES = "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:120"
K1_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity2d.cu"
WMSE_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity_wmse2d.cu"
WMSE_REPLACES = {
    "K2f": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:822",
    "K2b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:907",
    "K3f": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:1009",
    "K3b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:1096",
}
# the CUDA kernels of K2f/K3f (one) and K2b/K3b: wmse_bwd_kernel<T, kSelf,
# kDb>, K2b <T, true, false>, K3b without db (the training steps') <T,
# false, false>, with db <T, false, true>; T float or __nv_bfloat16
WMSE_KERNELS = ("wmse_fwd_kernel", "wmse_bwd_kernel")
STORAGE = {"float32": "float", "bfloat16": "__nv_bfloat16"}
WMSE_NAMES = {"K2f": "affinity_wmse2d_fwd", "K2b": "affinity_wmse2d_bwd",
              "K3f": "cross_affinity_wmse2d_fwd", "K3b": "cross_affinity_wmse2d_bwd"}
# K2/K3 against their plain versions: affinities at F32_ATOL; the sums S
# relative (each adds ~B*H*W f32 terms in another order); gradients
# relative to the largest one, the zero vector's pixel (whose gradient is
# the others' times 1e12, as the normalisation's VJP gives it) apart
S_RTOL = 1e-5
GRAD_RTOL = 1e-5
# the training shapes at B=2, C=16: (side, offsets) of the five scales
TRAIN_SCALES = [(544, 10), (272, 8), (136, 6), (68, 4), (34, 2)]
TRAIN_STEPS = 8
# the upsampling backward (csrc/upsample_bwd.cu) a training step: the
# student's four decoder upsamplings (2D and 3D); the teacher takes no gradient
UP_PER_STEP = 4
# steps of the short run through the host provider (data.device_resident
# False) after each of phases 6 and 10
PROVIDER_STEPS = 3
# data_s of the host provider that fed phases 6 and 10 before the device-
# resident sampler (PERF.md section 5), printed beside the sampler's
HOST_DATA_MS = {"cvppp": 8.04, "ac3ac4": 4.25}
# one full-width step's parameter gradients against the plain path in
# float64, relative to each tensor's largest gradient. The plain float32
# path is itself up to ~2e-2 off at this size: float32 decides a few
# hundred ReLU signs and max-pool argmaxes otherwise than float64 (values
# within rounding of 0 or of each other), and each routes one element's
# gradient elsewhere; with float64's choices replayed, float32 is within
# 1e-4 (tools/grad_precision.py, PERF.md). So the kernel path is held to
# 0.1 overall and, tensor by tensor, to KERNEL_EXCESS times the plain
# float32 path's error + 1e-4: the kernels add no error of their own. The
# conv biases in front of train-mode BatchNorm have a true gradient of 0
# and are held apart.
F64_GRAD_RTOL = 0.1
KERNEL_EXCESS = 1.5
BIAS_BEFORE_BN = re.compile(r"(conv\.[03]|project\.0|binary_seg\.0)\.bias$")
K5_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity3d.cu"
K5_REPLACES = "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:543"
K5_F32_ATOL = 1e-6
# the reference golden's outputs reach 255; tighter than the JAX test's
# atol 1.5e-3 / rtol 1e-2 for the same golden
FIXTURE3D_TOL = dict(atol=1e-3, rtol=1e-4)
# the canvas through K5f against the same run through the plain affinity:
# the two differ by f32 rounding of the dot, blended
CANVAS_ATOL = 1e-5
# the fast graph's canvas against the dense module's: float32 sums folded
# and re-associated (the CPU tests' bound, tests/test_torch_fast_forward3d.py)
FAST_CANVAS_ATOL = 1e-4
# the AC4 validation volume: 20 slices of 1024x1024, padded (4, 48, 48) to
# 28x1120x1120, a (2, 13, 13) grid of 18x160x160 tiles in batches of 4
VOLUME_3D = (20, 1024, 1024)
VOLUME_CELLS = 300
# the label-derived canvas the decoders run on after 3D serving: the first
# slices and y, x of the volume, cut in depth from 20 slices to half the
# decoders' host time
LABELS_CANVAS = (10, 512, 512)
TILES_3D = 338
K5_LAUNCHES = 85
# 3D training: B=2 crops of 18x160x160 from a synthetic 36x320x320 volume;
# validation on a synthetic 20x256x256 one (AC4's is 20x1024x1024)
TRAIN3D_VOLUME, TRAIN3D_CELLS = (36, 320, 320), 80
VALID3D_VOLUME, VALID3D_CELLS = (20, 256, 256), 30
# the 1x1x1 convs of the up-paths add to the skip in front of BatchNorm
BIAS_BEFORE_BN_3D = re.compile(r"^up\d\.1\.bias$")
GRAD_SOURCE = "pixel_embedded_affinity_torch/csrc/affinity_grad.cu"
GRAD_REPLACES = {"K5b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:255",
                 "K6f": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:692",
                 "K6b": "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:431"}
GRAD_NAMES = {"K5b": "affinity_bwd", "K6f": "cross_affinity_fwd", "K6b": "cross_affinity_bwd"}
# K4f: the cross forward of GRAD_SOURCE at D = 1
K4F_REPLACES = "pixel_embedded_affinity_tpu/ops/emb2aff_pallas.py:340"
# K7, K9a and K9b: one conv kernel, three wrappers; K8: the s2d residual block
CONV_SOURCE = "pixel_embedded_affinity_torch/csrc/conv3x3.cu"
CONV_REPLACES = {"K7": "pixel_embedded_affinity_tpu/ops/conv3x3_pallas.py:106",
                 "K9a": "pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py:178",
                 "K9b": "pixel_embedded_affinity_tpu/ops/conv3x3_blocked.py:309"}
CONV_NAMES = {"K7": "conv3x3_fused", "K9a": "conv3x3_blocked", "K9b": "conv3x3_blocked_flat"}
K8_SOURCE = "pixel_embedded_affinity_torch/csrc/s2d_block.cu"
K8_REPLACES = "pixel_embedded_affinity_tpu/ops/s2d_block_pallas.py:210"
# the conv kernels against their plain versions, relative to the largest
# output: float32 sums of up to 9 x 768 products in another order; bfloat16
# outputs (and K8's bfloat16 y1) rounded to 2^-8
CONV_F32_RTOL = 1e-5
CONV_BF16_RTOL = 8e-3
BF16_FLOPS_PER_S = H100_PEAKS["bf16"]  # dense bf16 tensor cores
# K7/K9 and K8 run float32 as three TF32 passes (hi*hi + hi*lo + lo*hi) on
# the tensor cores: the dense TF32 rate over 3
TF32X3_FLOPS_PER_S = H100_PEAKS["tf32"] / 3
# K7/K9a at the fast forward's direct-stage convs (B=1; conv1 and project
# fused on Cout) and a few more: (B, H, W, Cin, Cout, relu)
K7_SHAPES = [(1, 136, 136, 64, 256, False), (1, 136, 136, 128, 128, True),
             (1, 68, 68, 128, 512, False), (1, 68, 68, 256, 256, True),
             (1, 68, 68, 256, 512, False), (1, 136, 136, 384, 256, False),
             (2, 37, 53, 48, 40, True), (1, 544, 544, 3, 16, True)]
# K9b chains on a 272x272 canvas image (the s2d stage's size): (C, k)
K9B_CHAINS = [(16, 4), (32, 3), (64, 2), (128, 3)]
# K8 at the cvppp model's five s2d stages, 544x544, B=1: (stage, B, s2d H,
# s2d W, direct input channels of each part, c1 = cp = c2), and two odd
# shapes with tile remainders (the kernel's tile is 6 x 14)
K8_STAGES = [("inconv", 1, 272, 272, (3,), 16), ("down1", 1, 272, 272, (16,), 32),
             ("down2", 1, 136, 136, (32,), 64), ("up3", 1, 136, 136, (128, 64), 64),
             ("up4", 1, 272, 272, (64, 32), 32)]
K8_ODD = [("odd split", 2, 37, 53, (8, 8), 16), ("odd", 1, 41, 29, (24,), 32)]
# BBBC039: the training set, 8 synthetic images at the dataset's 520x696;
# validation and serving at the same geometry
BBBC_SHAPE = (520, 696)
BBBC_TRAIN_IMAGES, BBBC_VALID_IMAGES, BBBC_SERVE_IMAGES = 8, 2, 4
# the device-resident samplers at the real training sets' sizes: CVPPP A1's
# 108 training images (128 less the 20 of valid_set local_20_1), made of
# 12 synthetic ones repeated, and AC4's first 80 slices of 1024x1024
CVPPP_TRAIN_IMAGES, CVPPP_DISTINCT = 108, 12
AC4_TRAIN_SLICES = 80
# P, the tile copy of the arrangement probe
P_SOURCE = "pixel_embedded_affinity_torch/csrc/tile_copy.cu"
P_REPLACES = "docs/profile_b1_arrange.py:83"
UNFUSED_STEPS = 4
# the unfused step against the fused one on one batch: the same function,
# the loss-fused kernels summing in another order than K1/K4 and the
# criterion (the conv biases in front of BatchNorm, whose true gradient is
# 0, relative to the largest gradient of all); cuDNN's run-to-run spread is
# measured beside
UNFUSED_LOSS_RTOL = 1e-5
UNFUSED_GRAD_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def timed_ms(fn, n: int = 20, flush_bytes: int = 0) -> float:
    """Median device time of fn() in ms, by CUDA events around each call.
    With ``flush_bytes``, a buffer that size is rewritten before each call
    so the call starts with its inputs out of L2."""
    import torch

    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def affinity_bound(shape, k: int, itemsize: int):
    """Least time for K1 or K5 on a (..., C) embedding with K output
    channels: each input read and each output written once over HBM, vs
    normalising every pixel or voxel once (3C flops) and one C-dot per
    channel (2C flops) at the float32 rate."""
    c = shape[-1]
    n = int(np.prod(shape[:-1]))
    nbytes = n * (c + k) * itemsize
    flops = n * (3 * c + 2 * c * k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaf_pairs(n: int, h: int, w: int, seed: int):
    """CVPPP-like (image, label) pairs: ellipse leaves around the image
    centre, RGB float32 in [0, 1], unpadded, as the dataset's PNGs read."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    pairs = []
    for _ in range(n):
        label = np.zeros((h, w), np.int32)
        m = min(h, w)
        for leaf in range(1, int(rng.integers(6, 14)) + 1):
            ang, dist = rng.uniform(0, 2 * np.pi), rng.uniform(m / 12, m / 2.6)
            cy, cx = h / 2 + dist * np.sin(ang), w / 2 + dist * np.cos(ang)
            ay, ax = rng.uniform(m / 20, m / 7), rng.uniform(m / 40, m / 12)
            rot = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = dy * np.cos(rot) + dx * np.sin(rot)
            v = -dy * np.sin(rot) + dx * np.cos(rot)
            label[(u / ay) ** 2 + (v / ax) ** 2 <= 1] = leaf
        img = rng.normal(0.1, 0.03, (h, w, 3)).astype(np.float32)
        img[label > 0] = (0.15, rng.uniform(0.4, 0.8), 0.1)
        img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)
        pairs.append((img, label))
    return pairs


def synthetic_leaves(n: int, h: int, w: int, seed: int):
    """:func:`leaf_pairs` as served samples: reflect-padded and
    ImageNet-normalised as the data pipeline does; labels zero-padded."""
    from pixel_embedded_affinity_torch.data.cvppp import PAD, normalize_imagenet

    return [{"image": np.ascontiguousarray(normalize_imagenet(
                np.pad(img, PAD + ((0, 0),), mode="reflect"))),
             "seg": np.pad(label, PAD, mode="constant"), "name": f"plant{i:03d}"}
            for i, (img, label) in enumerate(leaf_pairs(n, h, w, seed))]


def phase_build() -> float:
    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import (
        conv3x3_cuda, conv_grad_cuda, conv_i8_cuda, emb2aff3d_cuda, emb2aff_cuda,
        emb2aff_wmse_cuda, s2d_block_cuda, tile_copy_cuda, upsample_cuda)
    from pixel_embedded_affinity_torch.postproc import _native

    sources = [emb2aff_cuda.SOURCE, emb2aff_wmse_cuda.SOURCE, emb2aff3d_cuda.SOURCE,
               emb2aff3d_cuda.GRAD_SOURCE, conv3x3_cuda.SOURCE, s2d_block_cuda.SOURCE,
               tile_copy_cuda.SOURCE, upsample_cuda.SOURCE, conv_i8_cuda.SOURCE,
               conv_grad_cuda.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        jobs = [pool.submit(cuda_build.build, src) for src in sources]
        jobs.append(pool.submit(_native.build))
        paths = [j.result() for j in jobs]
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.2f} s: {paths}")
    for src in sources:
        ptxas_report(src)
    return secs


def no_spills(source: str) -> dict:
    """Fail unless ptxas spilled nothing in every kernel of ``csrc/<source>``
    (phase 2 printed them); returns {kernel: registers}."""
    info = ptxas_info(source)
    regs = {}
    for name, nice in zip(info, demangled(info)):
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info[name])
        check(spills is not None and spills.groups() == ("0", "0"),
              f"{nice[:60]}: ptxas {info[name]}")
        used = re.search(r"Used (\d+) registers", info[name])
        regs[nice] = int(used.group(1)) if used else None
    return regs


def phase_kernels(main_embedding) -> dict:
    """K1 against its plain version on the card; returns its errors/times."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        affinity_2d_plain, fused_affinity_2d, multi_offset)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((1, 544, 544, 16), 4), ((8, 544, 544, 16), 4),
             ((1, 530, 500, 16), 4), ((2, 96, 80, 16), 8)]
    max_err = 0.0
    for shape, neighbor in cases:
        offsets = multi_offset([1, 3, 5, 9, 27], neighbor)
        e = torch.randn(shape, generator=gen, device="cuda")
        e[0, 3, 5] = 0.0  # a zero vector must give zero affinities
        got = fused_affinity_2d(e, offsets)
        ref = affinity_2d_plain(e, offsets)
        nchw = e.permute(0, 3, 1, 2).contiguous()
        got_view = fused_affinity_2d(nchw.permute(0, 2, 3, 1), offsets)
        eb = e.to(torch.bfloat16)
        got_b = fused_affinity_2d(eb, offsets)
        ref_b = affinity_2d_plain(eb, offsets)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err_view = (got_view - ref).abs().max().item()
        err_b = (got_b.float() - ref_b.float()).abs().max().item()
        print(f"[kernels] K1 {shape} neighbor {neighbor}: f32 {err:.3e}, "
              f"NCHW view {err_view:.3e}, bf16 {err_b:.3e}")
        check(got.shape == (shape[0], len(offsets)) + shape[1:3], "K1 shape")
        check(got_b.dtype == torch.bfloat16, "K1 bf16 output dtype")
        check(bool((got[0, :, 3, 5] == 0).all()), "K1 nonzero affinity at a zero vector")
        check(err <= F32_ATOL and err_view <= F32_ATOL, f"K1 f32 error {err}, {err_view}")
        check(err_b <= BF16_ATOL, f"K1 bf16 error {err_b}")
        max_err = max(max_err, err, err_view)

    # the serving path's own input: the full-width model's embedding, as
    # the NCHW view the server passes
    offsets = multi_offset([1, 3, 5, 9, 27], 4)
    view = main_embedding.permute(0, 2, 3, 1)
    err = (fused_affinity_2d(view, offsets)
           - affinity_2d_plain(view, offsets)).abs().max().item()
    print(f"[kernels] K1 on the main path's embedding {tuple(view.shape)}: {err:.3e}")
    check(err <= F32_ATOL, f"K1 error on the main path's embedding {err}")
    max_err = max(max_err, err)

    # every form (f32/bf16 x C 8/16) spills nothing; its registers beside
    # the times
    regs = no_spills(K1_SOURCE)
    print(f"[kernels] K1 registers (ptxas, no spills): {json.dumps(regs)}")
    f32_regs = next((r for k, r in regs.items() if "<float, 16>" in k), None)

    # times with L2 flushed before each call; "view" is the main path's
    # layout (the model's NCHW output permuted to (B, H, W, C), no copy),
    # "nhwc" a contiguous channels-last tensor; the kernel's by CUDA graph
    # replay, "view_event" by CUDA events around the eager call
    times = {}
    flush = 64 << 20  # beyond the 50 MB L2
    for b in (1, 4, 8):
        view = torch.randn((b, 16, 544, 544), generator=gen,
                           device="cuda").permute(0, 2, 3, 1)
        nhwc = view.contiguous()
        view_b, nhwc_b = view.to(torch.bfloat16), nhwc.to(torch.bfloat16)
        t = {name: graph_ms(lambda: fused_affinity_2d(x, offsets), flush_bytes=flush)
             for name, x in [("view", view), ("nhwc", nhwc), ("bf16_view", view_b),
                             ("bf16_nhwc", nhwc_b)]}
        t["view_event"] = timed_ms(lambda: fused_affinity_2d(view, offsets), flush_bytes=flush)
        t["plain_view"] = timed_ms(lambda: affinity_2d_plain(view, offsets), flush_bytes=flush)
        t["bound_ms"], t["bound_by"] = affinity_bound(view.shape, len(offsets), 4)
        t["bf16_bound_ms"] = affinity_bound(view.shape, len(offsets), 2)[0]
        times[b] = t
        print(f"[kernels] K1 time B={b} 544x544 C=16 K=10 (ms, L2 flushed, median of 20; "
              f"the kernel by CUDA graph replay, view_event and plain by CUDA events; "
              f"{f32_regs} registers at f32, C=16): "
              f"{json.dumps(t)}")
    return {"max_abs_err": max_err, "times": times}


def phase_fixture():
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.models import ResidualUNet2DDeep
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d

    data = np.load(os.path.join(REPO, "tests", "fixtures", "resunet2d_deep.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = ResidualUNet2DDeep(3, 2, (8, 12, 16, 24, 32), 8)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.no_grad(), float32_convs():
        outs = model(torch.from_numpy(data["input"]).cuda())
    for i, o in enumerate(outs):
        ref = data[f"out/{i}"]
        got = o.cpu().numpy()
        err = float(np.abs(got - ref).max())
        check(got.shape == ref.shape and np.isfinite(got).all(), f"fixture out/{i} shape")
        check(np.allclose(got, ref, **FIXTURE_TOL), f"fixture out/{i} max error {err}")
        print(f"[fixture] out/{i} {got.shape}: max error {err:.3e}")
    offsets = data["offsets"].tolist()
    affs = fused_affinity_2d(outs[4].permute(0, 2, 3, 1), offsets).cpu().numpy()
    golden = data["affs"]
    h, w = affs.shape[-2:]
    for k, (oy, ox) in enumerate(offsets):
        inside = np.ones((h, w), bool)
        inside[:max(-oy, 0)] = False
        inside[:, :max(-ox, 0)] = False
        ok = np.allclose(affs[0, k][inside], golden[0, k][inside], **FIXTURE_TOL)
        check(ok and np.all(affs[0, k][~inside] == 0), f"fixture affs channel {k}")
    err = max(float(np.abs(affs[0, k] - golden[0, k])[
        max(-oy, 0):, max(-ox, 0):].max()) for k, (oy, ox) in enumerate(offsets))
    print(f"[fixture] K1 affinities vs the reference's circular ones, outside "
          f"the wrap band: max error {err:.3e}")


def serving_setup():
    """The cvppp config, seeded full-width weights and 4 synthetic images."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.infer import build_model

    cfg = load_config("cvppp")
    torch.manual_seed(SEED)
    sd = build_model(cfg, device="cpu").state_dict()
    samples = synthetic_leaves(4, 530, 500, SEED)
    check(samples[0]["image"].shape == (544, 544, 3), "padded image shape")
    return cfg, sd, samples


def main_path_embedding(cfg, sd, samples):
    """The full-width model's embedding of the first image, (1, 16, H, W)."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model

    model = build_model(cfg, sd, device="cuda")
    x = torch.from_numpy(samples[0]["image"][None]).cuda().permute(0, 3, 1, 2)
    with torch.no_grad():
        return model(x.contiguous())[4]


def phase_main_path(cfg, sd, samples) -> dict:
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import (
        build_model, forward_affinities, run_inference_2d)
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset

    print(f"[main] cvppp ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, {len(samples)} images 530x500 -> 544x544, convs "
          f"in float32 (TF32 off)")
    launches = {}
    for bs in (1, 4):
        # warm-up pass (cuDNN picks its algorithms at the first call of a
        # shape), so the timed pass below gives the steady-state split
        run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda")
        timing = {}
        fused_affinity_2d.launches = 0
        per, agg = run_inference_2d(cfg, sd, samples, timing=timing,
                                    batch_size=bs, device="cuda")
        launches[bs] = fused_affinity_2d.launches
        expected = -(-len(samples) // bs)
        print(f"[main] B={bs}: K1 launches {launches[bs]} (expected {expected}); "
              f"timing {json.dumps(timing)}; metrics {json.dumps(agg)}")
        parts = {k: timing[k] for k in ("setup_s", "forward_s", "decode_s", "metrics_s")}
        parts["rest_s"] = timing["total_s"] - sum(parts.values())
        per_img = {k: v / len(samples) * 1e3 for k, v in parts.items()}
        print(f"[main] B={bs} ms/img: wall {timing['total_s'] / len(samples) * 1e3:.4f} = "
              + " + ".join(f"{k[:-2]} {v:.4f}" for k, v in per_img.items()))
        check(launches[bs] == expected, f"K1 launched {launches[bs]} times at B={bs}")
        check(len(per) == len(samples), "one result per image")
        for m in per:
            check(all(np.isfinite(v) for v in m.values()), f"non-finite metric {m}")
            check(m["SBD"] > 0, f"empty segmentation {m}")

    model = build_model(cfg, sd, device="cuda")
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    x_all = torch.from_numpy(np.stack([s["image"] for s in samples])).cuda()
    x_all = x_all.permute(0, 3, 1, 2).contiguous()
    for bs in (1, 4):
        x = x_all[:bs]
        ms = timed_ms(lambda: forward_affinities(model, x, offsets), n=20)
        with torch.no_grad(), float32_convs():
            fwd_ms = timed_ms(lambda: model(x), n=20)
        with torch.no_grad():
            tf32_ms = timed_ms(tf32_convs(lambda: model(x)), n=20)
        print(f"[main] forward+affinity B={bs}: {ms / bs:.4f} ms/img "
              f"(forward alone {fwd_ms / bs:.4f} ms/img; with TF32 convs "
              f"{tf32_ms / bs:.4f}), warm median of 20, {card_line()}")
        affs = forward_affinities(model, x, offsets)
        check(affs.shape == (bs, 10, 544, 544) and bool(torch.isfinite(affs).all()),
              "main-path affinities")
        device_breakdown(lambda: forward_affinities(model, x, offsets), bs,
                         ours=("affinity2d_fwd_kernel",), require=("affinity2d_fwd_kernel",))
    served_precision(cfg, sd, model, x_all[:1], offsets)
    return launches


def tf32_convs(fn):
    """fn run with cuDNN's TF32 allowed, the PyTorch default the server
    turns off."""
    import torch

    def run():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return run


def served_precision(cfg, sd, model, x, offsets):
    """The served affinities of one full-width image against the same
    weights run in float64 on the card; a TF32 run's gap is printed beside."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model, forward_affinities
    from pixel_embedded_affinity_torch.ops import (
        embedding_to_affinity_2d, fused_affinity_2d)

    served = forward_affinities(model, x, offsets)
    with torch.no_grad():
        emb64 = build_model(cfg, sd, device="cuda").double()(x.double())[4]
        ref = embedding_to_affinity_2d(emb64.permute(0, 2, 3, 1), offsets,
                                       padding="valid").relu()
        emb_tf32 = tf32_convs(lambda: model(x)[4])()
        tf32 = fused_affinity_2d(emb_tf32.permute(0, 2, 3, 1), offsets).relu()
    err = (served.double() - ref).abs().max().item()
    err_tf32 = (tf32.double() - ref).abs().max().item()
    print(f"[main] served affinities vs float64, full width, one image: max "
          f"error {err:.3e} (a TF32 run: {err_tf32:.3e})")
    check(err <= AFF_ATOL, f"served affinities off the float64 run by {err}")


def device_breakdown(fn, images: int, iters: int = 5, label: str | None = None,
                     unit: str = "img", ours: tuple = (), split: tuple = (),
                     require: tuple = (), in_order: tuple = ()):
    """Device time of fn() by kernel (torch.profiler), per image (or per
    ``unit``, ``images`` of them per call), beside the host-clock wall time
    of the same calls; also the rows whose kernel name holds one of
    ``ours``, and with ``split`` ((group, name parts),
    ...) the time by group: a kernel goes to the first group one of whose
    parts its lower-cased name holds, else to "other". Fails unless each
    kernel named in ``require`` has device time (the profiler can drop
    records). For each name part in ``in_order``, the device time of each
    launch of a kernel whose name holds it, in launch order, medians over
    the calls (one kernel that serves several calls of the path, told apart
    by their order). Returns the rows (ms a unit, launches a call, kernel
    name), longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        t_us = getattr(ev, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(ev, "self_cuda_time_total", 0)
        if t_us > 0:
            rows.append((t_us / 1e3 / iters / images, ev.count // iters, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    label = label or f"B={images}"
    missing = [o for o in require if not any(o in r[2] for r in rows)]
    check(not missing, f"{label}: the profiler recorded no device time for {missing}")
    if busy == 0:
        print(f"[profile] {label}: the profiler recorded no device time")
        return rows
    per_img_wall = wall_ms / iters / images
    print(f"[profile] {label}: device time {busy:.4f} ms/{unit} in "
          f"{per_img_wall:.4f} ms/{unit} wall, {sum(r[1] for r in rows) / images:.1f} "
          f"kernels a {unit}; top kernels:")
    for ms, calls, name in rows[:12]:
        print(f"[profile]   {ms:.4f} ms/{unit}  {ms / busy:6.1%}  x{calls}  {name[:110]}")
    if split:
        groups: dict = {}
        for ms, calls, name in rows:
            key = next((g for g, parts in split if any(p in name.lower() for p in parts)), "other")
            t, n = groups.get(key, (0.0, 0))
            groups[key] = (t + ms, n + calls)
        print(f"[profile] {label} by group: " + "; ".join(
            f"{g} {t:.4f} ms/{unit} {t / busy:.1%} x{n / images:.0f}"
            for g, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    for part in in_order:
        evs = sorted((e for e in prof.events()
                      if part in e.name and str(getattr(e, "device_type", "")).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        if not evs or len(evs) % iters:
            print(f"[profile] {label}: {len(evs)} launches of {part} recorded in {iters} calls")
            continue
        per = np.asarray([e.time_range.elapsed_us() / 1e3 for e in evs]).reshape(iters, -1)
        print(f"[profile] {label}: {part} launches in order, ms (median of {iters} calls): "
              f"{[round(float(v), 4) for v in np.median(per, axis=0)]}")
    mine = [r for r in rows if any(o in r[2] for o in ours)]
    if mine:
        tot = sum(r[0] for r in mine)
        print(f"[profile] {label}: the port's kernels {tot:.4f} ms/{unit}, {tot / busy:.2%}:")
        for ms, calls, name in mine:
            print(f"[profile]   {ms:.4f} ms/{unit}  {ms / busy:6.2%}  x{calls}  {name[:110]}")
    return rows


def phase_k1_grad() -> float:
    """K1's backward (the self-affinity backward kernel at D = 1) against
    its plain version through autograd, at B=2 544x544 with neighbor=8 (and
    4), a zero vector and a random cotangent over the whole output, the
    band where the neighbour is outside included; returns the largest
    absolute gradient error."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        affinity_2d_plain, affinity_bwd, fused_affinity_2d, multi_offset)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    zero_px = (1, 3, 5)
    max_err = 0.0
    for neighbor in (8, 4):
        offsets = multi_offset([1, 3, 5, 9, 27], neighbor)
        nchw = torch.randn((2, 16, 544, 544), generator=gen, device="cuda")
        nchw[zero_px[0], :, zero_px[1], zero_px[2]] = 0.0
        x = nchw.requires_grad_()
        g = torch.randn((2, len(offsets), 544, 544), generator=gen, device="cuda")
        before = affinity_bwd.launches
        (got,) = torch.autograd.grad(fused_affinity_2d(x.permute(0, 2, 3, 1), offsets), x, g)
        check(affinity_bwd.launches == before + 1, "K1's backward did not launch its kernel")
        (ref,) = torch.autograd.grad(affinity_2d_plain(x.permute(0, 2, 3, 1), offsets), x, g)
        torch.cuda.synchronize()
        rest, at_zero, err = _grad_err(got.permute(0, 2, 3, 1), ref.permute(0, 2, 3, 1), zero_px)
        print(f"[kernels] K1 backward B=2 544x544 C=16 neighbor {neighbor}: gradient rel "
              f"(rest, zero-vector pixel, abs) ({rest:.3e}, {at_zero:.3e}, {err:.3e})")
        check(got.is_contiguous(), "K1's gradient is not in the NCHW layout")
        check(rest <= GRAD_RTOL and at_zero <= GRAD_RTOL, f"K1 gradient error {rest}, {at_zero}")
        max_err = max(max_err, err)
    return max_err


def teacher_view(nchw):
    """The un-flipped EMA teacher's embedding as the train step hands it to
    K4f: the model's NCHW output permuted to (B, H, W, C) and passed
    through the un-flip, which keeps the student's strides whatever the
    rules (x stride 1)."""
    import torch

    from pixel_embedded_affinity_torch.data.consistency import convert_consistency_flip

    student = nchw.permute(0, 2, 3, 1)
    rules = torch.tensor([[1.0, 0.0, 1.0]] * nchw.shape[0], device=nchw.device)
    view = convert_consistency_flip(student, rules)
    check(view.stride() == student.stride(),
          f"teacher view strides {view.stride()}, the student's {student.stride()}")
    return view


def swapped_view(e):
    """The (B, ..., H, W, C) view e's values (H == W) in storage whose H and
    W strides are exchanged, as the un-flip returned the teacher before it
    kept the student's strides: H stride 1 for the model's NCHW output, the
    channels-last 3D output's H and W strides swapped."""
    import torch

    check(e.shape[-3] == e.shape[-2], f"swapped_view needs H == W, got {tuple(e.shape)}")
    out = torch.empty_strided(e.shape, e.stride(), dtype=e.dtype, device=e.device)
    out.transpose(-3, -2).copy_(e)
    return out.transpose(-3, -2)


def phase_k4f() -> dict:
    """K4f (cross_affinity_fwd at D = 1) and its backward (cross_affinity_bwd
    at D = 1) through autograd against the plain version: the student an
    NCHW view, the teacher as the un-flip returns it (the student's strides)
    and as it returned it before (H stride 1), at B=2 256x256 (the
    bbbc039v1 train shape) and an odd shape, neighbor 4 and 8, float32 and
    bfloat16, a zero vector and a random cotangent; times with L2 flushed
    on both teachers. Returns K4f's error and times."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        cross_affinity_2d_plain, cross_affinity_bwd, fused_cross_affinity_2d, multi_offset)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    zero = (1, 3, 5)
    res = {"max_abs_err": 0.0}
    teachers = {"un-flip": teacher_view, "swapped": lambda x: swapped_view(x.permute(0, 2, 3, 1))}
    for (b, h, w), neighbor in [((2, 256, 256), 4), ((2, 256, 256), 8), ((1, 41, 41), 4)]:  # the transpose needs H == W
        offsets = multi_offset([1, 3, 5, 9, 11], neighbor)
        k = len(offsets)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            a_nc = torch.randn((b, 16, h, w), generator=gen, device="cuda")
            a_nc[zero[0] % b, :, zero[1], zero[2]] = 0.0
            a_nc = a_nc.to(dtype).requires_grad_()
            t_nc = torch.randn((b, 16, h, w), generator=gen, device="cuda").to(dtype)
            g = torch.randn((b, k, h, w), generator=gen, device="cuda").to(dtype)
            for (teacher, view), with_db in [(tv, db) for tv in teachers.items()
                                             for db in (False, True)]:
                t_leaf = t_nc.clone().requires_grad_(with_db)
                a, t = a_nc.permute(0, 2, 3, 1), view(t_leaf)
                before = (fused_cross_affinity_2d.launches, cross_affinity_bwd.launches)
                got = fused_cross_affinity_2d(a, t, offsets)
                grads = torch.autograd.grad(got, [a_nc, t_leaf] if with_db else [a_nc], g,
                                            retain_graph=True)
                check((fused_cross_affinity_2d.launches, cross_affinity_bwd.launches)
                      == (before[0] + 1, before[1] + 1), "K4f or its backward did not launch")
                ref = cross_affinity_2d_plain(a, t, offsets)
                refs = torch.autograd.grad(ref, [a_nc, t_leaf] if with_db else [a_nc], g)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                zpx = (zero[0] % b,) + zero[1:]
                gerrs = [_grad_err(x.permute(0, 2, 3, 1), r.permute(0, 2, 3, 1), zpx)
                         for x, r in zip(grads, refs)]
                print(f"[kernels] K4f B={b} {h}x{w} C=16 K={k} neighbor {neighbor} "
                      f"{str(dtype)[6:]}, teacher {teacher} strides {tuple(t.stride())}"
                      f"{', with db' if with_db else ''}: f32 {err:.3e}; grads rel (rest, "
                      f"zero-vector pixel, abs) "
                      + ", ".join(f"({x:.3e}, {z:.3e}, {m:.3e})" for x, z, m in gerrs))
                check(got.shape == (b, k, h, w) and got.dtype == dtype, "K4f shape or dtype")
                check(bool((got[zpx[0], :, zpx[1], zpx[2]] == 0).all()),
                      "K4f nonzero affinity at a zero vector")
                check(err <= (F32_ATOL if f32 else BF16_ATOL), f"K4f error {err}")
                gtol = GRAD_RTOL if f32 else BF16_GRAD_RTOL
                for x, z, _ in gerrs:
                    check(x <= gtol and z <= gtol, f"K4f gradient error {x}, {z}")
                # the swapped teacher's gradient comes back through its copy
                check(all(x.is_contiguous() for x in grads[:1 if teacher == "swapped" else 2]),
                      "K4f gradients not NCHW")
                if f32:
                    res["max_abs_err"] = max(res["max_abs_err"], err)

    flush = 64 << 20  # beyond the 50 MB L2
    offsets = multi_offset([1, 3, 5, 9, 11], 4)
    offs3 = [(0, dy, dx) for dy, dx in offsets]
    a = torch.randn((2, 16, 256, 256), generator=gen, device="cuda").permute(0, 2, 3, 1)
    t_nc = torch.randn((2, 16, 256, 256), generator=gen, device="cuda")
    t, t_old = teacher_view(t_nc), teachers["swapped"](t_nc)
    g = torch.randn((2, len(offsets), 256, 256), generator=gen, device="cuda")
    res.update(kernel_times({
        "ms": lambda: fused_cross_affinity_2d(a, t, offsets),
        "swapped_ms": lambda: fused_cross_affinity_2d(a, t_old, offsets),
        "bwd_ms": lambda: cross_affinity_bwd(a[:, None], t[:, None], g[:, :, None], offs3,
                                             need_db=False),
        "bwd_swapped_ms": lambda: cross_affinity_bwd(a[:, None], t_old[:, None],
                                                     g[:, :, None], offs3, need_db=False)},
        flush))
    res["plain_ms"] = timed_ms(lambda: cross_affinity_2d_plain(a, t, offsets),
                               flush_bytes=flush)
    res["nhwc_ms"] = graph_ms(lambda: fused_cross_affinity_2d(a, t.contiguous(), offsets),
                              flush_bytes=flush)
    res["bound_ms"], res["bound_by"] = train3d_bound(2 * 256 * 256, 16, len(offsets), 2, 0,
                                                     "fwd")
    res["bwd_bound_ms"] = train3d_bound(2 * 256 * 256, 16, len(offsets), 2, 1, "bwd")[0]
    print(f"[kernels] K4f time B=2 256x256 C=16 K=10, student NCHW view, teacher as the "
          f"un-flip returns it (ms, L2 flushed, median of 20; the kernels by CUDA graph replay, "
          f"*event_ms and plain by CUDA events; swapped: the teacher with H stride 1, as the "
          f"un-flip returned it before; nhwc_ms: a contiguous teacher; bwd: the D = 1 cross "
          f"backward without db): {json.dumps(res)}, {card_line()}")
    return res


def wmse_bound(b: int, side: int, c: int, k: int, n_in: int, n_out: int, itemsize: int = 4):
    """Least time for K2/K3 on these inputs. Bytes: each embedding read
    once (``itemsize`` bytes a value, float32 t/w/m read once), and the
    affinities (forward, n_out = 0) or the gradients (backward, n_out
    embeddings) written once in the embeddings' type. Operations:
    normalising each input vector once (3C), per offset a dot (2C) and the
    loss term (6) forward, or the dot, the cotangent (7) and two C-wide
    multiply-adds (4C) backward, and the normalisation's VJP (5C) per
    gradient; at the float32 rate."""
    px = b * side * side
    if n_out == 0:
        nbytes = px * (itemsize * (c * n_in + k) + 4 * 3 * k)
        ops = px * (3 * c * n_in + k * (2 * c + 6))
    else:
        nbytes = px * (itemsize * c * (n_in + n_out) + 4 * 3 * k)
        ops = px * (3 * c * n_in + k * (6 * c + 7) + 5 * c * n_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_err(got, ref, zero_px):
    """max |got - ref| / max |ref| over all pixels but the zero vector's,
    and the same at that pixel alone; tensors (B, ..., C), compared in
    float32, zero_px the index of the zero vector's pixel or voxel."""
    got, ref = got.float(), ref.float()
    keep = ref.new_ones(ref.shape[:-1], dtype=bool)
    keep[tuple(zero_px)] = False
    d = (got - ref).abs()
    rest = (d[keep].max() / ref[keep].abs().max()).item()
    at_zero = (d[tuple(zero_px)].max() / ref[tuple(zero_px)].abs().max().clamp(min=1e-30)).item()
    return rest, at_zero, d[keep].max().item()


def phase_wmse_kernels() -> dict:
    """K2f/K2b at the five training scales and K3f/K3b at full scale
    against their plain versions, on the model's NCHW layout permuted to
    (B, H, W, C); times at full scale with L2 flushed."""
    import torch

    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    offsets_all = multi_offset([1, 3, 5, 9, 27], 4)
    zero_px = (0, 3, 5)
    res = {name: {"max_abs_err": 0.0} for name in WMSE_NAMES}

    def inputs(side, k, views):
        es = []
        for _ in range(views):
            e = torch.randn((2, 16, side, side), generator=gen, device="cuda")
            e[zero_px[0], :, zero_px[1], zero_px[2]] = 0.0
            es.append(e.permute(0, 2, 3, 1))
        shape = (2, k, side, side)
        t = (torch.rand(shape, generator=gen, device="cuda") > 0.5).float()
        w = torch.rand(shape, generator=gen, device="cuda") * 2.0 + 0.05
        m = (torch.rand(shape, generator=gen, device="cuda") > 0.2).float()
        gs = torch.rand((k,), generator=gen, device="cuda") / (2 * side) + 1e-4
        return es, (t, w, m), gs

    # no spills in K2f/K3f, K2b and both forms of K3b (phase 2 printed
    # their registers)
    no_spills(WMSE_SOURCE)

    cases = [("K2", side, k) for side, k in TRAIN_SCALES] + [("K3", 544, 10)]
    for kind, side, k in cases:
        offsets = offsets_all[:k]
        es, maps, gs = inputs(side, k, 1 if kind == "K2" else 2)
        req = [e.detach().clone().requires_grad_() for e in es]
        if kind == "K2":
            s, affs = W.wmse2d_fwd(es[0], *maps, offsets)
            grads = [W.wmse2d_bwd(es[0], *maps, gs, offsets)]
            s_ref, affs_ref = W.affinity_wmse_2d_plain(req[0], *maps, offsets)
        else:
            s, affs = W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets)
            # without db (the training steps' call), then da and db
            da, no_db = W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets, need_db=False)
            check(no_db is None, "K3b without db returned a db")
            grads = [da, *W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets)]
            s_ref, affs_ref = W.cross_affinity_wmse_2d_plain(req[0], req[1], *maps, offsets)
        refs = torch.autograd.grad(s_ref, req, gs)
        if kind == "K3":
            refs = [refs[0], *refs]
        torch.cuda.synchronize()
        err_a = (affs - affs_ref).abs().max().item()
        err_s = ((s - s_ref).abs() / s_ref.abs()).max().item()
        gerrs = [_grad_err(g, r, zero_px) for g, r in zip(grads, refs)]
        print(f"[kernels] {kind} B=2 {side}x{side} C=16 K={k}: affs {err_a:.3e}, "
              f"S rel {err_s:.3e}, grads rel (rest, zero-vector pixel, abs)"
              + (" of da without db, da and db with it: " if kind == "K3" else ": ")
              + ", ".join(f"({a:.3e}, {z:.3e}, {x:.3e})" for a, z, x in gerrs))
        check(bool((affs[zero_px[0], :, zero_px[1], zero_px[2]] == 0).all()),
              f"{kind} nonzero affinity at a zero vector")
        check(err_a <= F32_ATOL, f"{kind} affinity error {err_a}")
        check(err_s <= S_RTOL, f"{kind} S relative error {err_s}")
        for a, z, _ in gerrs:
            check(a <= GRAD_RTOL and z <= GRAD_RTOL, f"{kind} gradient error {a}, {z}")
        fwd, bwd = f"{kind}f", f"{kind}b"
        res[fwd]["max_abs_err"] = max(res[fwd]["max_abs_err"], err_a)
        res[bwd]["max_abs_err"] = max(res[bwd]["max_abs_err"], *(x for _, _, x in gerrs))

        if side != 544:
            continue
        flush = 64 << 20
        n_in = len(es)
        if kind == "K2":
            t = kernel_times({"fwd_ms": lambda: W.wmse2d_fwd(es[0], *maps, offsets),
                              "bwd_ms": lambda: W.wmse2d_bwd(es[0], *maps, gs, offsets)}, flush)
            p_f = timed_ms(lambda: W.affinity_wmse_2d_plain(es[0], *maps, offsets),
                           flush_bytes=flush)
        else:
            t = kernel_times({
                "fwd_ms": lambda: W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets),
                "bwd_ms": lambda: W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets,
                                                     need_db=False),
                "db_ms": lambda: W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets)}, flush)
            p_f = timed_ms(lambda: W.cross_affinity_wmse_2d_plain(es[0], es[1], *maps,
                                                                  offsets),
                           flush_bytes=flush)
        # the plain backward of the main path's call: K3's with the teacher
        # detached, as the training step has it
        s_g = (W.affinity_wmse_2d_plain(req[0], *maps, offsets) if kind == "K2"
               else W.cross_affinity_wmse_2d_plain(req[0], es[1], *maps, offsets))[0]
        p_b = timed_ms(lambda: torch.autograd.grad(s_g, req[:1], gs, retain_graph=True),
                       flush_bytes=flush)
        if kind == "K3":  # the teacher as the un-flip returned it before: H stride 1
            old = swapped_view(es[1])
            t["fwd_swapped_ms"] = graph_ms(lambda: W.cross_wmse2d_fwd(es[0], old, *maps, offsets),
                                           flush_bytes=flush)
            t["bwd_swapped_ms"] = graph_ms(
                lambda: W.cross_wmse2d_bwd(es[0], old, *maps, gs, offsets, need_db=False),
                flush_bytes=flush)
            s_db = W.cross_affinity_wmse_2d_plain(*req, *maps, offsets)[0]
            db_bound = wmse_bound(2, 544, 16, k, n_in, 2)[0]
            res[bwd].update(
                db_ms=t["db_ms"], db_event_ms=t["db_event_ms"], db_bound_ms=db_bound,
                db_plain_ms=timed_ms(lambda: torch.autograd.grad(s_db, req, gs,
                                                                 retain_graph=True),
                                     flush_bytes=flush))
            print(f"[kernels] K3b with db time B=2 544x544 C=16 K=10 (ms, L2 flushed, median "
                  f"of 20): kernel {t['db_ms']:.4f} by graph replay, {t['db_event_ms']:.4f} by "
                  f"events, plain {res[bwd]['db_plain_ms']:.4f}, bound {db_bound:.4f} (bytes); "
                  f"{card_line()}")
        for name, part, p, n_out in [(fwd, "fwd", p_f, 0), (bwd, "bwd", p_b, 1)]:
            bound, by = wmse_bound(2, 544, 16, k, n_in, n_out)
            res[name].update(ms=t[f"{part}_ms"], event_ms=t[f"{part}_event_ms"], plain_ms=p,
                             bound_ms=bound, bound_by=by)
            if kind == "K3":
                res[name]["swapped_ms"] = t[f"{part}_swapped_ms"]
            print(f"[kernels] {name} time B=2 544x544 C=16 K=10 (ms, L2 flushed, median of "
                  f"20{', without db' if name == 'K3b' else ''}): kernel "
                  f"{res[name]['ms']:.4f} by graph replay, {res[name]['event_ms']:.4f} by "
                  f"events, plain {p:.4f}, bound {bound:.4f} ({by}); the teacher with H stride "
                  f"1: {res[name].get('swapped_ms')}; {card_line()}")
    return res


def check_k3b_form(rows, label: str, dtype: str = "float32"):
    """Print the instantiation of K3b that a profiled training step ran and
    fail unless it is the one without db of ``dtype``'s storage, once a
    step (the teacher is detached)."""
    forms = [(calls, re.search(r"wmse_bwd_kernel<[^>]*>", name).group(0))
             for _, calls, name in rows if re.search(r"wmse_bwd_kernel<\w+, false", name)]
    print(f"[profile] {label}: K3b ran " + "; ".join(f"{f} x{c} a step" for c, f in forms))
    k3b = f"wmse_bwd_kernel<{STORAGE[dtype]}, false, false>"
    check(forms == [(1, k3b)], f"{label}: K3b ran {forms}, not {k3b} once a step")


class LeafSet:
    """The host provider's training set: synthetic leaf samples, each drawn
    flipped along x and y at random."""

    def __init__(self, samples):
        self.samples = samples

    def sample(self, rng):
        s = self.samples[int(rng.integers(len(self.samples)))]
        img, seg = s["image"], s["seg"]
        if rng.random() < 0.5:
            img, seg = img[:, ::-1], seg[:, ::-1]
        if rng.random() < 0.5:
            img, seg = img[::-1], seg[::-1]
        return {"image": np.ascontiguousarray(img), "seg": np.ascontiguousarray(seg)}


def provider_run(preset: str, train_ds, launchers: dict, per_step: dict, label: str) -> dict:
    """PROVIDER_STEPS steps of ``preset`` through the host provider
    (data.device_resident False: worker processes, pinned copies), every
    count in ``launchers`` set to 0 just before and read just after, each
    held to ``per_step`` a step; returns the launches."""
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import train

    out = os.path.join(REPO, "build", f"chip_smoke_provider_{preset}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(preset, {"data": {"device_resident": False},
                               "train": {"if_valid": False, "display_freq": 1,
                                         "save_freq": 10 ** 6},
                               "save_path": os.path.join(out, "models")})
    for fn in launchers.values():
        fn.launches = 0
    timing: dict = {}
    t0 = time.perf_counter()
    state, _ = train(cfg, max_iters=PROVIDER_STEPS, data_override=(train_ds, []),
                     device="cuda", log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    for k, n in per_step.items():
        check(launches[k] == n * PROVIDER_STEPS,
              f"{label} host provider: {k} launched {launches[k]} times in "
              f"{PROVIDER_STEPS} steps")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    check(state.step == PROVIDER_STEPS and len(losses) == PROVIDER_STEPS
          and all(np.isfinite(losses)), f"{label} host provider: losses {losses}")
    print(f"[{label}] host provider (device_resident False, {cfg.train.num_workers} worker "
          f"processes): {wall:.2f} s for {PROVIDER_STEPS} steps, losses {losses}, launches "
          f"{json.dumps(launches)}; warm ms/step (steps 2..{PROVIDER_STEPS}, median): data "
          f"{1e3 * np.median(timing['data_s'][1:]):.4f} + step "
          f"{1e3 * np.median(timing['step_s'][1:]):.4f}; {card_line()}")
    return launches


def _wmse_launchers():
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    return {"K2f": W.wmse2d_fwd, "K2b": W.wmse2d_bwd,
            "K3f": W.cross_wmse2d_fwd, "K3b": W.cross_wmse2d_bwd}


def phase_train() -> dict:
    """The training main path; returns each kernel's launches in it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.device_data import (
        pack_cvppp_arrays, sample_cvppp_batch, sampler_generator)
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad
    from pixel_embedded_affinity_torch.ops.upsample_cuda import upsample_bwd
    from pixel_embedded_affinity_torch.train import (
        TrainStep2D, init_state, latest_checkpoint, load_checkpoint, restore, train)

    out = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config("cvppp", {
        "train": {"display_freq": 1, "valid_freq": TRAIN_STEPS, "save_freq": 10 ** 6},
        "save_path": os.path.join(out, "models")})
    check(cfg.data.device_resident, "cvppp preset: device_resident")
    # the serving phase's 4 leaf images, packed as the loader packs the files
    arrays = pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED))
    valid = synthetic_leaves(2, 530, 500, SEED + 1)
    print(f"[train] cvppp ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, B={cfg.train.batch_size}, 544x544 from the device-resident "
          f"sampler over {len(arrays[0])} synthetic leaf images {arrays[0].shape[1:]} uint8, "
          f"{TRAIN_STEPS} steps, validation on {len(valid)} images, convs in float32 (TF32 off)")

    launchers = _wmse_launchers()
    timing: dict = {}
    for fn in launchers.values():
        fn.launches = 0
    fused_affinity_2d.launches = 0
    upsample_bwd.launches = conv_wgrad.launches = conv_dgrad.launches = 0
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=TRAIN_STEPS, data_override=(arrays, valid),
                           device="cuda", log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    launches["K1f"] = fused_affinity_2d.launches
    launches["UPb"] = upsample_bwd.launches
    launches["CWg"], launches["CXg"] = conv_wgrad.launches, conv_dgrad.launches
    print(f"[train] {wall:.2f} s for {TRAIN_STEPS} steps + validation + checkpoint; "
          f"launches {json.dumps(launches)}")
    n_w, n_x = conv_grads_per_step("cvppp", arrays)
    for k, per_step in [("K2f", 5), ("K2b", 5), ("K3f", 1), ("K3b", 1),
                        ("UPb", UP_PER_STEP), ("CWg", n_w), ("CXg", n_x)]:
        check(launches[k] == per_step * TRAIN_STEPS,
              f"{k} launched {launches[k]} times in {TRAIN_STEPS} steps")
    check(launches["K1f"] == len(valid), f"K1f launched {launches['K1f']} times")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[train] loss per step: {losses}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "a non-finite loss")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
          f"validation {history}")
    print(f"[train] validation: {json.dumps(history[0])}")
    print_step_times("train", timing, TRAIN_STEPS, HOST_DATA_MS["cvppp"])

    # the checkpoint gives the trained state's next-step loss, bit for bit
    ck = latest_checkpoint(os.path.join(cfg.save_path, cfg.name))
    check(ck is not None and ck.endswith(f"model-{TRAIN_STEPS:06d}.ckpt"), f"checkpoint {ck}")
    loaded = restore(init_state(cfg, "cuda"), load_checkpoint(ck))
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    step = TrainStep2D(offsets, ema_seed=cfg.train.random_seed)
    images, labels = (torch.from_numpy(a).cuda() for a in arrays)
    batch = step.ema_batch(sample_cvppp_batch(images, labels,
                                              sampler_generator(cfg.train.random_seed,
                                                                loaded.step),
                                              cfg.train.batch_size, out=cfg.data.size),
                           loaded.step)

    def next_loss(model):
        model = copy.deepcopy(model).train()
        with torch.no_grad(), float32_convs():
            return step.loss(model, batch)[0].item()

    la, lb = next_loss(state.model), next_loss(loaded.model)
    print(f"[train] next-step loss: trained state {la!r}, reloaded checkpoint {lb!r}")
    check(la == lb and loaded.step == state.step == TRAIN_STEPS, "checkpoint reload differs")

    # K2f and K3f are one kernel: K3f is each step's last launch of it
    rows = device_breakdown(lambda: step(loaded, batch), 1, iters=3,
                            label="train step B=2 544x544", unit="step", ours=("wmse",),
                            require=WMSE_KERNELS, in_order=WMSE_KERNELS)
    check_k3b_form(rows, "train step B=2 544x544")
    train_precision(state.model, batch,
                    lambda use_pallas: TrainStep2D(offsets, use_pallas=use_pallas,
                                                   device_ema=False), BIAS_BEFORE_BN)
    # the host provider's path, on the serving phase's leaf samples
    host = provider_run("cvppp", LeafSet(synthetic_leaves(4, 530, 500, SEED)), launchers,
                        {"K2f": 5, "K2b": 5, "K3f": 1, "K3b": 1}, "train")
    step_ms = 1e3 * float(np.median(timing["step_s"][1:]))
    return {"launches": {k: launches[k] + host.get(k, 0) for k in launches},
            "montage": {"cfg": cfg, "state": state, "valid": valid, "run": out},
            "step_ms": step_ms}


def print_step_times(label: str, timing: dict, steps: int, host_data_ms: float):
    """The warm median of steps 2..steps: data_s (the device sampler's
    launches) beside the host provider's reading, and step_s."""
    data_ms = [1e3 * t for t in timing["data_s"][1:]]
    step_ms = [1e3 * t for t in timing["step_s"][1:]]
    print(f"[{label}] warm ms/step (steps 2..{steps}, median): data "
          f"{np.median(data_ms):.4f} (the device-resident sampler; the host provider's, "
          f"PERF.md: {host_data_ms}) + step {np.median(step_ms):.4f} = "
          f"{np.median(np.add(data_ms, step_ms)):.4f}; first step "
          f"{1e3 * (timing['data_s'][0] + timing['step_s'][0]):.4f}; {card_line()}")


def train_precision(model, batch, make_step, zero_bias, label="train"):
    """One step's parameter gradients through the kernels in float32, and
    through the plain path in float32, each against the plain path in
    float64, on the same batch and EMA view. ``make_step(use_pallas)``
    gives the train step; ``zero_bias`` matches the biases whose true
    gradient is 0 (a conv's in front of train-mode BatchNorm)."""
    import torch

    runs, secs = {}, {}
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    for name, use_pallas, f64 in [("kernels", True, False), ("plain", False, False),
                                  ("f64", False, True)]:
        m = copy.deepcopy(model).double() if f64 else copy.deepcopy(model)
        t0 = time.perf_counter()
        make_step(use_pallas).grads(m, b64 if f64 else batch)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        runs[name] = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}
    # the mask head is off the cvppp loss: no gradient in any run
    check(len({frozenset(r) for r in runs.values()}) == 1,
          "the runs reach different parameters")
    top = max(g.abs().max().item() for g in runs["f64"].values())
    errs, zero = [], []
    for name, g64 in runs["f64"].items():
        gk, gp = runs["kernels"][name].double(), runs["plain"][name].double()
        if zero_bias.search(name):
            zero.append((g64.abs().max().item() / top, gk.abs().max().item() / top))
            continue
        scale = g64.abs().max().item()
        errs.append((name, (gk - g64).abs().max().item() / scale,
                     (gp - g64).abs().max().item() / scale))
    print(f"[{label}] parameter gradients against float64, max error relative to each "
          f"tensor's largest, float32 kernels / float32 plain ({len(errs)} tensors; host s "
          f"of the three steps: {json.dumps(secs)}):")
    for i in range(0, len(errs), 3):
        print(f"[{label}]   " + "  ".join(f"{n} {e:.2e}/{p:.2e}" for n, e, p in errs[i:i + 3]))
    worst = max(errs, key=lambda t: t[1])
    excess = max(errs, key=lambda t: t[1] - KERNEL_EXCESS * t[2])
    z64, z32 = max(z[0] for z in zero), max(z[1] for z in zero)
    print(f"[{label}] worst {worst[0]} {worst[1]:.3e} with the kernels, {worst[2]:.3e} plain "
          f"(bound {F64_GRAD_RTOL}); the kernels' largest excess over the plain path: "
          f"{excess[0]} {excess[1]:.3e} vs {excess[2]:.3e} (bound {KERNEL_EXCESS}x + 1e-4); "
          f"the {len(zero)} conv biases in front of BatchNorm (true gradient 0): largest "
          f"|grad| / {top:.3e} is {z64:.3e} in float64, {z32:.3e} in float32")
    check(worst[1] <= F64_GRAD_RTOL, f"gradient of {worst[0]} off float64 by {worst[1]}")
    for name, e, p in errs:
        check(e <= KERNEL_EXCESS * p + 1e-4, f"the kernels add error to {name}: {e} vs {p}")
    check(z64 <= 1e-9 and z32 <= 1e-4, "bias-before-BatchNorm gradient not ~0")


def model_gflop(cfg, shape) -> float:
    """GFLOP of one forward of the 3D model at this input shape, as PyTorch's
    FlopCounterMode counts them (convolutions and matmuls), on the meta
    device: no data, no card time."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep

    with torch.device("meta"):
        model = UNetPNIEmbeddingDeep(cfg.model.input_nc, tuple(cfg.model.filters),
                                     cfg.model.emd).eval()
        x = torch.empty(shape)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops() / 1e9


def phase_kernels_3d() -> dict:
    """K5f against its plain version on the card; returns its error and
    times at the serving tile batch (B=4) and the training batch (B=2)."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        SHIFTS_3D, affinity_3d_plain, fused_affinity_3d)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    max_err = 0.0
    # the serving tile batch and the training batch as the model's NCDHW
    # output permuted, no copy; the training batch channels-last (the
    # kernel's 16-byte loads); then
    # odd shapes: D < 4 and H, W < 27 put whole channels out of bounds
    cases = [((4, 18, 160, 160, 16), True), ((2, 18, 160, 160, 16), True),
             ((2, 18, 160, 160, 16), False), ((2, 5, 37, 41, 8), False),
             ((2, 3, 20, 25, 16), False)]
    for shape, as_view in cases:
        b, d, h, w, c = shape
        if as_view:
            nc = torch.randn((b, c, d, h, w), generator=gen, device="cuda")
            e, eb = nc.permute(0, 2, 3, 4, 1), nc.to(torch.bfloat16).permute(0, 2, 3, 4, 1)
        else:
            e = torch.randn(shape, generator=gen, device="cuda")
            e[0, 1, 3, 5] = 0.0  # a zero vector must give zero affinities
            eb = e.to(torch.bfloat16)
        got, ref = fused_affinity_3d(e), affinity_3d_plain(e)
        got_b, ref_b = fused_affinity_3d(eb), affinity_3d_plain(eb)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        err_b = (got_b.float() - ref_b.float()).abs().max().item()
        print(f"[kernels3d] K5 {shape} {'NCDHW view' if as_view else 'contiguous'}: "
              f"f32 {err:.3e}, bf16 {err_b:.3e}")
        check(got.shape == (b, len(SHIFTS_3D), d, h, w), "K5 shape")
        check(got_b.dtype == torch.bfloat16, "K5 bf16 output dtype")
        check(err <= K5_F32_ATOL, f"K5 f32 error {err}")
        check(err_b <= BF16_ATOL, f"K5 bf16 error {err_b}")
        if not as_view:
            check(bool((got[0, :, 1, 3, 5] == 0).all()), "K5 nonzero affinity at a zero vector")
            for k, s in enumerate(SHIFTS_3D):
                lo = [slice(None)] * 3
                lo[k % 3] = slice(0, min(s, (d, h, w)[k % 3]))
                check(bool((got[:, k][(slice(None),) + tuple(lo)] == 0).all()),
                      f"K5 channel {k}: nonzero where the neighbour is outside")
        max_err = max(max_err, err)

    # differentiable through its backward kernel: the gradient through
    # autograd against the plain version's, at a shape with a zero vector
    from pixel_embedded_affinity_torch.ops import affinity_bwd

    x = torch.randn((2, 16, 5, 37, 41), generator=gen, device="cuda")
    x[1, :, 2, 3, 5] = 0.0
    x.requires_grad_()
    g = torch.randn((2, len(SHIFTS_3D), 5, 37, 41), generator=gen, device="cuda")
    before = affinity_bwd.launches
    (got,) = torch.autograd.grad(fused_affinity_3d(x.permute(0, 2, 3, 4, 1)), x, g)
    check(affinity_bwd.launches == before + 1, "K5's backward did not launch its kernel")
    (ref,) = torch.autograd.grad(affinity_3d_plain(x.permute(0, 2, 3, 4, 1)), x, g)
    torch.cuda.synchronize()
    rest, at_zero, _ = _grad_err(got.permute(0, 2, 3, 4, 1), ref.permute(0, 2, 3, 4, 1),
                                 (1, 2, 3, 5))
    print(f"[kernels3d] K5 through autograd: gradient rel (rest, zero-vector voxel) "
          f"({rest:.3e}, {at_zero:.3e})")
    check(rest <= GRAD_RTOL and at_zero <= GRAD_RTOL, f"K5 gradient error {rest}, {at_zero}")

    flush = 64 << 20  # beyond the 50 MB L2
    out = {}
    for b in (4, 2):  # the serving tile batch, the training batch
        view = torch.randn((b, 16, 18, 160, 160), generator=gen,
                           device="cuda").permute(0, 2, 3, 4, 1)
        view_b = view.to(torch.bfloat16)
        last = view.contiguous()  # channels-last
        t = kernel_times({"ms": lambda: fused_affinity_3d(view),
                          "bf16_ms": lambda: fused_affinity_3d(view_b),
                          "ndhwc_ms": lambda: fused_affinity_3d(last)}, flush)
        t["plain_ms"] = timed_ms(lambda: affinity_3d_plain(view), flush_bytes=flush)
        t["bound_ms"], t["bound_by"] = affinity_bound(view.shape, len(SHIFTS_3D), 4)
        t["bf16_bound_ms"] = affinity_bound(view.shape, len(SHIFTS_3D), 2)[0]
        print(f"[kernels3d] K5 time B={b} 18x160x160 C=16 K=12, NCDHW view (ms, L2 flushed, "
              f"median of 20; the kernel by CUDA graph replay, *event_ms and plain by CUDA "
              f"events; ndhwc: a channels-last embedding): {json.dumps(t)}, {card_line()}")
        out[b] = t
    t = out[4]
    t["train"] = out[2]
    return {"max_abs_err": max_err, **t}


def train3d_bound(n: int, c: int, k: int, n_read: int, n_write: int, kind: str,
                  itemsize: int = 4):
    """Least time for the 3D training kernels on n voxels: each embedding
    read once (n_read of them), the cotangent g read once by the backwards,
    and the affinities (forward) or n_write gradients written once.
    Operations: normalising each input vector once (3C); per channel a dot
    (2C) forward, or one C-wide multiply-add (2C) per gradient and term
    backward; the normalisation's VJP (5C) per gradient; at the float32
    rate."""
    if kind == "fwd":
        elems = n * (c * n_read + k)
        ops = n * (3 * c * n_read + 2 * c * k)
    else:
        elems = n * (c * n_read + k + c * n_write)
        ops = n * (3 * c * n_read + 4 * c * k * n_write + 5 * c * n_write)
    t_bytes = elems * itemsize / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def step_teachers(b):
    """Three teachers for a channels-last student, from an NCDHW-view
    embedding b: channels-last ("ndhwc"), the same with H and W strides
    swapped ("swapped", what the un-flip made of it before it kept its
    input's strides) and the NCDHW view ("view")."""
    last = b.contiguous()
    return {"ndhwc": last, "swapped": swapped_view(last), "view": b}


def phase_train_kernels_3d() -> dict:
    """The self-affinity backward, the cross forward and the cross backward
    against their plain versions on the card: at the training shape (B=2,
    18x160x160, C=16) on the model's permuted NCDHW view, and at two odd
    shapes (D < 4, H and W < 27: whole channels out of the volume), in
    float32 and bfloat16, each with a zero vector and a random cotangent
    over the whole output; the raw (normalized) forms once. Times at the
    training shape with L2 flushed."""
    import torch

    from pixel_embedded_affinity_torch.ops import (
        SHIFTS_3D, affinity_bwd, affinity_bwd_plain, cross_affinity_3d_plain,
        cross_affinity_bwd, cross_affinity_bwd_plain, cross_affinity_fwd, offsets_3d)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    offs = offsets_3d(SHIFTS_3D)
    k = len(offs)
    res = {name: {"max_abs_err": 0.0} for name in ("K5b", "K6f", "K6b")}
    zero = (0, 1, 3, 5)

    def views(shape, dtype):
        b, d, h, w, c = shape
        out = []
        for _ in range(2):
            nc = torch.randn((b, c, d, h, w), generator=gen, device="cuda")
            nc[zero[0], :, zero[1], zero[2], zero[3]] = 0.0
            out.append(nc.to(dtype).permute(0, 2, 3, 4, 1))
        g = torch.randn((b, k, d, h, w), generator=gen, device="cuda").to(dtype)
        return out[0], out[1], g

    for shape in [(2, 18, 160, 160, 16), (2, 5, 37, 41, 8), (2, 3, 20, 25, 16)]:
        for dtype in (torch.float32, torch.bfloat16):
            a, b, g = views(shape, dtype)
            f32 = dtype == torch.float32
            got = {"K5b": [affinity_bwd(a, g, offs)],
                   "K6f": cross_affinity_fwd(a, b, offs),
                   "K6b": list(cross_affinity_bwd(a, b, g, offs))}
            da_only, none = cross_affinity_bwd(a, b, g, offs, need_db=False)
            ref = {"K5b": [affinity_bwd_plain(a, g, offs)],
                   "K6f": cross_affinity_3d_plain(a, b),
                   "K6b": list(cross_affinity_bwd_plain(a, b, g, offs))}
            torch.cuda.synchronize()
            errs = {"K6f": (got["K6f"].float() - ref["K6f"].float()).abs().max().item()}
            for name in ("K5b", "K6b"):
                errs[name] = [_grad_err(x, r, zero) for x, r in zip(got[name], ref[name])]
            skip = (da_only.float() - got["K6b"][0].float()).abs().max().item()
            tol, gtol = (F32_ATOL, GRAD_RTOL) if f32 else (BF16_ATOL, BF16_GRAD_RTOL)
            print(f"[kernels3d-train] {shape} {str(dtype)[6:]} NCDHW view: K6f {errs['K6f']:.3e}; "
                  f"grads rel (rest, zero-vector voxel, abs): K5b "
                  + ", ".join(f"({x:.3e}, {z:.3e}, {m:.3e})" for x, z, m in errs["K5b"])
                  + "; K6b da, db "
                  + ", ".join(f"({x:.3e}, {z:.3e}, {m:.3e})" for x, z, m in errs["K6b"])
                  + f"; K6b without db: da {skip:.3e} off")
            check(got["K6f"].shape == (shape[0], k) + shape[1:4] and got["K6f"].dtype == dtype,
                  "K6f shape or dtype")
            check(bool((got["K6f"][zero[0], :, zero[1], zero[2], zero[3]] == 0).all()),
                  "K6f nonzero affinity at a zero vector")
            check(errs["K6f"] <= tol, f"K6f error {errs['K6f']}")
            for name in ("K5b", "K6b"):
                for x, z, _ in errs[name]:
                    check(x <= gtol and z <= gtol, f"{name} gradient error {x}, {z}")
            check(none is None and skip == 0.0, "K6b without db differs")
            for x in got["K5b"] + got["K6b"]:
                check(x.dtype == dtype and x.permute(0, 4, 1, 2, 3).is_contiguous(),
                      "gradient not in the NCDHW layout")
            if f32:
                res["K6f"]["max_abs_err"] = max(res["K6f"]["max_abs_err"], errs["K6f"])
                for name in ("K5b", "K6b"):
                    res[name]["max_abs_err"] = max(res[name]["max_abs_err"],
                                                   *(m for _, _, m in errs[name]))

    # a channels-last embedding, which the self backward reads in 16-byte
    # loads
    a, b, g = views((2, 18, 160, 160, 16), torch.float32)
    last = a.contiguous()
    x, z, m = _grad_err(affinity_bwd(last, g, offs), affinity_bwd_plain(last, g, offs), zero)
    print(f"[kernels3d-train] K5b on a channels-last (2, 18, 160, 160, 16): grads rel (rest, "
          f"zero-vector voxel, abs) ({x:.3e}, {z:.3e}, {m:.3e})")
    check(x <= GRAD_RTOL and z <= GRAD_RTOL, f"K5b channels-last gradient error {x}, {z}")
    res["K5b"]["max_abs_err"] = max(res["K5b"]["max_abs_err"], m)

    # the cross kernels on a channels-last student (their 16-byte loads: no
    # main path hands this layout, the 3D step's inputs are NCDHW, but the
    # wrappers take any strides) with three teachers: channels-last,
    # H/W-swapped (what the un-flip made of a channels-last teacher before it
    # kept its input's strides) and an NCDHW view
    for dtype in (torch.float32, torch.bfloat16):
        a, b, g = views((2, 18, 160, 160, 16), dtype)
        a = a.contiguous()
        f32 = dtype == torch.float32
        tol, gtol = (F32_ATOL, GRAD_RTOL) if f32 else (BF16_ATOL, BF16_GRAD_RTOL)
        for name, t in step_teachers(b).items():
            got = cross_affinity_fwd(a, t, offs)
            grads = cross_affinity_bwd(a, t, g, offs)
            da_only, _ = cross_affinity_bwd(a, t, g, offs, need_db=False)
            ref = cross_affinity_3d_plain(a, t)
            refs = cross_affinity_bwd_plain(a, t, g, offs)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            gerrs = [_grad_err(x, r, zero) for x, r in zip(grads, refs)]
            print(f"[kernels3d-train] K6f/K6b {str(dtype)[6:]} channels-last student, teacher "
                  f"{name} strides {tuple(t.stride())}: K6f {err:.3e}; da, db rel (rest, "
                  f"zero-vector voxel, abs) "
                  + ", ".join(f"({x:.3e}, {z:.3e}, {m:.3e})" for x, z, m in gerrs))
            check(bool((got[zero[0], :, zero[1], zero[2], zero[3]] == 0).all()),
                  f"K6f nonzero affinity at a zero vector, teacher {name}")
            check(err <= tol, f"K6f error {err}, teacher {name}")
            for x, z, _ in gerrs:
                check(x <= gtol and z <= gtol, f"K6b gradient error {x}, {z}, teacher {name}")
            check(torch.equal(da_only, grads[0]), f"K6b without db differs, teacher {name}")
            if f32:
                res["K6f"]["max_abs_err"] = max(res["K6f"]["max_abs_err"], err)
                res["K6b"]["max_abs_err"] = max(res["K6b"]["max_abs_err"],
                                                *(m for _, _, m in gerrs))

    # the raw forms (inputs taken as unit vectors, dn written), as the TPU
    # kernels' normalized=True
    a, b, g = views((2, 5, 37, 41, 8), torch.float32)
    raw = [(affinity_bwd(a, g, offs, normalized=True),
            affinity_bwd_plain(a, g, offs, normalized=True))]
    raw += list(zip(cross_affinity_bwd(a, b, g, offs, normalized=True),
                    cross_affinity_bwd_plain(a, b, g, offs, normalized=True)))
    rel = max((x - r).abs().max().item() / r.abs().max().item() for x, r in raw)
    print(f"[kernels3d-train] raw (normalized) forms: dn rel {rel:.3e}")
    check(rel <= GRAD_RTOL, f"raw-form gradient error {rel}")

    flush = 64 << 20  # beyond the 50 MB L2
    a, b, g = views((2, 18, 160, 160, 16), torch.float32)
    n = 2 * 18 * 160 * 160
    timings = {
        "K5b": (lambda: affinity_bwd(a, g, offs), lambda: affinity_bwd_plain(a, g, offs),
                (1, 1, "bwd")),
        "K6f": (lambda: cross_affinity_fwd(a, b, offs), lambda: cross_affinity_3d_plain(a, b),
                (2, 0, "fwd")),
        # the main path's call: the teacher is detached, so no db
        "K6b": (lambda: cross_affinity_bwd(a, b, g, offs, need_db=False),
                lambda: cross_affinity_bwd_plain(a, b, g, offs), (2, 1, "bwd"))}
    for name, (fn, plain, (n_read, n_write, kind)) in timings.items():
        t = kernel_times({"ms": fn}, flush)
        p = timed_ms(plain, flush_bytes=flush)
        bound, by = train3d_bound(n, 16, k, n_read, n_write, kind)
        res[name].update(**t, plain_ms=p, bound_ms=bound, bound_by=by)
        print(f"[kernels3d-train] {name} time B=2 18x160x160 C=16 K=12 NCDHW view (ms, L2 "
              f"flushed, median of 20): kernel {t['ms']:.4f} by CUDA graph replay, "
              f"{t['event_ms']:.4f} by CUDA events, plain {p:.4f}, bound {bound:.4f} ({by}), "
              f"{card_line()}")
    last = a.contiguous()  # channels-last
    for name, t in step_teachers(b).items():
        lay = kernel_times({
            "K6f_ms": lambda: cross_affinity_fwd(last, t, offs),
            "K6b_ms": lambda: cross_affinity_bwd(last, t, g, offs, need_db=False)}, flush)
        for kern in ("K6f", "K6b"):
            res[kern][f"{name}_ms"] = lay[f"{kern}_ms"]
            res[kern][f"{name}_event_ms"] = lay[f"{kern}_event_ms"]
        print(f"[kernels3d-train] channels-last student, teacher {name}: "
              f"K6f {lay['K6f_ms']:.4f} ms by graph replay, {lay['K6f_event_ms']:.4f} by "
              f"events; K6b without db {lay['K6b_ms']:.4f}, {lay['K6b_event_ms']:.4f}")
    t_last = kernel_times({"ms": lambda: affinity_bwd(last, g, offs)}, flush)
    res["K5b"]["ndhwc_ms"], res["K5b"]["ndhwc_event_ms"] = t_last["ms"], t_last["event_ms"]
    print(f"[kernels3d-train] K5b on a channels-last embedding: "
          f"{t_last['ms']:.4f} ms by graph replay, {t_last['event_ms']:.4f} by events")
    bf = views((2, 18, 160, 160, 16), torch.bfloat16)
    t_bf = kernel_times({"ms": lambda: affinity_bwd(bf[0], bf[2], offs)}, flush)
    print(f"[kernels3d-train] K5b bf16: {t_bf['ms']:.4f} ms by graph replay, "
          f"{t_bf['event_ms']:.4f} by events, bound "
          f"{train3d_bound(n, 16, k, 1, 1, 'bwd', itemsize=2)[0]:.4f}")
    t_db = graph_ms(lambda: cross_affinity_bwd(a, b, g, offs), flush_bytes=flush)
    t_db_last = graph_ms(lambda: cross_affinity_bwd(last, b.contiguous(), g, offs),
                         flush_bytes=flush)
    print(f"[kernels3d-train] K6b with db: {t_db:.4f} ms (channels-last both {t_db_last:.4f}), "
          f"bound {train3d_bound(n, 16, k, 2, 2, 'bwd')[0]:.4f}; the plain version computes both")
    bf_last = [x.contiguous() for x in bf[:2]]
    t_bf = kernel_times({
        "K6f_ms": lambda: cross_affinity_fwd(*bf_last, offs),
        "K6b_ms": lambda: cross_affinity_bwd(*bf_last, bf[2], offs, need_db=False)}, flush)
    print(f"[kernels3d-train] K6f/K6b bf16 channels-last both: {json.dumps(t_bf)}, bounds "
          f"{train3d_bound(n, 16, k, 2, 0, 'fwd', itemsize=2)[0]:.4f}, "
          f"{train3d_bound(n, 16, k, 2, 1, 'bwd', itemsize=2)[0]:.4f}")
    return res


def phase_fixture_3d():
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.models import UNetPNIEmbeddingDeep

    data = np.load(os.path.join(REPO, "tests", "fixtures", "unet_pni_deep.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    model = UNetPNIEmbeddingDeep(1, (8, 12, 16, 24, 32), 8)
    model.load_state_dict(sd)
    model = model.cuda().eval()
    with torch.no_grad(), float32_convs():
        outs = model(torch.from_numpy(data["input"]).cuda())
    for i, o in enumerate(outs):
        ref = data[f"out/{i}"]
        got = o.cpu().numpy()
        err = float(np.abs(got - ref).max())
        check(got.shape == ref.shape and np.isfinite(got).all(), f"3D fixture out/{i} shape")
        check(np.allclose(got, ref, **FIXTURE3D_TOL), f"3D fixture out/{i} max error {err}")
        print(f"[fixture3d] out/{i} {got.shape}: max error {err:.3e} of max |ref| "
              f"{np.abs(ref).max():.1f} (bound atol {FIXTURE3D_TOL['atol']}, "
              f"rtol {FIXTURE3D_TOL['rtol']})")


def phase_serving_3d() -> dict:
    """The 3D serving main path, the defaults (the dense module through the
    engine's run); returns K5f's launches in it and its error against the
    plain version on a served embedding. The folded-BatchNorm fast graph
    (fast_tiled_infer) is held and timed beside it."""
    import torch
    import torch.nn.functional as F

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import synthesize_volume
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import build_model, run_inference_3d
    from pixel_embedded_affinity_torch.infer.inference3d import build_tiled_predictor, serves_fast
    from pixel_embedded_affinity_torch.models import build_fast_pni_forward
    from pixel_embedded_affinity_torch.ops import (
        SHIFTS_3D, affinity_3d_plain, embedding_to_affinity_3d, fused_affinity_3d)
    from pixel_embedded_affinity_torch.parallel import TiledInference3D, tile_grid

    cfg = load_config("ac3ac4")
    check(not serves_fast(cfg), "ac3ac4 preset: the dense module serves by default")
    torch.manual_seed(SEED)
    sd = build_model(cfg, device="cpu").state_dict()
    t0 = time.perf_counter()
    raw, label = synthesize_volume(*VOLUME_3D, n_cells=VOLUME_CELLS, seed=SEED)
    vol = raw.astype(np.float32) / 255.0
    crop, stride, padding = tuple(cfg.data.crop_size), (10, 80, 80), (4, 48, 48)
    print(f"[serve3d] ac3ac4 UNetPNIEmbeddingDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}; synthetic volume {vol.shape}, {VOLUME_CELLS} cells, made in "
          f"{time.perf_counter() - t0:.2f} s; tiles {crop}, stride {stride}, padding {padding}, "
          f"batch 4; the dense module through the engine's run; convs in float32 (TF32 off)")

    model = build_model(cfg, sd, device="cuda")
    fast, dense = build_tiled_predictor(model, fast=True), build_tiled_predictor(model)
    # warm-up (cuDNN picks its algorithms at the first call of a shape) and
    # profile on a sub-volume whose 18 tiles end in a short batch of 2, as
    # the full volume's 338 do
    sub = np.ascontiguousarray(vol[:, :224, :224])
    engine = TiledInference3D(crop_size=crop, batch_size=4)
    for p in (dense, fast):
        engine.run(sub, p, len(SHIFTS_3D), device="cuda")
    device_breakdown(lambda: engine.run(sub, dense, len(SHIFTS_3D), device="cuda"), 5,
                     iters=2, label="3D engine, 18 tiles in 5 batches", unit="batch",
                     ours=("affinity3d_fwd_kernel",), require=("affinity3d_fwd_kernel",))

    timing: dict = {}
    fused_affinity_3d.launches = 0
    affs, results = run_inference_3d(cfg, sd, vol, gt=label, timing=timing, device="cuda")
    launches = fused_affinity_3d.launches
    print(f"[serve3d] K5f launches {launches} (expected {K5_LAUNCHES}); timing "
          f"{json.dumps(timing)}; {card_line()}")
    rest = (timing["total_s"] - timing["forward_s"] - sum(timing["decode_s"].values())
            - sum(timing["metrics_s"].values()))
    print(f"[serve3d] wall {timing['total_s']:.4f} s = forward {timing['forward_s']:.4f} + "
          + " + ".join(f"{d} decode {timing['decode_s'][d]:.4f} + metrics "
                       f"{timing['metrics_s'][d]:.4f}" for d in timing["decode_s"])
          + f" + rest {rest:.4f}; setup {timing['setup_s']:.4f}")
    check(launches == K5_LAUNCHES, f"K5f launched {launches} times")
    check(affs.shape == (len(SHIFTS_3D),) + VOLUME_3D and affs.dtype == np.float32,
          f"canvas {affs.shape} {affs.dtype}")
    check(bool(np.isfinite(affs).all()) and affs.min() >= 0 and affs.max() <= 1 + 1e-5,
          "canvas values outside [0, 1]")
    for dec, (seg, m) in results.items():
        print(f"[serve3d] {dec}: {len(np.unique(seg))} segments; {json.dumps(m)}")
        check(seg.shape == VOLUME_3D, f"{dec} segmentation shape")
        check(len(m) == 4 and all(np.isfinite(v) for v in m.values()), f"{dec} metrics {m}")

    # one tile batch: the two graphs' device time in float32 and bfloat16,
    # K5f on each graph's embedding, both graphs against float64
    pz, py, px = padding
    volp = F.pad(torch.from_numpy(vol).cuda()[None, None], (px, px, py, py, pz, pz),
                 mode="reflect")[0, 0]
    pos = tile_grid(tuple(volp.shape), crop, stride)
    check(len(pos) == TILES_3D, f"{len(pos)} tiles")
    cz, cy, cx = crop
    tiles = torch.stack([volp[z:z + cz, y:y + cy, x:x + cx] for z, y, x in pos[:4]])[:, None]
    m16 = build_model(cfg, sd, device="cuda", dtype="bfloat16")
    fast16, dense16 = build_tiled_predictor(m16, fast=True), build_tiled_predictor(m16)
    ms = {name: timed_ms(lambda p=p: p(tiles), n=10) for name, p in
          (("fast", fast), ("dense", dense), ("fast bf16", fast16), ("dense bf16", dense16))}

    def dense_tf32():
        with torch.no_grad():
            emb = tf32_convs(lambda: model(tiles)[4])()
            return fused_affinity_3d(emb.permute(0, 2, 3, 4, 1)).relu_()

    tf32_ms = timed_ms(dense_tf32, n=10)
    gflop = model_gflop(cfg, tuple(tiles.shape))
    print(f"[serve3d] device ms per tile batch (4 tiles, predictor + K5f + ReLU, warm median "
          f"of 10): dense {ms['dense']:.4f} (the main path), fast {ms['fast']:.4f} in "
          f"float32; dense {ms['dense bf16']:.4f}, fast {ms['fast bf16']:.4f} in bfloat16; "
          f"dense {tf32_ms:.4f} with TF32 convs (for reference); the dense module is "
          f"{gflop:.4f} GFLOP a batch: {gflop / ms['dense']:.4f} TFLOP/s; {card_line()}")
    with torch.no_grad(), float32_convs():
        emb_d = model(tiles)[4].permute(0, 2, 3, 4, 1)
        emb_f = build_fast_pni_forward(model)(tiles.permute(0, 2, 3, 4, 1))
        err_k = (fused_affinity_3d(emb_d) - affinity_3d_plain(emb_d)).abs().max().item()
        err_kf = (fused_affinity_3d(emb_f) - affinity_3d_plain(emb_f)).abs().max().item()
        emb64 = copy.deepcopy(model).double()(tiles.double())[4]
        ref = embedding_to_affinity_3d(emb64.permute(0, 2, 3, 4, 1)).relu()
    err = {name: (p(tiles).double() - ref).abs().max().item()
           for name, p in (("dense", dense), ("fast", fast))}
    err_tf32 = (dense_tf32().double() - ref).abs().max().item()
    print(f"[serve3d] K5f vs plain on the dense module's embedding (strides "
          f"{tuple(emb_d.stride())}): {err_k:.3e}, on the fast graph's (strides "
          f"{tuple(emb_f.stride())}): {err_kf:.3e}; one batch's affinities vs the dense "
          f"module in float64: dense {err['dense']:.3e}, fast {err['fast']:.3e} (a TF32 "
          f"run: {err_tf32:.3e}; bound {AFF_ATOL})")
    check(err_k <= K5_F32_ATOL, f"K5f off its plain version by {err_k} on the main path")
    check(err_kf <= K5_F32_ATOL, f"K5f off its plain version by {err_kf} on the fast graph")
    for name, e in err.items():
        check(e <= AFF_ATOL, f"served 3D affinities ({name}) off the float64 run by {e}")

    @torch.no_grad()
    def predict_plain(t):
        with float32_convs():
            return affinity_3d_plain(model(t)[4].permute(0, 2, 3, 4, 1)).relu_()

    plain = TiledInference3D(crop_size=crop, batch_size=4).run(
        vol, predict_plain, len(SHIFTS_3D), device="cuda")
    err_c = float(np.abs(affs - plain).max())
    print(f"[serve3d] canvas vs the same run through the plain affinity: {err_c:.3e}")
    check(err_c <= CANVAS_ATOL, f"canvas off the plain run by {err_c}")
    # the fast graph's canvas (fast_tiled_infer) against the main path's
    tf: dict = {}
    fast_affs, _ = run_inference_3d(load_config("ac3ac4", {"model": {"fast_tiled_infer": True}}),
                                    sd, vol, decoders=(), timing=tf, device="cuda")
    err_fd = float(np.abs(fast_affs - affs).max())
    print(f"[serve3d] fast canvas vs the dense module's: {err_fd:.3e} (bound "
          f"{FAST_CANVAS_ATOL}); forward s (upload, run, fetch): dense {timing['forward_s']:.4f} "
          f"(the main path), fast {tf['forward_s']:.4f}; {card_line()}")
    check(err_fd <= FAST_CANVAS_ATOL, f"the fast canvas off the dense one by {err_fd}")
    decode_labels_canvas(label)
    z, y, x = DECODE_CROP
    return {"launches": launches, "max_abs_err": err_k, "volume": (raw, label),
            "crop": (affs[:, :z, :y, :x].copy(), label[:z, :y, :x].copy())}


class VolumeCrops:
    """The 3D host provider's training set: random crops of a volume,
    (image (D, H, W, 1) in [0, 1], seg (D, H, W)), each flipped along z, y
    and x at random."""

    def __init__(self, raw: np.ndarray, label: np.ndarray, crop):
        self.raw, self.label, self.crop = raw, label, tuple(crop)

    def sample(self, rng):
        sl = tuple(slice(o, o + c) for o, c in
                   zip((int(rng.integers(n - c + 1)) for n, c in zip(self.raw.shape, self.crop)),
                       self.crop))
        img, seg = self.raw[sl].astype(np.float32) / 255.0, self.label[sl]
        for axis in range(3):
            if rng.random() < 0.5:
                img, seg = np.flip(img, axis), np.flip(seg, axis)
        return {"image": np.ascontiguousarray(img[..., None]), "seg": np.ascontiguousarray(seg)}


def _train3d_launchers():
    from pixel_embedded_affinity_torch.ops import (
        affinity_bwd, cross_affinity_bwd, cross_affinity_fwd, fused_affinity_3d)

    return {"K5f": fused_affinity_3d, "K5b": affinity_bwd, "K6f": cross_affinity_fwd,
            "K6b": cross_affinity_bwd}


def train3d_data():
    """((training arrays, validation volume), validation tile batches) of
    the 3D training phases: the whole synthetic TRAIN3D_VOLUME as the
    training split, through the loader, and a synthetic VALID3D_VOLUME."""
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import AC3AC4ValidVolume, synthesize_volume
    from pixel_embedded_affinity_torch.data.device_data import load_ac3ac4_arrays
    from pixel_embedded_affinity_torch.parallel import tile_grid
    from pixel_embedded_affinity_torch.train import valid_geometry_3d

    crop = load_config("ac3ac4").data.crop_size
    arrays = load_ac3ac4_arrays("", train_split=TRAIN3D_VOLUME[0], crop_z=crop[0],
                                arrays=synthesize_volume(*TRAIN3D_VOLUME, n_cells=TRAIN3D_CELLS,
                                                         seed=SEED + 3))
    valid = AC3AC4ValidVolume("", arrays=synthesize_volume(*VALID3D_VOLUME,
                                                           n_cells=VALID3D_CELLS, seed=SEED + 4))
    stride, pad = valid_geometry_3d(crop)
    n_tiles = len(tile_grid(tuple(np.add(VALID3D_VOLUME, np.multiply(pad, 2))), crop, stride))
    return (arrays, valid), -(-n_tiles // 4)


def phase_train_3d() -> dict:
    """The 3D training main path; returns each kernel's launches in it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.device_data import (
        sample_ac3ac4_batch, sampler_generator)
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops.upsample_cuda import upsample_bwd
    from pixel_embedded_affinity_torch.train import (
        TrainStep3D, init_state, latest_checkpoint, load_checkpoint, restore, train)

    out = os.path.join(REPO, "build", "chip_smoke_train3d")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config("ac3ac4", {
        "train": {"display_freq": 1, "valid_freq": TRAIN_STEPS, "save_freq": 10 ** 6},
        "save_path": os.path.join(out, "models")})
    t0 = time.perf_counter()
    check(cfg.data.device_resident, "ac3ac4 preset: device_resident")
    (arrays, valid), valid_batches = train3d_data()
    print(f"[train3d] ac3ac4 UNetPNIEmbeddingDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, B={cfg.train.batch_size} crops {cfg.data.crop_size} from the "
          f"device-resident sampler (margin {cfg.data.padding_3d}) over a synthetic "
          f"{TRAIN3D_VOLUME} volume, {TRAIN_STEPS} steps; validation on a synthetic "
          f"{VALID3D_VOLUME} volume (AC4's is 20x1024x1024): "
          f"{valid_batches} batches, decoders {cfg.train.valid_decoders}; volumes made in "
          f"{time.perf_counter() - t0:.2f} s; convs in float32 (TF32 off)")

    launchers = _train3d_launchers()
    for fn in launchers.values():
        fn.launches = 0
    upsample_bwd.launches = 0
    timing: dict = {}
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=TRAIN_STEPS, data_override=(arrays, valid),
                           device="cuda", log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    launches["UPb"] = upsample_bwd.launches
    print(f"[train3d] {wall:.2f} s for {TRAIN_STEPS} steps + validation + checkpoint; "
          f"launches {json.dumps(launches)}")
    for k, n in [("K5f", TRAIN_STEPS + valid_batches), ("K5b", TRAIN_STEPS),
                 ("K6f", TRAIN_STEPS), ("K6b", TRAIN_STEPS), ("UPb", UP_PER_STEP * TRAIN_STEPS)]:
        check(launches[k] == n, f"{k} launched {launches[k]} times, expected {n}")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[train3d] loss per step: {losses}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), "a non-finite loss")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
          f"validation {history}")
    print(f"[train3d] validation ({timing['valid_s'][0]:.4f} s wall): {json.dumps(history[0])}")
    print_step_times("train3d", timing, TRAIN_STEPS, HOST_DATA_MS["ac3ac4"])

    # the checkpoint gives the trained state's next-step loss, bit for bit
    ck = latest_checkpoint(os.path.join(cfg.save_path, cfg.name))
    check(ck is not None and ck.endswith(f"model-{TRAIN_STEPS:06d}.ckpt"), f"checkpoint {ck}")
    loaded = restore(init_state(cfg, "cuda"), load_checkpoint(ck))
    step = TrainStep3D(ema_seed=cfg.train.random_seed)
    raw, labels = (torch.from_numpy(a).cuda() for a in arrays)
    batch = step.ema_batch(sample_ac3ac4_batch(raw, labels,
                                               sampler_generator(cfg.train.random_seed,
                                                                 loaded.step),
                                               cfg.train.batch_size,
                                               crop_size=tuple(cfg.data.crop_size),
                                               padding=cfg.data.padding_3d), loaded.step)

    def next_loss(model):
        model = copy.deepcopy(model).train()
        with torch.no_grad(), float32_convs():
            return step.loss(model, batch)[0].item()

    la, lb = next_loss(state.model), next_loss(loaded.model)
    print(f"[train3d] next-step loss: trained state {la!r}, reloaded checkpoint {lb!r}")
    check(la == lb and loaded.step == state.step == TRAIN_STEPS, "checkpoint reload differs")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step(loaded, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train3d] device memory of one step: peak {peak / 2 ** 30:.4f} GiB allocated "
          f"({(peak - base) / 2 ** 30:.4f} GiB above the {base / 2 ** 30:.4f} GiB held before "
          f"it), {card_line()}")
    step_kernels = ("affinity3d_fwd_kernel", "affinity_bwd_kernel", "cross_affinity_fwd_kernel",
                    "cross_affinity_bwd_kernel")
    device_breakdown(lambda: step(loaded, batch), 1, iters=3,
                     label="train3d step B=2 18x160x160", unit="step", ours=step_kernels,
                     require=step_kernels)
    # the layout the step hands the 3D kernels: its model's embedding output
    from pixel_embedded_affinity_torch.data.ac3ac4 import convert_consistency_flip_3d_rule4
    from pixel_embedded_affinity_torch.train.train_step import _bdhwc, _ncdhw

    model = copy.deepcopy(loaded.model).train()
    with torch.no_grad():
        emb = model(_ncdhw(batch["image"]))[4]
        ema = model(_ncdhw(batch["ema_image"]))[4]
    student = _bdhwc(emb)
    teacher = convert_consistency_flip_3d_rule4(_bdhwc(ema), batch["rules"])
    print(f"[train3d] the step's embedding {tuple(emb.shape)} strides {emb.stride()} "
          f"(channels-last: {emb.is_contiguous(memory_format=torch.channels_last_3d)}); the "
          f"cross kernels' student (B, D, H, W, C) strides {student.stride()}, the un-flipped "
          f"teacher's {teacher.stride()} (rules {batch['rules'].tolist()})")
    check(teacher.stride() == student.stride(), "the un-flipped teacher's strides differ "
          "from the student's")
    train_precision(state.model, batch,
                    lambda use_pallas: TrainStep3D(use_pallas=use_pallas, device_ema=False),
                    BIAS_BEFORE_BN_3D, label="train3d")
    # the host provider's path, on crops of the same training volume
    host = provider_run("ac3ac4", VolumeCrops(*arrays, cfg.data.crop_size), launchers,
                        {"K5f": 1, "K5b": 1, "K6f": 1, "K6b": 1}, "train3d")
    run = {"cfg": cfg, "data": (arrays, valid), "losses": losses,
           "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
           "step_ms": 1e3 * float(np.median(timing["step_s"][1:]))}
    return {"launches": {k: launches[k] + host.get(k, 0) for k in launches}, "run": run}


def _bbbc_launchers():
    from pixel_embedded_affinity_torch.ops import (
        affinity_bwd, cross_affinity_bwd, fused_affinity_2d, fused_cross_affinity_2d)

    return {**_wmse_launchers(), "K1f": fused_affinity_2d, "K1b": affinity_bwd,
            "K4f": fused_cross_affinity_2d, "K4b": cross_affinity_bwd}


def _train_run(cfg, data, steps: int, out: str, label: str):
    """train() on the card with every 2D kernel's count set to 0 just before;
    returns (state, history, timing, launches)."""
    from pixel_embedded_affinity_torch.train import train

    launchers = _bbbc_launchers()
    for fn in launchers.values():
        fn.launches = 0
    timing: dict = {}
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=steps, data_override=data, device="cuda",
                           log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    print(f"[{label}] {wall:.2f} s for {steps} steps + validation + checkpoint; "
          f"launches {json.dumps(launches)}")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[{label}] loss per step: {losses}")
    check(len(losses) == steps and all(np.isfinite(losses)), "a non-finite loss")
    data_ms = [1e3 * t for t in timing["data_s"][1:]]
    step_ms = [1e3 * t for t in timing["step_s"][1:]]
    print(f"[{label}] warm ms/step (steps 2..{steps}, median): data "
          f"{np.median(data_ms):.4f} + step {np.median(step_ms):.4f} = "
          f"{np.median(np.add(data_ms, step_ms)):.4f}; first step "
          f"{1e3 * (timing['data_s'][0] + timing['step_s'][0]):.4f}; {card_line()}")
    return state, history, timing, launches


def bbbc_setup():
    """The bbbc039v1 config's padded training arrays (8 synthetic 520x696
    nuclei images) and 2 validation images."""
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import BBBCValidation, synthesize_nuclei
    from pixel_embedded_affinity_torch.data.device_data import pad_bbbc_arrays

    cfg = load_config("bbbc039v1")
    t0 = time.perf_counter()
    arrays = pad_bbbc_arrays(synthesize_nuclei(BBBC_TRAIN_IMAGES, *BBBC_SHAPE, seed=SEED + 6),
                             cfg.data.bbbc_padding)
    valid = BBBCValidation(pairs=synthesize_nuclei(BBBC_VALID_IMAGES, *BBBC_SHAPE,
                                                   seed=SEED + 7),
                           shifts=cfg.data.shifts, neighbor=cfg.data.neighbor)
    print(f"[bbbc] {BBBC_TRAIN_IMAGES} synthetic {BBBC_SHAPE} training images padded to "
          f"{arrays[0].shape[1:]}, {len(valid)} validation images, made in "
          f"{time.perf_counter() - t0:.2f} s")
    return arrays, valid


def phase_train_bbbc(arrays, valid) -> dict:
    """The BBBC training main path: the device-resident sampler, the mask
    head, the loss-fused kernels; returns each kernel's launches in it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.device_data import (
        sample_bbbc_batch, sampler_generator)
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad
    from pixel_embedded_affinity_torch.train import (
        TrainStep2D, init_state, latest_checkpoint, load_checkpoint, restore)

    out = os.path.join(REPO, "build", "chip_smoke_bbbc")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config("bbbc039v1", {
        "train": {"display_freq": 1, "valid_freq": TRAIN_STEPS, "save_freq": 10 ** 6},
        "save_path": os.path.join(out, "models")})
    check(cfg.data.device_resident and cfg.train.mask_weight == 1000.0, "bbbc039v1 preset")
    print(f"[bbbc-train] bbbc039v1 ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, mask weight {cfg.train.mask_weight}, B={cfg.train.batch_size} "
          f"crops {cfg.data.size}x{cfg.data.size} (padding {cfg.data.bbbc_padding}) from the "
          f"device-resident sampler, {TRAIN_STEPS} steps, validation on {len(valid)} "
          f"{BBBC_SHAPE} images, convs in float32 (TF32 off)")
    conv_wgrad.launches = conv_dgrad.launches = 0
    state, history, timing, launches = _train_run(cfg, (arrays, valid), TRAIN_STEPS, out,
                                                  "bbbc-train")
    conv_grad = {"CWg": conv_wgrad.launches, "CXg": conv_dgrad.launches}
    n_w, n_x = conv_grads_per_step("bbbc039v1", arrays)
    print(f"[bbbc-train] CWg and CXg launches {json.dumps(conv_grad)}: {n_w} and {n_x} a step")
    for k, per_step in [("K2f", 5), ("K2b", 5), ("K3f", 1), ("K3b", 1)]:
        check(launches[k] == per_step * TRAIN_STEPS,
              f"{k} launched {launches[k]} times in {TRAIN_STEPS} steps")
    check(conv_grad == {"CWg": n_w * TRAIN_STEPS, "CXg": n_x * TRAIN_STEPS},
          f"CWg, CXg launched {conv_grad} times in {TRAIN_STEPS} steps")
    check(launches["K1f"] == len(valid) and launches["K4f"] == launches["K1b"] == 0,
          f"launches {launches}")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values())
          and {"valid/AJI", "valid/F1", "valid/PQ"} <= set(history[0]), f"validation {history}")
    print(f"[bbbc-train] validation ({timing['valid_s'][0]:.4f} s wall): "
          f"{json.dumps(history[0])}")

    ck = latest_checkpoint(os.path.join(cfg.save_path, cfg.name))
    check(ck is not None and ck.endswith(f"model-{TRAIN_STEPS:06d}.ckpt"), f"checkpoint {ck}")
    loaded = restore(init_state(cfg, "cuda"), load_checkpoint(ck))
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    step = TrainStep2D(offsets, mask_weight=cfg.train.mask_weight, imagenet_norm=False,
                       ema_seed=cfg.train.random_seed)
    images, labels = (torch.from_numpy(a).cuda() for a in arrays)
    batch = step.ema_batch(sample_bbbc_batch(images, labels,
                                             sampler_generator(cfg.train.random_seed,
                                                               loaded.step),
                                             cfg.train.batch_size, size=cfg.data.size,
                                             padding=cfg.data.bbbc_padding), loaded.step)
    check(batch["image"].shape == (2, 256, 256, 3) and batch["seg"].dtype == torch.int32,
          "device sampler batch")

    def next_loss(model):
        model = copy.deepcopy(model).train()
        with torch.no_grad(), float32_convs():
            return step.loss(model, batch)[0].item()

    la, lb = next_loss(state.model), next_loss(loaded.model)
    print(f"[bbbc-train] next-step loss: trained state {la!r}, reloaded checkpoint {lb!r}")
    check(la == lb and loaded.step == state.step == TRAIN_STEPS, "checkpoint reload differs")
    rows = device_breakdown(lambda: step(loaded, batch), 1, iters=3,
                            label="bbbc train step B=2 256x256", unit="step",
                            ours=("wmse", "affinity2d_fwd_kernel"), require=WMSE_KERNELS,
                            in_order=WMSE_KERNELS)
    check_k3b_form(rows, "bbbc train step B=2 256x256")
    sampler_ms = timed_ms(lambda: sample_bbbc_batch(
        images, labels, sampler_generator(0, 1), 2, size=cfg.data.size,
        padding=cfg.data.bbbc_padding), n=10)
    print(f"[bbbc-train] device sampler: {sampler_ms:.4f} ms a batch of 2 on the device "
          f"(median of 10)")
    return {"launches": launches, "batch": batch, "state": loaded, "conv_grad": conv_grad}


def phase_unfused_bbbc(arrays, fused_batch, fused_state) -> dict:
    """The unfused 2D path (train.fuse_loss=False) on the bbbc039v1 preset:
    K1f/K1b five times a step, K4f/K4b once; on one batch its loss and
    parameter gradients against the fused step's. Returns the launches."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.train import TrainStep2D

    out = os.path.join(REPO, "build", "chip_smoke_bbbc_unfused")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config("bbbc039v1", {
        "train": {"fuse_loss": False, "if_valid": False, "display_freq": 1,
                  "save_freq": 10 ** 6},
        "save_path": os.path.join(out, "models")})
    _, _, _, launches = _train_run(cfg, (arrays, None), UNFUSED_STEPS, out, "unfused")
    for k, per_step in [("K1f", 5), ("K1b", 5), ("K4f", 1), ("K4b", 1),
                        ("K2f", 0), ("K2b", 0), ("K3f", 0), ("K3b", 0)]:
        check(launches[k] == per_step * UNFUSED_STEPS,
              f"{k} launched {launches[k]} times in {UNFUSED_STEPS} unfused steps")

    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    unfused_step = TrainStep2D(offsets, mask_weight=cfg.train.mask_weight, fuse_loss=False,
                               imagenet_norm=False, device_ema=False)
    state = copy.deepcopy(fused_state)
    device_breakdown(lambda: unfused_step(state, fused_batch), 1, iters=3,
                     label="unfused bbbc train step B=2 256x256", unit="step",
                     ours=("affinity2d_fwd_kernel", "affinity_bwd_kernel",
                           "cross_affinity_fwd_kernel", "cross_affinity_bwd_kernel"))
    runs = {}
    for name, fused in [("fused", True), ("fused again", True), ("unfused", False)]:
        step = TrainStep2D(offsets, mask_weight=cfg.train.mask_weight, fuse_loss=fused,
                           imagenet_norm=False, device_ema=False)
        model = copy.deepcopy(fused_state.model)
        _, metrics = step.grads(model, fused_batch)
        runs[name] = ({k: v.item() for k, v in metrics.items()},
                      {n: p.grad for n, p in model.named_parameters()})
    torch.cuda.synchronize()
    ref_m, ref_g = runs["fused"]

    top = max(r.abs().max().item() for r in ref_g.values())

    def worst(name):
        """The largest relative loss difference, and gradient difference
        relative to each tensor's largest; a conv bias in front of
        BatchNorm (true gradient 0, rounding noise) relative to the largest
        of all."""
        m, g = runs[name]
        loss = max(abs(m[k] - ref_m[k]) / max(abs(ref_m[k]), 1e-30) for k in ref_m)
        grad = max((g[n] - r).abs().max().item()
                   / (top if BIAS_BEFORE_BN.search(n) else r.abs().max().item())
                   for n, r in ref_g.items())
        return loss, grad

    (spread_l, spread_g), (err_l, err_g) = worst("fused again"), worst("unfused")
    print(f"[unfused] one batch, unfused vs fused step: losses rel {err_l:.3e} (bound "
          f"{UNFUSED_LOSS_RTOL}), parameter gradients rel to each tensor's largest "
          f"{err_g:.3e} (bound {UNFUSED_GRAD_RTOL}); the fused step against itself "
          f"{spread_l:.3e}, {spread_g:.3e}; metrics {json.dumps(runs['unfused'][0])}")
    check(err_l <= UNFUSED_LOSS_RTOL, f"unfused loss off the fused one by {err_l}")
    check(err_g <= UNFUSED_GRAD_RTOL, f"unfused gradients off the fused ones by {err_g}")
    return launches


def _serve_bbbc_timed(cfg, sd, samples, bs, label: str) -> int:
    """run_inference_2d at batch ``bs`` (None: the server's default), warm,
    its split printed; returns K1f's launches in the timed run."""
    from pixel_embedded_affinity_torch.infer import run_inference_2d, serve_batch
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d

    run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda")  # warm-up
    timing: dict = {}
    fused_affinity_2d.launches = 0
    per, agg = run_inference_2d(cfg, sd, samples, timing=timing, batch_size=bs, device="cuda")
    bs = bs or serve_batch(samples[0]["image"].shape)
    expected = -(-len(samples) // bs)
    parts = {k: timing[k] for k in ("setup_s", "forward_s", "decode_s", "metrics_s")}
    parts["rest_s"] = timing["total_s"] - sum(parts.values())
    print(f"[bbbc-serve] {label} B={bs}: K1f launches {fused_affinity_2d.launches} (expected "
          f"{expected}); ms/img: wall {timing['total_s'] / len(samples) * 1e3:.4f} = "
          + " + ".join(f"{k[:-2]} {v / len(samples) * 1e3:.4f}" for k, v in parts.items())
          + f"; decode share {parts['decode_s'] / timing['total_s']:.4f}"
          + f"; metrics {json.dumps(agg)}")
    check(fused_affinity_2d.launches == expected, f"K1f launched at B={bs}")
    check(len(per) == len(samples) and all(
        set(m) == {"SBD", "DiC", "VOI", "ARAND", "AJI", "F1", "DQ", "SQ", "PQ"}
        and all(np.isfinite(v) for v in m.values()) for m in per), f"metrics {per}")
    return fused_affinity_2d.launches


def phase_serving_bbbc() -> dict:
    """BBBC serving at full width on synthetic 520x696 images; returns K1f's
    launches in it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import BBBCValidation, synthesize_nuclei
    from pixel_embedded_affinity_torch.infer import build_model, forward_affinities
    from pixel_embedded_affinity_torch.ops import embedding_to_affinity_2d, multi_offset

    cfg = load_config("bbbc039v1")
    torch.manual_seed(SEED)
    sd = build_model(cfg, device="cpu").state_dict()
    ds = BBBCValidation(pairs=synthesize_nuclei(BBBC_SERVE_IMAGES, *BBBC_SHAPE, seed=SEED + 8),
                        shifts=cfg.data.shifts, neighbor=cfg.data.neighbor)
    samples = [ds[i] for i in range(len(ds))]
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    x_all = torch.from_numpy(np.stack([s["image"] for s in samples])).cuda()
    x_all = x_all.permute(0, 3, 1, 2).contiguous()
    print(f"[bbbc-serve] bbbc039v1 ResidualUNet2DDeep filters {cfg.model.filters} emd "
          f"{cfg.model.emd}, {len(samples)} synthetic images {samples[0]['image'].shape}, "
          f"mask-seeded decode (strides {cfg.data.strides}), convs in float32 (TF32 off)")

    def predicted_fg(state):
        _, mask = forward_affinities(build_model(cfg, state, device="cuda"), x_all[:1],
                                     offsets, with_mask=True)
        return mask[0, ..., 1] - mask[0, ..., 0]

    # random weights mark every pixel as foreground: the decode's worst case
    print(f"[bbbc-serve] random weights: predicted foreground "
          f"{(predicted_fg(sd) > 0).float().mean().item():.4f} of the first image")
    launches = _serve_bbbc_timed(cfg, sd, samples, 1, "full mask (worst case)")
    # as a trained model would, mark about the share the nuclei cover: the
    # mask head's last bias moved to the first image's quantile of the logit
    # margin at that share
    share = float(np.mean(samples[0]["seg"] > 0))
    sd["binary_seg.3.bias"][1] -= torch.quantile(predicted_fg(sd), 1.0 - share).cpu()
    fg0 = (predicted_fg(sd) > 0).float().mean().item()
    print(f"[bbbc-serve] mask-head bias moved: predicted foreground {fg0:.4f} of the "
          f"first image, its nuclei {share:.4f}")
    check(0.5 * share < fg0 < 2 * share, "the moved bias marks the nuclei's share")
    for bs in (1, 4, None):
        launches += _serve_bbbc_timed(cfg, sd, samples, bs, "nuclei-share mask")

    model = build_model(cfg, sd, device="cuda")
    # B=4 takes ~1 s a call at this size (cuDNN's FFT-tiled choice): fewer
    # repeats there
    for bs, n in ((1, 20), (4, 2)):
        x = x_all[:bs]
        ms = timed_ms(lambda: forward_affinities(model, x, offsets, with_mask=True), n=n)
        print(f"[bbbc-serve] forward + affinity + mask logits B={bs}: {ms / bs:.4f} ms/img, "
              f"warm median of {n}, {card_line()}")
        device_breakdown(lambda: forward_affinities(model, x, offsets, with_mask=True), bs,
                         iters=5 if bs == 1 else 1, label=f"bbbc serve B={bs} 520x696",
                         ours=("affinity2d_fwd_kernel",))
    # cuDNN's own algorithm search, for reference (the server runs its
    # heuristics' choice); at B=1 only (B=4's search and calls took ~10 s:
    # 201.6 ms/img, no better than its heuristics' 170.8; PERF.md)
    torch.backends.cudnn.benchmark = True
    try:
        for bs, n in ((1, 10),):
            x = x_all[:bs]
            ms = timed_ms(lambda: forward_affinities(model, x, offsets, with_mask=True), n=n)
            print(f"[bbbc-serve] with cudnn.benchmark, B={bs}: {ms / bs:.4f} ms/img, median "
                  f"of {n}")
    finally:
        torch.backends.cudnn.benchmark = False
    x = x_all[:1]
    affs, mask = forward_affinities(model, x, offsets, with_mask=True)
    check(affs.shape == (1, len(offsets)) + BBBC_SHAPE and mask.shape == (1,) + BBBC_SHAPE
          + (2,), "served shapes")
    with torch.no_grad():
        outs64 = build_model(cfg, sd, device="cuda").double()(x.double())
        ref = embedding_to_affinity_2d(outs64[4].permute(0, 2, 3, 1), offsets,
                                       padding="valid").relu()
        ref_mask = outs64[5].permute(0, 2, 3, 1)
    err = (affs.double() - ref).abs().max().item()
    err_m = ((mask.double() - ref_mask).abs().max() / ref_mask.abs().max()).item()
    fg = (mask[..., 1] > mask[..., 0]).float().mean().item()
    print(f"[bbbc-serve] one image vs float64: affinities {err:.3e} (bound {AFF_ATOL}), mask "
          f"logits {err_m:.3e} of the largest (bound {AFF_ATOL}); predicted foreground "
          f"{fg:.4f} of the pixels (the moved bias)")
    check(err <= AFF_ATOL and err_m <= AFF_ATOL, "served BBBC outputs off float64")
    return {"launches": launches}


def decode_labels_canvas(label: np.ndarray):
    """The decoders' host time on a canvas with the synthetic volume's cells
    in it (random weights give a near-uniform one): noisy label-derived
    affinities of the first LABELS_CANVAS in z, y, x."""
    from pixel_embedded_affinity_torch.data import label_affinities
    from pixel_embedded_affinity_torch.infer import decode
    from pixel_embedded_affinity_torch.metrics import adapted_rand_error, voi

    gt = np.ascontiguousarray(label[tuple(slice(n) for n in LABELS_CANVAS)])
    affs = label_affinities(gt, SEED)
    for dec in ("mutex", "waterz", "lmc"):
        t0 = time.perf_counter()
        seg = decode(affs, dec)
        t_dec = time.perf_counter() - t0
        vs, vm = voi(gt, seg)
        are = adapted_rand_error(gt, seg)[0]
        print(f"[serve3d] labels canvas {gt.shape}, {dec}: decode {t_dec:.4f} s, "
              f"{len(np.unique(seg))} segments ({len(np.unique(gt))} cells), VOI "
              f"{vs + vm:.4f}, ARAND {are:.4f}")
        check(np.isfinite(vs + vm + are), f"{dec} metrics on the labels canvas")


def rel_err(got, ref) -> float:
    """max |got - ref| relative to max |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def rel_err64(got, ref) -> float:
    """:func:`rel_err` in float64 (rel_err rounds both to float32 first)."""
    ref = ref.double()
    return ((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def conv_bound(n_px: int, cin: int, cout: int, taps: int, itemsize: int, n_ops_px=None,
               f32_rate: float = TF32X3_FLOPS_PER_S):
    """Least time of a conv that reads n_px input pixels and writes n_px
    output pixels, n_ops_px of them (n_px by default) with taps x Cin x Cout
    multiply-adds each, the rest plain zeros: its input, weights and output
    each moved once over HBM, vs 2 flops a multiply-add at the rate of the
    kernel's path: float32 at ``f32_rate`` (3xTF32 on the tensor cores by
    default; F32_FLOPS_PER_S for the CUDA cores), bfloat16 at the tensor
    cores' rate."""
    n_ops = n_px if n_ops_px is None else n_ops_px
    nbytes = (n_px * (cin + cout) + taps * cin * cout) * itemsize + 8 * cout
    rate = f32_rate if itemsize == 4 else BF16_FLOPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * taps * cin * cout * n_ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_conv(x, w, scale, shift, relu: bool):
    """cuDNN's F.conv2d of the NHWC x as a channels-last NCHW view, the scale
    folded into the weights and the shift as its bias (both in x's dtype),
    TF32 off, then an in-place ReLU: one PyTorch call for K7's function."""
    import torch
    import torch.nn.functional as F

    from pixel_embedded_affinity_torch.device import float32_convs

    xc = x.permute(0, 3, 1, 2)
    wf = (w.float() * scale).to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bias = shift.to(x.dtype)

    def run():
        with float32_convs():
            y = F.conv2d(xc, wf, bias, padding=1)
        return y.relu_() if relu else y
    return run


def ptxas_info(source: str) -> dict:
    """{kernel's mangled name: what ``-Xptxas -v`` said of it (registers,
    shared memory, spills)} from the build log of ``csrc/<source>``."""
    from pixel_embedded_affinity_torch import cuda_build

    info, entry = {}, None
    with open(cuda_build.library_path(os.path.basename(source))[:-3] + ".log") as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = m.group(1)
            elif entry and ("spill" in ln or "Used" in ln):
                info[entry] = (info.get(entry, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return info


def demangled(names) -> list:
    names = list(names)
    if not shutil.which("c++filt"):
        return names
    return subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                          text=True).stdout.split("\n")[:len(names)]


def ptxas_report(source: str) -> dict:
    """Print each kernel of ``csrc/<source>`` with its registers, shared
    memory and spills; return them by mangled name."""
    info = ptxas_info(source)
    for name, nice in zip(info, demangled(info)):
        print(f"[ptxas] {os.path.basename(source)} {nice}: {info[name]}")
    return info


def sass_report(source: str) -> dict:
    """One line for the library of ``csrc/<source>``: each kernel's
    tensor-core instructions (HMMA lines of ``cuobjdump -sass``) and what
    ``-Xptxas -v`` said of it (registers, static shared memory, spills);
    returns {kernel: HMMA count}."""
    from pixel_embedded_affinity_torch import cuda_build

    so = cuda_build.library_path(source)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {so}: {out.stderr[-500:]}")
    hmma, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            hmma[fn] = 0
        elif fn and "HMMA" in ln:
            hmma[fn] += 1
    ptxas = ptxas_info(source)
    names = demangled(hmma)
    print(f"[sass] {os.path.basename(so)}: " + "; ".join(
        f"{nice}: {hmma[k]} HMMA, ptxas: {ptxas.get(k, 'n/a')}" for k, nice in zip(hmma, names)))
    check(len(hmma) > 0 and all(n > 0 for n in hmma.values()),
          f"{source}: a kernel without tensor-core instructions: {hmma}")
    return hmma


def capture_graph(fn):
    """fn() captured once in a CUDA graph after three warm-up calls on a
    side stream; returns the graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, n: int = 20, flush_bytes: int = 0) -> float:
    """Median device time of fn() in ms without the host's launch path: fn
    is captured once in a CUDA graph and each replay is timed by CUDA
    events. With ``flush_bytes``, a buffer that size is rewritten before
    each replay so the call starts with its inputs out of L2."""
    import torch

    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    graph = capture_graph(fn)
    times = []
    for _ in range(n + 3):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[3:]))


def graph_each_ms(fns: list, n: int = 96) -> float:
    """Device time of one call in ms, for a call short beside a graph
    replay's own start: fns[i % len(fns)]() for i < n captured in one CUDA
    graph, whose replay time (median of 10, CUDA events) is divided by n.
    The fns take distinct buffers, more bytes than L2 holds, so each call
    finds its inputs out of L2 as a flushed call does."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    times = []
    for _ in range(13):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[3:])) / n


def kernel_times(fns: dict, flush_bytes: int) -> dict:
    """Each fn's device time a call, by name: a CUDA graph's replay
    (``name``; the device's own time) and CUDA events around the eager call,
    which also count the host's launch path while the card waits (``name``
    with "ms" -> "event_ms"); L2 flushed before each call, median of 20."""
    out = {}
    for name, fn in fns.items():
        out[name] = graph_ms(fn, flush_bytes=flush_bytes)
        out[name[:-2] + "event_ms"] = timed_ms(fn, flush_bytes=flush_bytes)
    return out


def phase_conv3x3() -> dict:
    """K7 (conv3x3_fused), K9a (conv3x3_blocked) and K9b (the canvas mode,
    conv3x3_blocked_chain's steps) against their plain versions: K7 and K9a
    at the fast forward's direct-stage shapes, an odd shape and 3 -> 16, in
    float32 and bfloat16; K9b chains of k C -> C convs on a 272x272 image,
    each step's canvas checked to be exactly 0 outside the image. The
    launches are those of these calls through the public wrappers (no model
    path reaches the three, in the JAX package either). Then each kernel's
    time with L2 flushed beside its plain version's, cuDNN's and the bound."""
    import torch

    from pixel_embedded_affinity_torch.ops import conv3x3_cuda
    from pixel_embedded_affinity_torch.ops.conv3x3_cuda import (
        blocked_egress, blocked_ingest, conv3x3_blocked, conv3x3_blocked_chain,
        conv3x3_blocked_flat, conv3x3_canvas_plain, conv3x3_fused, conv3x3_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def weights(cin, cout):
        return (rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5), 1 + 0.1 * rnd(cout),
                0.1 * rnd(cout))

    conv3x3_fused.launches = conv3x3_blocked.launches = conv3x3_blocked_flat.launches = 0
    res = {k: {"max_abs_err": 0.0} for k in CONV_NAMES}
    for b, h, w, cin, cout, relu in K7_SHAPES:
        x = rnd(b, h, w, cin)
        wt, sc, sh = weights(cin, cout)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            xi = x.to(dtype)
            ref = conv3x3_plain(xi, wt, sc, sh, relu)
            errs = {}
            for key, fn in (("K7", conv3x3_fused), ("K9a", conv3x3_blocked)):
                got = fn(xi, wt, sc, sh, relu)
                check(got.shape == (b, h, w, cout) and got.dtype == dtype, f"{key} shape/dtype")
                errs[key] = rel_err(got, ref)
                check(errs[key] <= (CONV_F32_RTOL if f32 else CONV_BF16_RTOL),
                      f"{key} {(b, h, w, cin, cout)} {dtype} error {errs[key]}")
                if f32:
                    res[key]["max_abs_err"] = max(res[key]["max_abs_err"],
                                                  (got - ref).abs().max().item())
            print(f"[conv] K7/K9a B={b} {h}x{w} {cin}->{cout} relu={relu} {str(dtype)[6:]}: "
                  f"rel error {errs['K7']:.3e}/{errs['K9a']:.3e}")
    for c, k in K9B_CHAINS:
        x = rnd(1, 272, 272, c)
        ws = [weights(c, c) for _ in range(k)]
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            xi = x.to(dtype)
            ref = xi
            for wt, sc, sh in ws:
                ref = conv3x3_plain(ref, wt, sc, sh, True)
            got = conv3x3_blocked_chain(xi, [p[0] for p in ws], [p[1] for p in ws],
                                        [p[2] for p in ws], relu=True)
            err = rel_err(got, ref)
            # the same chain step by step: the canvas outside the image exactly 0
            canvas, g = blocked_ingest(xi, k, k)
            oy = ox = k
            for wt, sc, sh in ws:
                canvas = conv3x3_blocked_flat(canvas, wt, g, oy, ox, sc, sh, relu=True)
                oy, ox = oy - 1, ox - 1
                outside = canvas.clone()
                outside[:, oy:oy + g.h, ox:ox + g.w] = 0
                check(bool((outside == 0).all()), f"K9b canvas not zero outside the image (C={c})")
            step_err = rel_err(blocked_egress(canvas, g, oy, ox), ref)
            print(f"[conv] K9b chain C={c} k={k} 272x272 {str(dtype)[6:]}: rel error {err:.3e} "
                  f"(steps {step_err:.3e}), canvas border exactly 0")
            tol = CONV_F32_RTOL if f32 else CONV_BF16_RTOL
            check(err <= tol and step_err <= tol, f"K9b C={c} k={k} {dtype} error {err}")
            if f32:
                res["K9b"]["max_abs_err"] = max(res["K9b"]["max_abs_err"],
                                                 (got - ref).abs().max().item())
    for key in CONV_NAMES:
        res[key]["launches"] = getattr(
            {"K7": conv3x3_fused, "K9a": conv3x3_blocked, "K9b": conv3x3_blocked_flat}[key],
            "launches")
    print(f"[conv] launches through the wrappers: "
          + ", ".join(f"{k} {res[k]['launches']}" for k in CONV_NAMES))
    check(all(res[k]["launches"] > 0 for k in CONV_NAMES), "a conv wrapper launched nothing")

    flush = 64 << 20  # beyond the 50 MB L2
    times = []
    for b, h, w, cin, cout, relu in K7_SHAPES:
        x = rnd(b, h, w, cin)
        wt, sc, sh = weights(cin, cout)
        xb, wb = x.bfloat16(), wt.bfloat16()
        t = {"shape": [b, h, w, cin, cout], **kernel_times({
            "ms": lambda: conv3x3_fused(x, wt, sc, sh, relu),
            "plain_ms": lambda: conv3x3_plain(x, wt, sc, sh, relu),
            "library_ms": library_conv(x, wt, sc, sh, relu),
            "bf16_ms": lambda: conv3x3_fused(xb, wb, sc, sh, relu),
            "bf16_library_ms": library_conv(xb, wb, sc, sh, relu)}, flush)}
        t["bound_ms"], t["bound_by"] = conv_bound(b * h * w, cin, cout, 9, 4)
        t["bf16_bound_ms"], t["bf16_bound_by"] = conv_bound(b * h * w, cin, cout, 9, 2)
        t["cuda_core_bound_ms"] = conv_bound(b * h * w, cin, cout, 9, 4,
                                             f32_rate=F32_FLOPS_PER_S)[0]
        times.append(t)
        print(f"[conv] K7 time {json.dumps(t)}, {card_line()}")
    head = times[0]  # 136x136 64 -> 256: down3's conv1 and project
    for key in ("K7", "K9a"):
        res[key].update({k: v for k, v in head.items() if k != "shape"})
    b, h, w, cin, cout, relu = K7_SHAPES[0]
    x = rnd(b, h, w, cin)
    wt, sc, sh = weights(cin, cout)
    xb, wb = x.bfloat16(), wt.bfloat16()
    res["K9a"].update(kernel_times({
        "ms": lambda: conv3x3_blocked(x, wt, sc, sh, relu),
        "bf16_ms": lambda: conv3x3_blocked(xb, wb, sc, sh, relu)}, flush))
    x = rnd(1, 272, 272, 64)
    wt, sc, sh = weights(64, 64)
    canvas, g = blocked_ingest(x, 2, 2)
    canvas_b, wb = canvas.bfloat16(), wt.bfloat16()
    t = kernel_times({
        "ms": lambda: conv3x3_blocked_flat(canvas, wt, g, 2, 2, sc, sh, True),
        "plain_ms": lambda: conv3x3_canvas_plain(canvas, wt, 2, 2, 272, 272, sc, sh, True),
        "library_ms": library_conv(canvas, wt, sc, sh, True),
        "bf16_ms": lambda: conv3x3_blocked_flat(canvas_b, wb, g, 2, 2, sc, sh, True),
        "bf16_library_ms": library_conv(canvas_b, wb, sc, sh, True)}, flush)
    # the canvas is read and written whole; only the image needs arithmetic
    n_px, n_img = g.b * g.height * g.width, g.b * g.h * g.w
    t["bound_ms"], t["bound_by"] = conv_bound(n_px, 64, 64, 9, 4, n_ops_px=n_img)
    t["bf16_bound_ms"], t["bf16_bound_by"] = conv_bound(n_px, 64, 64, 9, 2, n_ops_px=n_img)
    t["cuda_core_bound_ms"] = conv_bound(n_px, 64, 64, 9, 4, n_ops_px=n_img,
                                         f32_rate=F32_FLOPS_PER_S)[0]
    res["K9b"].update(t)
    print(f"[conv] K9b time, one step on the {g.height}x{g.width}x64 canvas of a 272x272 "
          f"image: {json.dumps(t)}; library: cuDNN F.conv2d with the scale in the weights, "
          f"the shift as bias, channels-last, TF32 off, then an in-place ReLU; "
          f"ms in float32 unless bf16_, by CUDA graph replays (event_ms: CUDA events around "
          f"the eager call), L2 flushed, median of 20; bound at 3xTF32 "
          f"(495/3 TFLOP/s) or bf16 (989), cuda_core_bound at 67; {card_line()}")
    sass_report(conv3x3_cuda.SOURCE)
    return res


def k8_bound(b, h, w, ks, c: int) -> dict:
    """Least times of K8 on these inputs (s2d B, H, W; ``ks`` the parts' s2d
    channels 4 Kp; c1 = cp = c2 = c): the parts, the direct taps and the
    output each moved once over HBM, vs the direct 3x3 form's multiply-adds
    (9 Kp (2c) for conv1 and project, 9 c^2 for conv2 a direct pixel), 2
    flops each, at the rate of the kernel's path: float32 as 3xTF32, bf16
    on the tensor cores. Beside them the CUDA-core float32 bounds of the
    direct form and of the TPU kernel's 2x2 parity form (16/9 of the
    direct form's multiply-adds), which the CUDA-core kernel before the
    tensor-core one ran."""
    n, kt = b * h * w, sum(ks) // 4
    macs = 4 * n * (9 * kt * 2 * c + 9 * c * c)
    macs_parity = n * (4 * sum(ks) * 8 * c + 4 * 4 * c * 4 * c)
    out = {"macs": macs}
    for key, itemsize, rate in (("", 4, TF32X3_FLOPS_PER_S), ("bf16_", 2, BF16_FLOPS_PER_S)):
        nbytes = (n * (sum(ks) + 4 * c) + 9 * kt * 2 * c + 9 * c * c) * itemsize + 12 * c
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * macs / rate * 1e3
        out[key + "bound_ms"] = max(t_bytes, t_ops)
        out[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    out["cuda_core_bound_ms"] = 2 * macs / F32_FLOPS_PER_S * 1e3
    out["cuda_core_parity_bound_ms"] = 2 * macs_parity / F32_FLOPS_PER_S * 1e3
    return out


def phase_s2d_block() -> dict:
    """K8 against its plain version at the cvppp model's five s2d blocks
    (544x544, B=1, the split up3 and up4 included) and two odd shapes with
    tile remainders, float32 and bfloat16, through the public call (the
    direct taps recovered from the parity taps and checked); a perturbed
    parity tap raises. Each full-width block's time with L2 flushed (the
    launch with its direct taps precomputed, as the fast forward makes it)
    beside the plain version's, cuDNN's direct-resolution form of the same
    folded block and the bounds, in float32 and bfloat16."""
    import torch
    import torch.nn.functional as F

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import s2d_block_cuda
    from pixel_embedded_affinity_torch.ops.s2d import depth_to_space
    from pixel_embedded_affinity_torch.ops.s2d_block_cuda import (
        DirectTaps, block_taps, direct_taps, fused_s2d_block, fused_s2d_block_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    flush = 64 << 20
    res = {"max_abs_err": 0.0, "stages": {}}
    for name, b, h, w, parts, c in K8_STAGES + K8_ODD:
        cin = sum(parts)
        w1, wp = (rnd(3, 3, cin, c, scale=(9 * cin) ** -0.5) for _ in range(2))
        w2 = rnd(3, 3, c, c, scale=(9 * c) ** -0.5)
        h1, hp, h2 = (0.1 * rnd(c) for _ in range(3))
        split = parts[0] if len(parts) == 2 else None
        k1ps, h1p, k2, h2t = block_taps(w1, wp, w2, h1, hp, h2, split)
        xs = tuple(rnd(b, h, w, 4 * p) for p in parts)
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            xi = tuple(x.to(dtype) for x in xs)
            got = fused_s2d_block(xi, k1ps, h1p, k2, h2t, c, c, c)
            ref = fused_s2d_block_plain(xi, k1ps, h1p, k2, h2t, c, c, c)
            check(got.shape == (b, h, w, 4 * c) and got.dtype == dtype, f"K8 {name} shape/dtype")
            errs.append(rel_err(got, ref))
            check(errs[-1] <= (CONV_F32_RTOL if dtype == torch.float32 else CONV_BF16_RTOL),
                  f"K8 {name} {dtype} error {errs[-1]}")
            if dtype == torch.float32:
                res["max_abs_err"] = max(res["max_abs_err"], (got - ref).abs().max().item())
        print(f"[k8] {name} B={b} s2d {h}x{w} parts {tuple(4 * p for p in parts)} c={c}: "
              f"rel error f32 {errs[0]:.3e}, bf16 {errs[1]:.3e}")
        if name.startswith("odd"):
            continue
        # cuDNN's direct-resolution form of the same folded block on the
        # direct-layout input (made outside the timing)
        xd = torch.cat([depth_to_space(x) for x in xs], -1).permute(0, 3, 1, 2)
        w1p = torch.cat([w1, wp], 3).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b1p = torch.cat([h1, hp])
        w2d = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def library(xd, w1p, b1p, w2d, h2):
            def run():
                with float32_convs():
                    v = F.conv2d(xd, w1p, b1p, padding=1)
                    return F.conv2d(v[:, :c].relu(), w2d, h2, padding=1).add_(v[:, c:]).relu_()
            return run

        d = direct_taps(k1ps, h1p, k2, h2t, c, c, c)
        db = DirectTaps(tuple(t.bfloat16() for t in d.w1p), d.w2.bfloat16(), d.h1, d.hp, d.h2)
        xsb = tuple(x.bfloat16() for x in xs)
        t = kernel_times({
            "ms": lambda: fused_s2d_block(xs, k1ps, h1p, k2, h2t, c, c, c, direct=d),
            "plain_ms": lambda: fused_s2d_block_plain(xs, k1ps, h1p, k2, h2t, c, c, c),
            "library_ms": library(xd, w1p, b1p, w2d, h2),
            "bf16_ms": lambda: fused_s2d_block(xsb, k1ps, h1p, k2, h2t, c, c, c, direct=db),
            "bf16_library_ms": library(xd.bfloat16(), w1p.bfloat16(), b1p.bfloat16(),
                                       w2d.bfloat16(), h2.bfloat16())}, flush)
        bounds = k8_bound(b, h, w, [4 * p for p in parts], c)
        t.update(bounds)
        t["tflops"] = 2 * bounds["macs"] / t["ms"] / 1e9
        t["bf16_tflops"] = 2 * bounds["macs"] / t["bf16_ms"] / 1e9
        res["stages"][name] = t
        print(f"[k8] {name} time (ms by CUDA graph replays, event_ms by CUDA events around "
              f"the eager call, L2 flushed, median of 20; library: cuDNN's "
              f"direct-resolution form, conv1+project one F.conv2d, conv2, add, ReLU, "
              f"channels-last, TF32 off; tflops of the direct form): {json.dumps(t)}, "
              f"{card_line()}")
    # a parity tap off its 3x3 structure: refused on the card, never run
    k1ps, h1p, k2, h2t = block_taps(*(rnd(3, 3, 8, 16) for _ in range(2)), rnd(3, 3, 16, 16),
                                    *(rnd(16) for _ in range(3)))
    bad = k1ps.clone()
    bad[0, 0, 0, 0] += 1.0  # (by, bx, py, px) = 0 and qy = qx = 0: a structural zero
    n0 = fused_s2d_block.launches
    for taps in (bad, k1ps):
        try:
            fused_s2d_block(rnd(1, 8, 8, 32), taps, h1p, k2, h2t, 16, 16, 16)
            refused = False
        except ValueError:
            refused = True
        check(refused == (taps is bad), f"K8 structure check: refused={refused}")
    check(fused_s2d_block.launches == n0 + 1, "K8 launched for refused taps")
    print("[k8] parity taps off the 3x3 structure raise ValueError on the card")
    st = res["stages"].values()
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bf16_ms", "bf16_library_ms",
                "bf16_bound_ms", "cuda_core_bound_ms", "cuda_core_parity_bound_ms", "event_ms",
                "library_event_ms", "bf16_event_ms", "bf16_library_event_ms"):
        res[key] = sum(t[key] for t in st)
    res["bound_by"] = "operations" if all(t["bound_by"] == "operations" for t in st) else "bytes"
    print(f"[k8] the five blocks of one 544x544 image, by CUDA graph replays (CUDA events "
          f"around the eager calls): kernel {res['ms']:.4f} ms ({res['event_ms']:.4f}; bf16 "
          f"{res['bf16_ms']:.4f} ({res['bf16_event_ms']:.4f})), plain {res['plain_ms']:.4f}, "
          f"cuDNN direct form {res['library_ms']:.4f} ({res['library_event_ms']:.4f}; bf16 "
          f"{res['bf16_library_ms']:.4f} ({res['bf16_library_event_ms']:.4f})), bound "
          f"{res['bound_ms']:.4f} ({res['bound_by']}, 3xTF32; bf16 {res['bf16_bound_ms']:.4f}); "
          f"CUDA-core bounds: direct form {res['cuda_core_bound_ms']:.4f}, 2x2 parity form "
          f"{res['cuda_core_parity_bound_ms']:.4f}; {card_line()}")
    sass_report(s2d_block_cuda.SOURCE)
    return res


# the fast forward's device time by kernel group (lower-cased name parts)
FAST_SPLIT = (("K8", ("s2d_block",)), ("K1f", ("affinity2d",)),
              ("convs", ("fprop", "conv", "winograd", "fft")),
              ("matmuls: upsample einsums, heads", ("gemm", "cutlass")),
              ("cuDNN layout transposes", ("nchwtonhwc", "nhwctonchw")),
              ("inference BatchNorm", ("bn_fw",)),
              ("upsampling", ("upsample",)),
              ("pools, reductions", ("max_pool", "reduce")),
              ("copies: permute, pad, cat, slice", ("cat", "copy", "pad", "index")),
              ("elementwise: shifts, ReLU, casts", ("elementwise",)))
PALLAS_FORMS = {k: "pallas" for k in ("inconv", "down1", "down2", "up3", "up4")}


def bn_stats_sd(sd: dict, seed: int) -> dict:
    """The state dict with non-trivial BatchNorm statistics and affine
    parameters (seeded), so that folding them is tested."""
    import torch

    rng = np.random.default_rng(seed)
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            out[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        elif k.endswith(".weight") and v.dim() == 1:
            out[k] = torch.from_numpy((1 + rng.normal(0, 0.1, v.shape)).astype(np.float32))
        elif k.endswith(".bias") and v.dim() == 1 and k[:-5] + ".running_mean" in sd:
            out[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
    return out


def phase_fast_forward(cfg, sd, samples) -> dict:
    """The folded-BatchNorm fast forward at full width (the cvppp model, seeded
    weights, non-trivial BatchNorm statistics): embedding and mask logits of
    the default forms, the all-"pallas" forms (5 K8 launches a forward), the
    s2d input and the full-resolution head, each against the dense module
    and its float64 run; the device time of the dense module, the default
    forms and the all-"pallas" forms at B=1 and B=4 with a profile split;
    then run_inference_2d through the fast forward at B=1 and B=4 against
    the dense run's metrics. Returns K8's and K1f's launches."""
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import (
        build_model, fast_affinities, forward_affinities, inference2d, run_inference_2d)
    from pixel_embedded_affinity_torch.models import build_fast_resunet_forward, pack_image_s2d
    from pixel_embedded_affinity_torch.ops import (
        fused_affinity_2d, fused_s2d_block, multi_offset)

    sd = bn_stats_sd(sd, SEED + 16)
    model = build_model(cfg, sd, device="cuda")
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    imgs = np.stack([s["image"] for s in samples])
    x = torch.from_numpy(imgs).cuda()
    packed = torch.from_numpy(pack_image_s2d(imgs)).cuda()
    with torch.no_grad(), float32_convs():
        dense = [o.permute(0, 2, 3, 1) for o in model(x[:1].permute(0, 3, 1, 2).contiguous())[4:]]
        f64 = [o.permute(0, 2, 3, 1) for o in build_model(cfg, sd, device="cuda").double()(
            x[:1].permute(0, 3, 1, 2).double())[4:]]
    variants = {
        "default forms": (build_fast_resunet_forward(model), x[:1]),
        "all pallas": (build_fast_resunet_forward(model, stage_forms=PALLAS_FORMS), x[:1]),
        "s2d input": (build_fast_resunet_forward(model, input_format="s2d"), packed[:1]),
        "s2d input, head at full res (served)": (build_fast_resunet_forward(
            model, input_format="s2d", head_at_fullres=True), packed[:1]),
    }
    launches = {"K8": 0, "K1f": 0}
    for name, (fwd, inp) in variants.items():
        fused_s2d_block.launches = 0
        emb, mask = fwd(inp)
        n = fused_s2d_block.launches
        launches["K8"] += n
        check(n == (5 if name == "all pallas" else 0), f"{name}: K8 launched {n} times")
        torch.cuda.synchronize()
        errs = []
        for got, d, r in zip((emb, mask), dense, f64):
            check(got.shape == d.shape and bool(torch.isfinite(got).all()), f"{name} output")
            top = r.abs().max().item()
            errs += [(got.double() - d.double()).abs().max().item() / top,
                     (got.double() - r).abs().max().item() / top]
        print(f"[fast] {name}: K8 launches {n}; embedding vs dense {errs[0]:.3e}, vs float64 "
              f"{errs[1]:.3e}; mask logits vs dense {errs[2]:.3e}, vs float64 {errs[3]:.3e} "
              f"(relative to the largest float64 value)")
        check(max(errs) <= AFF_ATOL, f"{name} off the dense module or float64: {errs}")
    pallas_fwd = variants["all pallas"][0]
    fused_s2d_block.launches = 0
    pallas_fwd(x)
    check(fused_s2d_block.launches == 5,
          f"all pallas at B=4: {fused_s2d_block.launches} K8 launches")
    launches["K8"] += fused_s2d_block.launches

    served = variants["s2d input, head at full res (served)"][0]
    pallas_s2d = build_fast_resunet_forward(model, input_format="s2d", head_at_fullres=True,
                                            stage_forms=PALLAS_FORMS)
    times = {}
    for bs in (1, 4):
        xb = x[:bs].permute(0, 3, 1, 2).contiguous()
        pb = packed[:bs]
        runs = {"dense": (lambda: model(xb), lambda: forward_affinities(model, xb, offsets)),
                "default forms": (lambda: served(pb), lambda: fast_affinities(served, pb, offsets)),
                "all pallas": (lambda: pallas_s2d(pb),
                               lambda: fast_affinities(pallas_s2d, pb, offsets))}
        t = {}
        for name, (fwd, fwd_aff) in runs.items():
            with torch.no_grad(), float32_convs():
                t[name] = {"forward": timed_ms(fwd) / bs,
                           "forward+affinity": timed_ms(fwd_aff) / bs}
        times[bs] = t
        print(f"[fast] B={bs} 544x544 device ms/img (warm median of 20; dense: the module on "
              f"the NCHW image; fast: the served s2d input and full-resolution head): "
              f"{json.dumps(t)}, {card_line()}")
        card = card_line()
        for name, (_, fwd_aff) in runs.items():
            device_breakdown(fwd_aff, bs, iters=3, label=f"{name} B={bs} ({card})",
                             split=FAST_SPLIT)

    # serving through the fast forward against the dense module's run
    calls = {"n": 0}
    real = inference2d.fast_affinities

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    walls = {}
    for bs in (1, 4):
        run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda", use_fast=True)
        _, ref = run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda", use_fast=False)
        timing = {}
        inference2d.fast_affinities = counted
        fused_affinity_2d.launches, calls["n"] = 0, 0
        try:
            per, agg = run_inference_2d(cfg, sd, samples, timing=timing, batch_size=bs,
                                        device="cuda", use_fast=True)
        finally:
            inference2d.fast_affinities = real
        n_batches = -(-len(samples) // bs)
        launches["K1f"] += fused_affinity_2d.launches
        check(calls["n"] == n_batches and fused_affinity_2d.launches == n_batches,
              f"fast serving at B={bs}: {calls['n']} fast forwards, "
              f"{fused_affinity_2d.launches} K1f launches")
        parts = {k: timing[k] / len(samples) * 1e3
                 for k in ("setup_s", "forward_s", "decode_s", "metrics_s")}
        walls[bs] = timing["total_s"] / len(samples) * 1e3
        print(f"[fast] serving B={bs} use_fast=True: metrics {json.dumps(agg)} (dense "
              f"{json.dumps(ref)}); ms/img wall {walls[bs]:.4f} = "
              + " + ".join(f"{k[:-2]} {v:.4f}" for k, v in parts.items()))
        check(len(per) == len(samples), "one result per image")
        for k in ref:
            check(abs(agg[k] - ref[k]) <= 5e-3, f"fast serving {k} {agg[k]} vs dense {ref[k]}")
    return {"launches": launches, "times": times, "walls": walls}


def sampler_times(draw, label: str, batches: int = 20):
    """Print the host ms a batch (the launches, no sync), the ms between
    CUDA events around the same call, and the device's busy ms and
    operations a batch (torch.profiler), each over ``batches`` draws with
    their own steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for s in range(3):
        draw(10 ** 6 + s)
    torch.cuda.synchronize()
    host = []
    for s in range(batches):
        t0 = time.perf_counter()
        draw(s)
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    step = iter(range(batches, 3 * batches))
    dev_ms = timed_ms(lambda: draw(next(step)), n=batches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for s in range(batches):
            draw(3 * batches + s)
        torch.cuda.synchronize()
    busy = device_times(prof)
    kernels = sum(n for _, n in busy.values()) / batches
    busy_ms = sum(t for t, _ in busy.values()) / batches
    print(f"[samplers] {label}: host {np.median(host):.4f} ms a batch of 2 (launches, no "
          f"sync), {dev_ms:.4f} ms a batch between CUDA events, device busy {busy_ms:.4f} ms "
          f"a batch (profiler), {kernels:.1f} device operations a batch; {card_line()}")


def device_times(prof) -> dict:
    """{event name: (device ms, count)} of a torch.profiler run, for the
    events with device time."""
    out = {}
    for ev in prof.key_averages():
        t_us = getattr(ev, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(ev, "self_cuda_time_total", 0)
        if t_us > 0:
            out[ev.key] = (t_us / 1e3, ev.count)
    return out


def host_drawn_ac3ac4(step: int, shape) -> bool:
    """Whether the B=2 AC3/AC4 batch at (SEED, step) makes no draw on the
    device and augments at least one sample."""
    from pixel_embedded_affinity_torch.data.device_data import (
        _ac3ac4_params, sampler_generator)

    gen = sampler_generator(SEED, step)
    ps = [_ac3ac4_params(gen, shape, (18, 260, 260)) for _ in range(2)]
    host = [not p["aug"] or (not p["mix"]["elastic"] and p["mix"]["gray"] != "slices"
                             and not (p["mix"]["em"] and p["mix"]["em"][0] == "missing"
                                      and any(n for _, n in p["mix"]["em"][1])))
            for p in ps]
    return all(host) and any(p["aug"] for p in ps)


def phase_samplers(volume) -> dict:
    """The device-resident samplers at the real training geometry: CVPPP's
    108 544x544 images (12 synthetic leaf images repeated 9 times) and
    AC4's 80x1024x1024 training split (the 3D serving phase's 20-slice
    volume stacked 4 times); memory, ms a batch, launches a batch, the
    batches' contract; then one full-width cvppp step with the EMA view's
    noise and blur on; returns that step's kernel launches."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.consistency import imagenet_stats
    from pixel_embedded_affinity_torch.data.device_data import (
        load_ac3ac4_arrays, pack_cvppp_arrays, sample_ac3ac4_batch, sample_cvppp_batch,
        sampler_generator)
    from pixel_embedded_affinity_torch.train import train

    t0 = time.perf_counter()
    arrays = pack_cvppp_arrays(leaf_pairs(CVPPP_DISTINCT, 530, 500, SEED + 8)
                               * (CVPPP_TRAIN_IMAGES // CVPPP_DISTINCT))
    t_pack = time.perf_counter() - t0
    images, labels = (torch.from_numpy(a).cuda() for a in arrays)
    mb = (images.numel() * images.element_size() + labels.numel() * labels.element_size()) / 1e6
    print(f"[samplers] cvppp: {images.shape[0]} images {tuple(images.shape[1:])} uint8 + labels "
          f"int32 ({CVPPP_DISTINCT} synthetic leaf images repeated), {mb:.2f} MB on the "
          f"device; made and packed in {t_pack:.2f} s")
    sampler_times(lambda s: sample_cvppp_batch(images, labels, sampler_generator(SEED, s), 2),
                  "cvppp B=2 544x544")
    src_ids = set(np.unique(arrays[1]).tolist())
    for s in range(4):
        b = sample_cvppp_batch(images, labels, sampler_generator(SEED, s), 2)
        img, seg = b["image"], b["seg"]
        check(img.shape == (2, 544, 544, 3) and img.dtype == torch.float32
              and seg.shape == (2, 544, 544) and seg.dtype == torch.int32, "cvppp batch")
        check(bool(torch.isfinite(img).all()) and -2.2 < float(img.min())
              and float(img.max()) < 2.7, "cvppp image range (ImageNet-normalised [0, 1])")
        check(set(torch.unique(seg).tolist()) <= src_ids, "cvppp labels not from the source")
    print(f"[samplers] cvppp batches: image (2, 544, 544, 3) float32 in "
          f"[{float(img.min()):.4f}, {float(img.max()):.4f}], seg (2, 544, 544) int32, "
          f"ids a subset of the source's")
    # every CVPPP draw is made on the host: the CPU sampler at the same
    # (seed, step) gives the same batch; images held at the resize's own
    # tolerance, 1e-4 on the 0-255 scale
    cpu = [torch.from_numpy(a) for a in arrays]
    scale = 255.0 * imagenet_stats("cuda")[1]
    err = 0.0
    for s in range(4):
        b = sample_cvppp_batch(images, labels, sampler_generator(SEED, s), 2)
        c = sample_cvppp_batch(*cpu, sampler_generator(SEED, s), 2)
        check(torch.equal(b["seg"].cpu(), c["seg"]), f"cvppp labels, card vs CPU, step {s}")
        e = float(((b["image"] - c["image"].cuda()) * scale).abs().max())
        check(e <= 1e-4, f"cvppp images, card vs CPU, step {s}: {e} on the 0-255 scale")
        err = max(err, e)
    print(f"[samplers] cvppp card vs CPU sampler at the same (seed, step), 4 batches: labels "
          f"bit-equal, images {err:.3e} apart on the 0-255 scale (held at 1e-4)")

    cfg = load_config("cvppp", {"data": {"if_ema_noise": True, "if_ema_blur": True},
                                "train": {"if_valid": False, "display_freq": 1,
                                          "save_freq": 10 ** 6},
                                "save_path": os.path.join(REPO, "build", "chip_smoke_ema")})
    launchers = _wmse_launchers()
    for fn in launchers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, _ = train(cfg, max_iters=1, data_override=(arrays, []), device="cuda")
    n = {k: fn.launches for k, fn in launchers.items()}
    check(state.step == 1 and n == {"K2f": 5, "K2b": 5, "K3f": 1, "K3b": 1},
          f"EMA noise/blur step: launches {n}")
    check(all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
          "EMA noise/blur step: non-finite parameters")
    print(f"[samplers] one cvppp step with the EMA view's noise and blur on: "
          f"{time.perf_counter() - t0:.2f} s (first step, cuDNN's search included), "
          f"launches {json.dumps(n)}, parameters finite")
    ema_launches = n
    del images, labels, arrays

    t0 = time.perf_counter()
    raw = np.concatenate([volume[0]] * 4)
    lab = np.concatenate([volume[1] + i * (int(volume[1].max()) + 1) for i in range(4)])
    arrays = load_ac3ac4_arrays("", train_split=AC4_TRAIN_SLICES, arrays=(raw, lab))
    t_load = time.perf_counter() - t0
    raw_d, lab_d = (torch.from_numpy(a).cuda() for a in arrays)
    mb = (raw_d.numel() * raw_d.element_size() + lab_d.numel() * lab_d.element_size()) / 1e6
    print(f"[samplers] ac3ac4: volume {tuple(raw_d.shape)} uint8 + labels int32 (the serving "
          f"volume stacked 4 times, ids kept apart), {mb:.2f} MB on the device; "
          f"load_ac3ac4_arrays (border widening) {t_load:.2f} s")
    sampler_times(lambda s: sample_ac3ac4_batch(raw_d, lab_d, sampler_generator(SEED, s), 2),
                  "ac3ac4 B=2 18x160x160 (crop 18x260x260)")
    src_ids = set(np.unique(arrays[1]).tolist()) | {0}
    for s in range(4):
        b = sample_ac3ac4_batch(raw_d, lab_d, sampler_generator(SEED, s), 2)
        img, seg = b["image"], b["seg"]
        check(img.shape == (2, 18, 160, 160, 1) and img.dtype == torch.float32
              and seg.shape == (2, 18, 160, 160) and seg.dtype == torch.int32, "ac3ac4 batch")
        check(float(img.min()) >= 0 and float(img.max()) <= 1, "ac3ac4 image range")
        check(set(torch.unique(seg).tolist()) <= src_ids, "ac3ac4 labels not from the source")
    print(f"[samplers] ac3ac4 batches: image (2, 18, 160, 160, 1) float32 in "
          f"[{float(img.min()):.4f}, {float(img.max()):.4f}], seg int32, ids a subset of the "
          f"source's and 0")
    # batches whose draws are all made on the host (no elastic field, no
    # per-slice jitter, no noise-filled section) against the CPU sampler
    cpu = [torch.from_numpy(a) for a in arrays]
    steps = [s for s in range(200) if host_drawn_ac3ac4(s, arrays[1].shape)][:4]
    check(len(steps) == 4, f"ac3ac4: host-drawn batches at steps {steps}")
    err = 0.0
    for s in steps:
        b = sample_ac3ac4_batch(raw_d, lab_d, sampler_generator(SEED, s), 2)
        c = sample_ac3ac4_batch(*cpu, sampler_generator(SEED, s), 2)
        check(torch.equal(b["seg"].cpu(), c["seg"]), f"ac3ac4 labels, card vs CPU, step {s}")
        e = float((b["image"].cpu() - c["image"]).abs().max())
        check(e <= 1e-6, f"ac3ac4 images, card vs CPU, step {s}: {e}")
        err = max(err, e)
    print(f"[samplers] ac3ac4 card vs CPU sampler at the same (seed, step), the host-drawn "
          f"batches at steps {steps}: labels bit-equal, images {err:.3e} apart (held at 1e-6)")
    return ema_launches


def phase_tile_copy() -> dict:
    """P, the tile copy, against its plain version bit for bit: float32 and
    bfloat16, the probe's three arrangements of the (1, 544, 544, 16)
    embedding, an odd shape whose bytes are no multiple of 16, and views
    whose storage offset leaves 8, 4, 2 and 1 bytes of alignment; its time
    beside the plain version's, copy_'s and the bound, L2 flushed; then the
    arrangement probe at B=1 and B=4, the kernel's launches counted around
    it."""
    import torch

    from pixel_embedded_affinity_torch.ops import tile_copy, tile_copy_plain
    from pixel_embedded_affinity_torch.utils import profile_arrange

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = 0.0
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        emb = torch.randn((1, 544, 544, 16), generator=g, device="cuda").to(dt)
        for name, (perm, axis) in (("NHWC", ((0, 1, 2, 3), 1)), ("NCHW", ((0, 3, 1, 2), 2)),
                                   ("BHCW", ((0, 1, 3, 2), 1))):
            t = emb.permute(*perm).contiguous()
            got, ref = tile_copy(t, axis), tile_copy_plain(t, axis)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"tile_copy {name} {dt} differs from its plain version")
            err = max(err, float((got.float() - ref.float()).abs().max()))
            cases += 1
        odd = torch.randn((3, 33, 5, 7), generator=g, device="cuda").to(dt)
        check(torch.equal(tile_copy(odd, 1, 11), tile_copy_plain(odd, 1, 11)), f"odd {dt}")
        cases += 1
    for dt, off in ((torch.float32, 2), (torch.float32, 1), (torch.bfloat16, 1),
                    (torch.uint8, 1)):
        n = 3 * 33 * 5 * 7
        buf = torch.randint(0, 100, (off + n,), generator=g, device="cuda").to(dt)
        t = buf[off:].view(3, 33, 5, 7)
        check(torch.equal(tile_copy(t, 1, 11), tile_copy_plain(t, 1, 11)),
              f"misaligned view {dt} offset {off}")
        cases += 1
    torch.cuda.synchronize()
    print(f"[P] tile_copy against tile_copy_plain: {cases} cases bit-exact (max abs error "
          f"{err}): float32 and bfloat16 x NHWC/NCHW/(B,H,C,W) of (1, 544, 544, 16), an odd "
          f"(3, 33, 5, 7) (bytes no multiple of 16), views 8, 4, 2, 1 bytes aligned")

    t = torch.randn((1, 544, 544, 16), generator=g, device="cuda").to(torch.bfloat16)
    out = torch.empty_like(t)
    flush = 64 << 20  # beyond the 50 MB L2
    res = {"max_abs_err": err,
           "ms": timed_ms(lambda: tile_copy(t, 1), flush_bytes=flush),
           "plain_ms": timed_ms(lambda: tile_copy_plain(t, 1), flush_bytes=flush),
           "library_ms": timed_ms(lambda: out.copy_(t), flush_bytes=flush)}
    nbytes = t.numel() * t.element_size()
    res["bound_ms"], res["bound_by"] = 2 * nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
    print(f"[P] tile_copy (1, 544, 544, 16) bfloat16, {nbytes / 1e6:.2f} MB (ms, L2 flushed, "
          f"median of 20, CUDA events): kernel {res['ms']:.4f}, plain (clone) "
          f"{res['plain_ms']:.4f}, copy_ {res['library_ms']:.4f}, bound {res['bound_ms']:.4f} "
          f"(bytes); {card_line()}")
    # a 6 us copy launched through ctypes: CUDA events around one call also
    # count the host's launch path, and a graph replay of one call its own
    # start, so the kernels line takes one graph of 96 calls over 8 inputs
    # (151 MB, three times L2) divided by 96
    events = {k: res[k] for k in ("ms", "plain_ms", "library_ms")}
    ts = [torch.randn(t.shape, generator=g, device="cuda").to(t.dtype) for _ in range(8)]
    outs = [torch.empty_like(x) for x in ts]
    res.update({
        "ms": graph_each_ms([lambda x=x: tile_copy(x, 1) for x in ts]),
        "plain_ms": graph_each_ms([lambda x=x: tile_copy_plain(x, 1) for x in ts]),
        "library_ms": graph_each_ms([lambda x=x, o=o: o.copy_(x) for x, o in zip(ts, outs)])})
    print(f"[P] the same by CUDA graph replay, 96 calls a graph over 8 inputs (ms a call, the "
          f"kernels line's): kernel {res['ms']:.4f}, plain {res['plain_ms']:.4f}, copy_ "
          f"{res['library_ms']:.4f} (CUDA events: {json.dumps(events)})")

    tile_copy.launches = 0
    for b in (1, 4):
        ms = profile_arrange.run(b, "cuda")
        print(f"[P] arrangement probe B={b}, ResidualUNet2DDeep (16..256) fast forward "
              f"bfloat16 s2d input 544x544, median of 30 (CUDA events), {card_line()}:")
        for name, v in ms.items():
            print(f"[P]   {name:24s} {v:8.3f} ms")
            check(np.isfinite(v) and v > 0, f"probe {name}")
    res["launches"] = tile_copy.launches
    expected = 2 * 3 * (3 + 30)  # two batches, three copy variants, warm-up and timed calls
    check(res["launches"] == expected,
          f"tile_copy launched {res['launches']} times in the probe, expected {expected}")
    print(f"[P] tile_copy launches in the probe: {res['launches']}")
    return res


# ---------------------------------------------------------- quality gates
# The JAX package's train-to-quality gates (tests/test_quality_gate.py,
# tests/test_quality_gate_bbbc3d.py): fixed-seed training on synthetic data
# through the preset's own path, with their overrides, steps, seeds and
# floors. The 2D gates' datasets are the files JAX's synthesize writes at
# the gates' arguments, decoded into QUALITY_FIXTURE (no cv2 on the card;
# tests/make_quality_fixture.py writes it); the 3D gate's volume is
# synthesize_volume's. JAX's gates pass a host AC3AC4Train (h5py, cv2) to
# the 3D run; the port's trains from the preset's device sampler on the
# same volume (train_split 30, margin 8). The samplers draw from other
# random streams than JAX's, so only the floors compare across packages.
QUALITY_FIXTURE = os.path.join(REPO, "tests", "fixtures", "quality_2d.npz")
GATE_FILTERS_2D, GATE_FILTERS_3D = (8, 12, 16, 24, 32), (4, 6, 8, 12, 16)
# the 3D gate's volume (d, h, w), cells, and the validation's first slices
GATE_VOLUME, GATE_CELLS, GATE_VALID_SLICES = (30, 96, 96), 25, 20
# the 2D gates validate on the 2 images JAX's synthesize holds out
GATE_VALID_IMAGES = 2
# each gate: its steps, seed, floors (metric: ("min" or "max", bound)), the
# JAX package's calibration on the CPU (the gates' docstrings), and its
# readings that training moves held to the card's plain path (metric:
# (reading, tolerance)): the mean of tools/quality_card.py's six
# plain-path runs on an H100 (three calls, two runs each), within three
# times the spread, rounded up, of every card run of the gate at its width
# (kernels and plain, the tool's and this phase's; PERF.md §6, PRs 13 and
# 14). The loss at the last display follows every step's gradients; the
# 3D gate's eval-mode reading hardly moves in 200 steps (its BatchNorm
# running statistics, momentum 0.001), so it is held with each tile
# batch's own statistics (batch_stats_reading).
GATES = {
    "cvppp": {"steps": 250, "seed": 1234, "floors": {"valid/SBD": ("min", 0.55)},
              "jax_cpu": {"valid/SBD": 0.800},
              "card_plain": {"loss_last": (539.1909, 1.0)}},
    "bbbc039v1": {"steps": 250, "seed": 4321,
                  "floors": {"valid/SBD": ("min", 0.25), "valid/AJI": ("min", 0.18)},
                  "jax_cpu": {"valid/SBD": 0.394, "valid/AJI": 0.310},
                  "card_plain": {"loss_last": (1164.1947, 0.7)}},
    "ac3ac4": {"steps": 200, "seed": 4321,
               "floors": {"valid/affs_mse": ("max", 0.15), "valid/mutex_voi": ("max", 2.8)},
               "jax_cpu": {"valid/affs_mse": 0.064, "valid/mutex_voi": 1.69},
               # the JAX package misses this gate's floors on the CPU with
               # its own code (affs_mse 0.285, at the commit that added the
               # gate and at this one; ROADMAP.md, faults section, open), so
               # they cannot tell the port from its reference: the card
               # prints the misses and holds the readings below
               "card_plain": {"loss_last": (11.671578, 3e-4),
                              "batch_stats/affs_mse": (0.2126836, 7e-6),
                              "batch_stats/mutex_voi": (1.68876, 0.012)}},
}


def gate_config(name: str, save_path: str, steps: int | None = None, filters=None,
                use_pallas: bool = True, dtype: str | None = None):
    """The preset ``name`` with the JAX gate's overrides: ``steps`` steps
    (the gate's by default) and one validation after the last, the gate's
    seed and filters (or ``filters``); ``use_pallas`` False is the plain
    path; ``dtype``, when given, the model's compute dtype (``model.dtype``;
    the preset's "auto" else)."""
    from pixel_embedded_affinity_torch.config import load_config

    g = GATES[name]
    steps = steps or g["steps"]
    train = {"display_freq": 50, "valid_freq": steps, "save_freq": 10 ** 9,
             "total_iters": steps, "random_seed": g["seed"], "use_pallas": use_pallas}
    if name == "ac3ac4":
        over = {"train": {**train, "batch_size": 2, "valid_decoders": ("mutex",)},
                "data": {"crop_size": (18, 64, 64), "train_split": GATE_VOLUME[0],
                         "padding_3d": 8},
                "model": {"filters": filters or GATE_FILTERS_3D}}
    else:
        # s2d_train as the JAX gate sets it (the port reads it nowhere)
        over = {"train": {**train, "batch_size": 8}, "data": {"size": 128},
                "model": {"filters": filters or GATE_FILTERS_2D, "s2d_train": False}}
    if dtype:
        over["model"]["dtype"] = dtype
    return load_config(name, {**over, "save_path": save_path})


def gate_data(cfg, fixture) -> tuple:
    """``train()``'s data_override for a gate's config: the 2D gates' from
    ``fixture`` (QUALITY_FIXTURE's arrays, as np.load gives them) through
    the port's reading transforms, the 3D gate's from synthesize_volume at
    the gate's seed."""
    d = cfg.data
    if d.dataset == "cvppp":
        from pixel_embedded_affinity_torch.data import CVPPPValidation
        from pixel_embedded_affinity_torch.data.cvppp import decoded_split
        from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays

        train_pairs, valid_pairs = decoded_split(
            fixture["cvppp_names"], fixture["cvppp_bgr"], fixture["cvppp_label"],
            fixture["cvppp_valid_names"])
        return (pack_cvppp_arrays(train_pairs, d.padding),
                CVPPPValidation(pairs=valid_pairs, padding=d.padding))
    if d.dataset == "bbbc039v1":
        from pixel_embedded_affinity_torch.data import BBBCValidation
        from pixel_embedded_affinity_torch.data.bbbc import decoded_pairs
        from pixel_embedded_affinity_torch.data.device_data import pad_bbbc_arrays

        files = (fixture["bbbc_names"], fixture["bbbc_image"], fixture["bbbc_label"])
        return (pad_bbbc_arrays(decoded_pairs(*files, fixture["bbbc_training"]),
                                d.bbbc_padding),
                BBBCValidation(pairs=decoded_pairs(*files, fixture["bbbc_validation"]),
                               shifts=d.shifts, neighbor=d.neighbor))
    from pixel_embedded_affinity_torch.data import AC3AC4ValidVolume, synthesize_volume
    from pixel_embedded_affinity_torch.data.device_data import load_ac3ac4_arrays

    raw, label = synthesize_volume(*GATE_VOLUME, n_cells=GATE_CELLS, seed=cfg.train.random_seed)
    return (load_ac3ac4_arrays("", train_split=d.train_split, crop_z=d.crop_size[0],
                               arrays=(raw, label)),
            AC3AC4ValidVolume("", arrays=(raw[:GATE_VALID_SLICES], label[:GATE_VALID_SLICES])))


def gate_valid_tiles(cfg) -> int:
    """The tiles of the 3D gate's in-loop validation."""
    from pixel_embedded_affinity_torch.parallel import tile_grid
    from pixel_embedded_affinity_torch.train import valid_geometry_3d

    stride, pad = valid_geometry_3d(cfg.data.crop_size)
    shape = (GATE_VALID_SLICES,) + GATE_VOLUME[1:]
    return len(tile_grid(tuple(np.add(shape, np.multiply(pad, 2))), cfg.data.crop_size, stride))


def gate_misses(name: str, metrics: dict) -> list:
    """The floors of gate ``name`` that ``metrics`` misses, as messages."""
    out = []
    for key, (kind, bound) in GATES[name]["floors"].items():
        v = metrics[key]
        if not (np.isfinite(v) and (v >= bound if kind == "min" else v <= bound)):
            out.append(f"{name}: {key} {v:.4f} {'<' if kind == 'min' else '>'} {bound}")
    return out


def gate_off_plain(name: str, reading: dict) -> list:
    """The readings of gate ``name`` off the card's plain path by more than
    their tolerance (GATES' ``card_plain``), as messages."""
    out = []
    for key, (ref, tol) in GATES[name]["card_plain"].items():
        v = reading[key]
        if not abs(v - ref) <= tol:
            out.append(f"{name}: {key} {v:.7g}, the plain path's {ref} +- {tol}")
    return out


def batch_stats_reading(cfg, model, valid) -> dict:
    """The 3D gate's validation (the in-loop geometry, the mutex decoder)
    with each tile batch's own BatchNorm statistics in place of the running
    ones, through a copy of ``model``: affs_mse and mutex VOI."""
    import torch

    from pixel_embedded_affinity_torch.infer.inference3d import build_tiled_predictor, decode
    from pixel_embedded_affinity_torch.metrics import voi
    from pixel_embedded_affinity_torch.ops.targets import seg_to_aff_3d_12ch
    from pixel_embedded_affinity_torch.parallel import TiledInference3D
    from pixel_embedded_affinity_torch.train import valid_geometry_3d

    stride, padding = valid_geometry_3d(cfg.data.crop_size)
    model = copy.deepcopy(model).train()
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm3d):
            m.momentum = 0.0  # normalise by the batch, keep the running statistics
    affs = TiledInference3D(crop_size=cfg.data.crop_size, stride=stride, padding=padding,
                            batch_size=4).run(valid.raw, build_tiled_predictor(model),
                                              n_channels=12, device=next(model.parameters()).device)
    gt = seg_to_aff_3d_12ch(torch.from_numpy(valid.label[None]))[0].numpy()
    vs, vm = voi(valid.label, decode(affs, "mutex"))
    return {"batch_stats/affs_mse": float(np.mean((affs - gt) ** 2)),
            "batch_stats/mutex_voi": float(vs + vm)}


def run_gate(name: str, fixture, device: str = "cuda", steps: int | None = None,
             filters=None, use_pallas: bool = True, out: str | None = None,
             dtype: str | None = None) -> dict:
    """Train gate ``name`` (:func:`gate_config`, :func:`gate_data`) on
    ``device`` in ``dtype`` and validate once after the last step; returns
    the run's reading: the gate, its filters, the path, the dtype, steps,
    seconds of train(),
    steps a second (over the steps' own time), the loss at the first and
    last display, the validation's metrics, and for the 3D gate
    :func:`batch_stats_reading`. Floors and held readings are not checked
    here (:func:`gate_misses`, :func:`gate_off_plain`)."""
    from pixel_embedded_affinity_torch.config import resolve_compute_dtype
    from pixel_embedded_affinity_torch.train import train

    out = out or os.path.join(REPO, "build", "quality", name)
    shutil.rmtree(out, ignore_errors=True)
    cfg = gate_config(name, os.path.join(out, "models"), steps, filters, use_pallas, dtype)
    data = gate_data(cfg, fixture)
    timing: dict = {}
    t0 = time.perf_counter()
    state, history = train(cfg, data_override=data, device=device,
                           log_dir=os.path.join(out, "log"), timing=timing)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    check(len(history) == 1 and history[0]["step"] == cfg.train.total_iters,
          f"{name}: validation {history}")
    metrics = {k: v for k, v in history[0].items() if k != "step"}
    if name == "ac3ac4":
        metrics.update(batch_stats_reading(cfg, state.model, data[1]))
    check(all(np.isfinite(v) for v in metrics.values()) and all(np.isfinite(losses)),
          f"{name}: a non-finite reading {metrics} {losses}")
    step_s = sum(timing["data_s"]) + sum(timing["step_s"])
    return {"gate": name, "filters": list(cfg.model.filters),
            "path": "kernels" if use_pallas else "plain",
            "dtype": resolve_compute_dtype(cfg.model), "device": device,
            "steps": cfg.train.total_iters, "seconds": seconds,
            "steps_per_s": cfg.train.total_iters / step_s,
            "valid_s": timing["valid_s"][0], "loss_first": losses[0], "loss_last": losses[-1],
            **metrics}


def phase_quality() -> dict:
    """The three quality gates on the card through the kernels (the
    presets' path: use_pallas, fuse_loss, the device-resident samplers),
    each held to JAX's floors (the 3D gate's, which the JAX package itself
    misses, are printed) and its readings that training moves to the card's
    plain path (GATES' ``card_plain``), with each kernel's launches read
    around each gate and held to its count; returns the launches."""
    fixture = dict(np.load(QUALITY_FIXTURE))
    launches = {}
    for name in GATES:
        cfg = gate_config(name, "")
        check(cfg.train.use_pallas and cfg.train.fuse_loss and cfg.data.device_resident,
              f"{name}: the gate runs the preset's path")
        launchers = _train3d_launchers() if name == "ac3ac4" else _bbbc_launchers()
        for fn in launchers.values():
            fn.launches = 0
        r = run_gate(name, fixture)
        got = {k: fn.launches for k, fn in launchers.items()}
        steps = r["steps"]
        if name == "ac3ac4":  # K5f: the steps', then the two validations' tile batches of 4
            expect = {"K5f": steps + 2 * -(-gate_valid_tiles(cfg) // 4), "K5b": steps,
                      "K6f": steps, "K6b": steps}
        else:  # K1f: one a validation image
            expect = {"K1f": GATE_VALID_IMAGES, "K2f": 5 * steps, "K2b": 5 * steps,
                      "K3f": steps, "K3b": steps, "K1b": 0, "K4f": 0, "K4b": 0}
        check(got == expect, f"{name}: launches {got}, expected {expect}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        print(f"[quality] {json.dumps(r)}")
        print(f"[quality] {name}: floors {json.dumps(GATES[name]['floors'])}, JAX's CPU "
              f"calibration {json.dumps(GATES[name]['jax_cpu'])}; held to the plain path "
              f"{json.dumps(GATES[name]['card_plain'])}; launches {json.dumps(got)}; "
              f"{card_line()}")
        misses = gate_misses(name, r)
        if name == "ac3ac4":
            batch = {k: r["batch_stats/" + k.split("/")[1]] for k in GATES[name]["floors"]}
            print(f"[quality] {name} misses JAX's floors ({misses}), as the JAX package's own "
                  f"gate does on the CPU (ROADMAP.md, faults section, open); with batch "
                  f"statistics it misses {gate_misses(name, batch)}")
            misses = []
        off = gate_off_plain(name, r)
        check(not misses and not off, f"quality gate missed: {misses + off}")
    return launches


# phase 20, bf16: the loss-fused kernels' bfloat16 forms against their
# plain versions at the CVPPP step's full scale (affinities at BF16_ATOL,
# gradients at BF16_GRAD_RTOL, both rounded to bfloat16 at the end; S in
# float32 from the unrounded affinities on both sides, at S_RTOL)
BF16_SIDE, BF16_K = 544, 10
# a bfloat16 step's loss against the float32 step's, same weights and batch
BF16_LOSS_RTOL = 2e-2
# served affinities and canvases in bfloat16 against float32 of the same
# weights: the JAX package's own bar (tests/test_inference_e2e.py)
BF16_SERVE_MAX, BF16_SERVE_MEAN = 0.05, 0.005
# the 3D serving canvas held to float32's: AC4's 20 slices at 256x256
BF16_CANVAS_VOLUME = (20, 256, 256)
# a train step's device time by group (the first group one of whose name
# parts a kernel's lower-cased name holds)
STEP_SPLIT = (("the port's kernels", ("wmse", "affinity")), ("weight gradients", ("wgrad",)),
              ("data gradients", ("dgrad",)),
              ("BatchNorm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
              ("layout transposes", ("nchwtonhwc", "nhwctonchw")),
              ("convs", ("fprop", "conv", "gemm", "xmma", "cutlass")),
              ("upsampling", ("upsample",)), ("pools", ("pool",)),
              ("copies, casts", ("copy", "cat")), ("elementwise, reductions", ("elementwise", "reduce")))


def phase_wmse_bf16() -> dict:
    """K2f/K2b/K3f/K3b (K3b without db, the steps' form, and with it) in
    bfloat16 against their plain versions at B=2 544x544, C=16, K=10, on the
    model's NCHW layout permuted, with a zero vector; their times (CUDA
    graph replay and events, L2 flushed) against the bound at bfloat16
    bytes; no bfloat16 form may spill. Returns each kernel's bf16_* fields."""
    import torch

    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.ops import emb2aff_wmse_cuda as W

    regs = no_spills(WMSE_SOURCE)
    bf16_regs = {n: r for n, r in regs.items() if "__nv_bfloat16" in n}
    print(f"[bf16] the bfloat16 WMSE kernels' registers, no spills: {json.dumps(bf16_regs)}")
    check(len(bf16_regs) == 4, f"bfloat16 WMSE forms built: {sorted(bf16_regs)}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    side, k = BF16_SIDE, BF16_K
    offsets = multi_offset([1, 3, 5, 9, 27], 4)[:k]
    zero_px = (0, 3, 5)
    es = []
    for _ in range(2):
        e = torch.randn((2, 16, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        e[zero_px[0], :, zero_px[1], zero_px[2]] = 0.0
        es.append(e.permute(0, 2, 3, 1))
    shape = (2, k, side, side)
    maps = ((torch.rand(shape, generator=gen, device="cuda") > 0.5).float(),
            torch.rand(shape, generator=gen, device="cuda") * 2.0 + 0.05,
            (torch.rand(shape, generator=gen, device="cuda") > 0.2).float())
    gs = torch.rand((k,), generator=gen, device="cuda") / (2 * side) + 1e-4
    req = [e.detach().clone().requires_grad_() for e in es]
    got = {"K2": (*W.wmse2d_fwd(es[0], *maps, offsets), [W.wmse2d_bwd(es[0], *maps, gs, offsets)])}
    da, no_db = W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets, need_db=False)
    check(no_db is None, "bf16 K3b without db returned a db")
    got["K3"] = (*W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets),
                 [da, *W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets)])
    res = {}
    for kind, (s, affs, grads) in got.items():
        if kind == "K2":
            s_ref, affs_ref = W.affinity_wmse_2d_plain(req[0], *maps, offsets)
            refs = list(torch.autograd.grad(s_ref, req[:1], gs))
        else:
            s_ref, affs_ref = W.cross_affinity_wmse_2d_plain(req[0], req[1], *maps, offsets)
            refs = list(torch.autograd.grad(s_ref, req, gs))
            refs = [refs[0], *refs]
        torch.cuda.synchronize()
        check(s.dtype == torch.float32 and affs.dtype == torch.bfloat16
              and all(g.dtype == torch.bfloat16 for g in grads), f"bf16 {kind} output dtypes")
        err_a = (affs.float() - affs_ref.float()).abs().max().item()
        err_s = ((s - s_ref).abs() / s_ref.abs()).max().item()
        gerrs = [_grad_err(g, r, zero_px) for g, r in zip(grads, refs)]
        print(f"[bf16] {kind} B=2 {side}x{side} C=16 K={k} bfloat16 vs plain: affs {err_a:.3e} "
              f"(bound {BF16_ATOL}), S rel {err_s:.3e} (bound {S_RTOL}), grads rel (rest, "
              f"zero-vector pixel, abs; bound {BF16_GRAD_RTOL})"
              + (" of da without db, da and db with it: " if kind == "K3" else ": ")
              + ", ".join(f"({a:.3e}, {z:.3e}, {x:.3e})" for a, z, x in gerrs))
        check(bool((affs[zero_px[0], :, zero_px[1], zero_px[2]] == 0).all()),
              f"bf16 {kind} nonzero affinity at a zero vector")
        check(err_a <= BF16_ATOL, f"bf16 {kind} affinity error {err_a}")
        check(err_s <= S_RTOL, f"bf16 {kind} S relative error {err_s}")
        for a, z, _ in gerrs:
            check(a <= BF16_GRAD_RTOL and z <= BF16_GRAD_RTOL, f"bf16 {kind} gradient error {a}, {z}")
        res[f"{kind}f"] = {"bf16_max_abs_err": err_a}
        res[f"{kind}b"] = {"bf16_max_abs_err": max(x for _, _, x in gerrs)}

    flush = 64 << 20
    t = kernel_times({
        "K2f_ms": lambda: W.wmse2d_fwd(es[0], *maps, offsets),
        "K2b_ms": lambda: W.wmse2d_bwd(es[0], *maps, gs, offsets),
        "K3f_ms": lambda: W.cross_wmse2d_fwd(es[0], es[1], *maps, offsets),
        "K3b_ms": lambda: W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets, need_db=False),
        "K3bdb_ms": lambda: W.cross_wmse2d_bwd(es[0], es[1], *maps, gs, offsets)}, flush)
    s2 = W.affinity_wmse_2d_plain(req[0], *maps, offsets)[0]
    s3 = W.cross_affinity_wmse_2d_plain(req[0], es[1], *maps, offsets)[0]
    s3db = W.cross_affinity_wmse_2d_plain(*req, *maps, offsets)[0]
    plain = {
        "K2f": lambda: W.affinity_wmse_2d_plain(es[0], *maps, offsets),
        "K2b": lambda: torch.autograd.grad(s2, req[:1], gs, retain_graph=True),
        "K3f": lambda: W.cross_affinity_wmse_2d_plain(es[0], es[1], *maps, offsets),
        "K3b": lambda: torch.autograd.grad(s3, req[:1], gs, retain_graph=True),
        "K3bdb": lambda: torch.autograd.grad(s3db, req, gs, retain_graph=True)}
    for name, n_in, n_out in [("K2f", 1, 0), ("K2b", 1, 1), ("K3f", 2, 0), ("K3b", 2, 1),
                              ("K3bdb", 2, 2)]:
        bound, by = wmse_bound(2, side, 16, k, n_in, n_out, itemsize=2)
        f32_bound = wmse_bound(2, side, 16, k, n_in, n_out)[0]
        row = {"bf16_ms": t[f"{name}_ms"], "bf16_event_ms": t[f"{name}_event_ms"],
               "bf16_plain_ms": timed_ms(plain[name], flush_bytes=flush),
               "bf16_bound_ms": bound}
        print(f"[bf16] {name}{' (with db)' if name == 'K3bdb' else ''} bfloat16 B=2 {side}x{side} "
              f"C=16 K={k} (ms, L2 flushed, median of 20): kernel {row['bf16_ms']:.4f} by graph "
              f"replay, {row['bf16_event_ms']:.4f} by events, plain {row['bf16_plain_ms']:.4f}, "
              f"bound {bound:.4f} ({by}; float32's {f32_bound:.4f}); {card_line()}")
        if name == "K3bdb":
            res["K3b"].update({f"bf16_db_{f[5:]}": v for f, v in row.items()})
        else:
            res[name].update(row)
    return res


def _bf16_launch_names(preset: str) -> tuple:
    """The bfloat16 instantiations a bf16 train step of ``preset`` must run."""
    if preset == "ac3ac4":
        return tuple(f"{n}<__nv_bfloat16" for n in (
            "affinity3d_fwd_kernel", "affinity_bwd_kernel", "cross_affinity_fwd_kernel",
            "cross_affinity_bwd_kernel"))
    return ("wmse_fwd_kernel<__nv_bfloat16>", "wmse_bwd_kernel<__nv_bfloat16, true, false>",
            "wmse_bwd_kernel<__nv_bfloat16, false, false>")


def _train_bf16_one(preset: str, data, valid_batches: int = 0) -> dict:
    """train() on the full-width ``preset`` in bfloat16, TRAIN_STEPS steps
    from the device-resident sampler over ``data``'s arrays, validation and a
    checkpoint, every kernel's count set to 0 just before and read just
    after and held to its count; one step's device time by group, the
    bf16 instantiations it ran (and 3D: its peak memory); the
    first step's loss against float32's on the same weights and batch.
    Returns the launches."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.train import (TrainStep2D, TrainStep3D, init_state,
                                                     load_checkpoint, train)
    from pixel_embedded_affinity_torch.train.loop import resident_sampler

    is_3d = preset == "ac3ac4"
    label = f"bf16-{preset}"
    out = os.path.join(REPO, "build", f"chip_smoke_bf16_{preset}")
    shutil.rmtree(out, ignore_errors=True)
    over = {"model": {"dtype": "bfloat16"},
            "train": {"display_freq": 1, "valid_freq": TRAIN_STEPS, "save_freq": TRAIN_STEPS},
            "save_path": os.path.join(out, "models")}
    cfg, cfg32 = load_config(preset, over), load_config(preset)
    launchers = _train3d_launchers() if is_3d else _bbbc_launchers()
    for fn in launchers.values():
        fn.launches = 0
    timing: dict = {}
    t0 = time.perf_counter()
    state, history = train(cfg, max_iters=TRAIN_STEPS, data_override=data, device="cuda",
                           log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers.items()}
    print(f"[{label}] {preset} full width in bfloat16 ({cfg.model.filters}), B="
          f"{cfg.train.batch_size}, {TRAIN_STEPS} steps from the device-resident sampler + "
          f"validation + checkpoint: {wall:.2f} s; launches {json.dumps(launches)}")
    if is_3d:
        expect = {"K5f": TRAIN_STEPS + valid_batches, "K5b": TRAIN_STEPS, "K6f": TRAIN_STEPS,
                  "K6b": TRAIN_STEPS}
    else:
        expect = {"K2f": 5 * TRAIN_STEPS, "K2b": 5 * TRAIN_STEPS, "K3f": TRAIN_STEPS,
                  "K3b": TRAIN_STEPS, "K1f": len(data[1]), "K1b": 0, "K4f": 0, "K4b": 0}
    check(launches == expect, f"{label}: launches {launches}, expected {expect}")
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[{label}] loss per step: {losses}")
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), f"{label}: a non-finite loss")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
          f"{label}: validation {history}")
    print(f"[{label}] validation ({timing['valid_s'][0]:.4f} s wall): {json.dumps(history[0])}")
    print_step_times(label, timing, TRAIN_STEPS, HOST_DATA_MS.get(preset, float("nan")))
    ck = load_checkpoint(os.path.join(cfg.save_path, cfg.name, f"model-{TRAIN_STEPS:06d}.ckpt"))
    check(all(v.dtype == (np.int32 if path[-1] in ("count", "step") else np.float32)
              for path, v in tree_items(ck)),
          f"{label}: the checkpoint is not float32 (its counts int32)")
    check(all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
              for p in state.model.parameters() if p.grad is not None),
          f"{label}: parameters or gradients not float32")

    # the first step on the same weights and batch, bfloat16 against float32
    s16, s32 = init_state(cfg, "cuda"), init_state(cfg32, "cuda")
    batch = resident_sampler(cfg, data[0], "cuda")(0)
    if is_3d:
        step = TrainStep3D(ema_seed=cfg.train.random_seed)
    else:
        step = TrainStep2D(multi_offset(cfg.data.shifts, cfg.data.neighbor),
                           mask_weight=cfg.train.mask_weight,
                           imagenet_norm=preset == "cvppp", ema_seed=cfg.train.random_seed)
    batch = step.ema_batch(batch, 0)
    with torch.no_grad(), float32_convs():
        l16 = step.loss(copy.deepcopy(s16.model).train(), batch)[0].item()
        l32 = step.loss(copy.deepcopy(s32.model).train(), batch)[0].item()
    rel = abs(l16 - l32) / abs(l32)
    print(f"[{label}] first step's loss, same weights and batch: bfloat16 {l16!r}, float32 "
          f"{l32!r}, rel {rel:.3e} (bound {BF16_LOSS_RTOL})")
    check(rel <= BF16_LOSS_RTOL, f"{label}: bf16 loss off float32's by {rel}")

    if is_3d:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(s16, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"[{label}] device memory of one step: peak {peak / 2 ** 30:.4f} GiB allocated "
              f"({(peak - base) / 2 ** 30:.4f} GiB above the {base / 2 ** 30:.4f} GiB held before "
              f"it), {card_line()}")
    names = _bf16_launch_names(preset)
    rows = device_breakdown(lambda: step(s16, batch), 1, iters=3,
                            label=f"{label} step, {card_line()}", unit="step",
                            ours=("wmse", "affinity"), split=STEP_SPLIT, require=names)
    if not is_3d:
        check_k3b_form(rows, f"{label} step", "bfloat16")
    return launches


def phase_train_bf16(bbbc_arrays, bbbc_valid) -> dict:
    """CVPPP, BBBC and AC3/AC4 trained in bfloat16 on the card through the
    kernels' bfloat16 forms; returns the launches summed over the three."""
    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays

    total: dict = {}
    runs = [("cvppp", (pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED)),
                       synthetic_leaves(2, 530, 500, SEED + 1)), 0),
            ("bbbc039v1", (bbbc_arrays, bbbc_valid), 0),
            ("ac3ac4", *train3d_data())]
    for preset, data, valid_batches in runs:
        for k, v in _train_bf16_one(preset, data, valid_batches).items():
            total[k] = total.get(k, 0) + v
    return total


def phase_serving_bf16(cfg, sd, samples) -> dict:
    """CVPPP serving in bfloat16 at B=1 and B=4 (forward+affinity device
    ms/img; the served affinities against the float32 serve of the same
    weights; run_inference_2d with K1f's launches), then the tiled 3D
    predictor with bf16_tiled_infer (ms per tile batch of 4 x 18x160x160;
    the canvas of a 20x256x256 volume against float32's). Returns K1f's
    and K5f's launches."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import synthesize_volume
    from pixel_embedded_affinity_torch.infer import (
        build_model, build_tiled_predictor, forward_affinities, run_inference_2d,
        run_inference_3d)
    from pixel_embedded_affinity_torch.infer.inference3d import serving_dtype
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, fused_affinity_3d, multi_offset

    cfg16 = copy.deepcopy(cfg)
    cfg16.model.dtype = "bfloat16"
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    m16, m32 = build_model(cfg16, sd, device="cuda"), build_model(cfg, sd, device="cuda")
    check(m16.compute_dtype == torch.bfloat16, "the bf16 serving model's dtype")
    x_all = torch.from_numpy(np.stack([s["image"] for s in samples])).cuda()
    x_all = x_all.permute(0, 3, 1, 2).contiguous()
    for bs in (1, 4):
        x = x_all[:bs]
        ms = timed_ms(lambda: forward_affinities(m16, x, offsets), n=20)
        ms32 = timed_ms(lambda: forward_affinities(m32, x, offsets), n=20)
        a16, a32 = forward_affinities(m16, x, offsets), forward_affinities(m32, x, offsets)
        d = (a16 - a32).abs()
        mx, mean = d.max().item(), d.mean().item()
        print(f"[bf16-serve] CVPPP 544x544 B={bs}: forward+affinity {ms / bs:.4f} ms/img in "
              f"bfloat16, {ms32 / bs:.4f} in float32 (TF32 off), warm median of 20; served "
              f"affinities against float32's: max {mx:.3e}, mean {mean:.3e} (bounds "
              f"{BF16_SERVE_MAX}, {BF16_SERVE_MEAN}); {card_line()}")
        check(a16.dtype == torch.float32 and mx <= BF16_SERVE_MAX and mean <= BF16_SERVE_MEAN,
              f"bf16 served affinities off float32's by {mx}, {mean}")
        device_breakdown(lambda: forward_affinities(m16, x, offsets), bs,
                         label=f"bf16 serving B={bs}", ours=("affinity2d_fwd_kernel",),
                         require=("affinity2d_fwd_kernel<float",))
    fused_affinity_2d.launches = 0
    timing: dict = {}
    _, agg = run_inference_2d(cfg16, sd, samples, timing=timing, batch_size=4, device="cuda")
    k1f = fused_affinity_2d.launches
    print(f"[bf16-serve] run_inference_2d in bfloat16, B=4: K1f launches {k1f}; timing "
          f"{json.dumps(timing)}; metrics {json.dumps(agg)}")
    check(k1f == 1 and all(np.isfinite(v) for v in agg.values()), f"bf16 serving {k1f} {agg}")

    cfg3 = load_config("ac3ac4", {"model": {"bf16_tiled_infer": True}})
    check(serving_dtype(cfg3) == "bfloat16", "bf16_tiled_infer serves bfloat16")
    torch.manual_seed(SEED)
    sd3 = build_model(load_config("ac3ac4"), device="cpu").state_dict()
    p16 = build_tiled_predictor(build_model(cfg3, sd3, device="cuda", dtype="bfloat16"))
    p32 = build_tiled_predictor(build_model(cfg3, sd3, device="cuda", dtype="float32"))
    tiles = torch.rand((4, 1) + tuple(cfg3.data.crop_size), generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    ms16, ms32 = timed_ms(lambda: p16(tiles), n=20), timed_ms(lambda: p32(tiles), n=20)
    raw, _ = synthesize_volume(*BF16_CANVAS_VOLUME, n_cells=30, seed=SEED + 4)
    vol = raw.astype(np.float32) / 255.0
    fused_affinity_3d.launches = 0
    c16, _ = run_inference_3d(cfg3, sd3, vol, decoders=(), device="cuda")
    k5f = fused_affinity_3d.launches
    c32, _ = run_inference_3d(load_config("ac3ac4"), sd3, vol, decoders=(), device="cuda")
    d = np.abs(c16 - c32)
    print(f"[bf16-serve] 3D tile batch 4 x 18x160x160 (the dense module + K5f + ReLU, warm "
          f"median of 20; phase 9 also times the fast graph): "
          f"{ms16:.4f} ms with bf16_tiled_infer, {ms32:.4f} in float32; the canvas of a "
          f"{BF16_CANVAS_VOLUME} volume ({k5f} K5f launches) against float32's: max "
          f"{d.max():.3e}, mean {d.mean():.3e}; {card_line()}")
    check(c16.dtype == np.float32 and d.max() <= BF16_SERVE_MAX and d.mean() <= BF16_SERVE_MEAN,
          f"bf16 canvas off float32's by {d.max()}, {d.mean()}")
    device_breakdown(lambda: p16(tiles), 4, iters=5, label="bf16 3D tile batch", unit="tile",
                     ours=("affinity3d_fwd_kernel",), require=("affinity3d_fwd_kernel<float",))
    return {"K1f": k1f, "K5f": k5f}


def phase_gate_bf16() -> dict:
    """The BBBC quality gate in bfloat16 through the kernels, its floors
    asserted, its launches read around it; returns them."""
    fixture = dict(np.load(QUALITY_FIXTURE))
    launchers = _bbbc_launchers()
    for fn in launchers.values():
        fn.launches = 0
    r = run_gate("bbbc039v1", fixture, dtype="bfloat16",
                 out=os.path.join(REPO, "build", "quality_bf16", "bbbc039v1"))
    got = {k: fn.launches for k, fn in launchers.items()}
    steps = r["steps"]
    expect = {"K1f": GATE_VALID_IMAGES, "K2f": 5 * steps, "K2b": 5 * steps, "K3f": steps,
              "K3b": steps, "K1b": 0, "K4f": 0, "K4b": 0}
    print(f"[bf16-quality] {json.dumps(r)}")
    print(f"[bf16-quality] bbbc039v1 in bfloat16: floors {json.dumps(GATES['bbbc039v1']['floors'])}; "
          f"launches {json.dumps(got)}; {card_line()}")
    check(got == expect, f"bf16 gate launches {got}, expected {expect}")
    misses = gate_misses("bbbc039v1", r)
    check(not misses, f"bf16 quality gate missed: {misses}")
    return got


# ------------------------------------------------------------- 21. training CLI
CLI_STEPS, CLI_SPLIT, HOST_STEPS = 8, 4, 3
CLI_SCHEDULE = {"lr_mode": "poly", "base_lr": 1e-4, "end_lr": 1e-6, "warmup_iters": 2,
                "decay_iters": 6, "power": 1.5}
# steps 5-8 after the resume, and the validation loss after step 8, are
# held bit for bit against the uninterrupted run: the batches and EMA views
# are the same draws, the checkpoint's state the same bits, and the 2D
# float32 step gives the same bits on every run (its convs' backward is CWg
# and CXg, ROADMAP §3 item 18); a resume that drops the optimizer state or
# the schedule's count moves them by 7.4e-3 and 8.0e-3 (a CPU mutation
# check at filters 4..16)
# the host-built targets against the device builders: affinities and masks
# equal, the weights at 1e-5 relative (the host takes each class fraction
# in float64, the device in float32, and the majority class's weight
# f / (1 - f) carries its error times 1 / (1 - f);
# tests/test_torch_samplers.py); one host batch's loss through the kernels
# against the plain path
HOST_WEIGHT_RTOL, HOST_PLAIN_RTOL = 1e-5, 1e-5
HOST_3D_VOLUME, HOST_3D_CELLS, HOST_3D_VALID = (20, 280, 280), 40, (20, 160, 160)
HOST_BBBC_IMAGES = 2


def tree_items(tree, path=()):
    """(key path, leaf) of a nested dict, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    else:
        yield path, tree


def _all_launchers():
    """Each kernel wrapper once: affinity_bwd is K1b's and K5b's,
    cross_affinity_bwd K4b's and K6b's."""
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, fused_cross_affinity_2d

    return {**_wmse_launchers(), "K1f": fused_affinity_2d, "K4f": fused_cross_affinity_2d,
            **_train3d_launchers()}


def _counted(fn, *args, **kwargs):
    """fn(*args, **kwargs) with every kernel's count set to 0 just before;
    (result, launches, seconds)."""
    launchers = _all_launchers()
    for f in launchers.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, {k: f.launches for k, f in launchers.items()}, time.perf_counter() - t0


def _per_step(is_3d: bool, steps: int, valid: int) -> dict:
    """The launches of ``steps`` steps of the device-target path and
    ``valid`` K1f (2D) or K5f (3D) validation launches."""
    out = {k: 0 for k in _all_launchers()}
    if is_3d:
        out.update(K5f=steps + valid, K5b=steps, K6f=steps, K6b=steps)
    else:
        out.update(K2f=5 * steps, K2b=5 * steps, K3f=steps, K3b=steps, K1f=valid)
    return out


def _logged(run_dir: str) -> list:
    with open(os.path.join(run_dir, "log", "scalars.jsonl")) as f:
        return [json.loads(ln) for ln in f if '"lr"' in ln]


def _cli_yaml(path: str):
    """The cvppp preset with CLI_SCHEDULE as a YAML file: ``-c`` a file
    applies it over the defaults, as the JAX CLI reads it."""
    import yaml

    from pixel_embedded_affinity_torch.config import PRESETS

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return list(x) if isinstance(x, tuple) else x

    tree = plain(PRESETS["cvppp"])
    tree["train"].update(CLI_SCHEDULE)
    with open(path, "w") as f:
        f.write("# the cvppp preset, with a poly schedule\n")
        f.write(yaml.safe_dump(tree, default_flow_style=None, sort_keys=False))


def _host_setup(preset: str, fixture, out: str):
    """(config, training sampler, validation set, device-resident arrays,
    validation launches) of ``preset`` with the targets and the EMA view
    built on the host, from arrays in memory."""
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data import synthesize_nuclei, synthesize_volume
    from pixel_embedded_affinity_torch.data.cvppp import decoded_split
    from pixel_embedded_affinity_torch.data.device_data import (
        load_ac3ac4_arrays, pack_cvppp_arrays, pad_bbbc_arrays)
    from pixel_embedded_affinity_torch.parallel import tile_grid
    from pixel_embedded_affinity_torch.train import build_dataset, valid_geometry_3d

    cfg = load_config(preset, {
        "data": {"device_resident": False, "device_gt": False, "device_ema": False},
        "train": {"display_freq": 1, "valid_freq": HOST_STEPS, "save_freq": 10 ** 6},
        "save_path": os.path.join(out, f"host_{preset}")})
    if preset == "cvppp":
        decoded = decoded_split(fixture["cvppp_names"], fixture["cvppp_bgr"],
                                fixture["cvppp_label"], fixture["cvppp_valid_names"])
        arrays = pack_cvppp_arrays(decoded[0], cfg.data.padding)
    elif preset == "bbbc039v1":
        decoded = (synthesize_nuclei(HOST_BBBC_IMAGES, *BBBC_SHAPE, seed=SEED + 6),
                   synthesize_nuclei(1, *BBBC_SHAPE, seed=SEED + 7))
        arrays = pad_bbbc_arrays(decoded[0], cfg.data.bbbc_padding)
    else:
        volume = synthesize_volume(*HOST_3D_VOLUME, n_cells=HOST_3D_CELLS, seed=SEED + 3)
        decoded = (volume, synthesize_volume(*HOST_3D_VALID, n_cells=VALID3D_CELLS,
                                             seed=SEED + 4))
        cfg.data.train_split = HOST_3D_VOLUME[0]
        arrays = load_ac3ac4_arrays("", train_split=HOST_3D_VOLUME[0],
                                    crop_z=cfg.data.crop_size[0], arrays=volume)
    train_ds, valid = build_dataset(cfg, decoded)
    if preset == "ac3ac4":
        stride, pad = valid_geometry_3d(cfg.data.crop_size)
        tiles = len(tile_grid(tuple(np.add(HOST_3D_VALID, np.multiply(pad, 2))),
                              cfg.data.crop_size, stride))
        valid_launches = -(-tiles // 4)
    else:
        valid_launches = len(valid)
    return cfg, train_ds, valid, arrays, valid_launches


def _host_batch_checks(cfg, train_ds, label: str) -> dict:
    """One host batch on the card: its targets against the device builders,
    its loss through the kernels against the plain path; returns the
    errors."""
    import torch

    from pixel_embedded_affinity_torch.data.provider import collate, to_device
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops.targets import build_targets_2d, build_targets_3d
    from pixel_embedded_affinity_torch.train import init_state, make_train_step
    from pixel_embedded_affinity_torch.train.train_step import batch_targets_2d, batch_targets_3d

    is_3d = cfg.data.dataset == "ac3ac4"
    rng = np.random.default_rng(SEED + 21)
    batch = to_device(collate([train_ds.sample(rng) for _ in range(cfg.train.batch_size)]),
                      "cuda")
    seg = batch["seg"].long()
    if is_3d:
        host, dev = batch_targets_3d(batch), build_targets_3d(seg)
        pairs = [("affs", host[0], dev[0], "equal"), ("wmap", host[1], dev[1], "weight")]
        for k, ((ta, wa), (tb, wb)) in enumerate(zip(host[2], dev[2])):
            pairs += [(f"down{k + 1}", ta, tb, "equal"), (f"down{k + 1} w", wa, wb, "weight")]
    else:
        step = make_train_step(cfg)
        host = batch_targets_2d(batch, cfg.data.neighbor // 2)
        dev = build_targets_2d(seg, step.offsets, neighbor=cfg.data.neighbor)
        pairs = [("affs", host[0], dev[0], "equal"), ("wmap", host[1], dev[1], "weight"),
                 ("mask", host[2], dev[2], "equal")]
        for k, (a, b) in enumerate(zip(host[3], dev[3])):
            pairs += [(f"down{k + 1} t", a[0], b[0], "equal"),
                      (f"down{k + 1} w", a[1], b[1], "weight"),
                      (f"down{k + 1} m", a[2], b[2], "equal")]
    worst = 0.0
    for name, a, b, kind in pairs:
        check(a.shape == b.shape, f"{label}: {name} shapes {tuple(a.shape)} {tuple(b.shape)}")
        if kind == "equal":
            check(torch.equal(a, b), f"{label}: host {name} differs from the device builder's")
        else:
            rel = float(((a - b).abs() / b.abs()).max())
            worst = max(worst, rel)
            check(rel <= HOST_WEIGHT_RTOL, f"{label}: host {name} off by {rel:.3e} relative")
    model = init_state(cfg, "cuda").model
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.train.use_pallas = False
    losses = []
    for c in (cfg, plain_cfg):
        with torch.no_grad(), float32_convs():
            losses.append(make_train_step(c).loss(copy.deepcopy(model).train(), batch)[0].item())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"[{label}] one host batch on the card: affinities and masks equal to the device "
          f"builders', weights within {worst:.3e} relative (bound {HOST_WEIGHT_RTOL}); loss "
          f"through the kernels {losses[0]!r}, plain {losses[1]!r}, rel {rel:.3e} (bound "
          f"{HOST_PLAIN_RTOL}); {card_line()}")
    check(rel <= HOST_PLAIN_RTOL, f"{label}: kernels' loss off the plain path by {rel}")
    return {"weight_rel": worst, "loss_rel": rel}


def _device_data_ms(cfg, arrays, draws: int = 4) -> tuple:
    """The device sampler's data_s for ``cfg`` (ms, median of draws 2..):
    the host's time to launch a batch, as train() times it, and to the
    batch's completion."""
    import torch

    from pixel_embedded_affinity_torch.train.loop import resident_sampler

    dcfg = copy.deepcopy(cfg)
    dcfg.data.device_resident = dcfg.data.device_gt = dcfg.data.device_ema = True
    next_batch = resident_sampler(dcfg, arrays, "cuda")
    enq, done = [], []
    for i in range(draws):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next_batch(i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append(1e3 * (t1 - t0))
        done.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(enq[1:])), float(np.median(done[1:]))


def phase_training_cli() -> dict:
    """Phase 21: the training command line, the schedules, the msgpack
    checkpoints, SGD and the host samplers (see the module's docstring);
    returns each kernel's launches over the phase's runs."""
    import torch

    from pixel_embedded_affinity_torch.checkpoint import load_jax_checkpoint
    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import train
    from pixel_embedded_affinity_torch.train.__main__ import main
    from pixel_embedded_affinity_torch.train.optim import SGD, make_schedule

    out = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    total = {k: 0 for k in _all_launchers()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    card = card_line()
    fixture = dict(np.load(QUALITY_FIXTURE))
    cvppp_cfg = load_config("cvppp")
    data = gate_data(cvppp_cfg, fixture)
    yml = os.path.join(out, "cvppp_poly.yaml")
    _cli_yaml(yml)

    def argv(save, iters, *extra):
        return ["-c", yml, "-i", str(iters), "-o", f"save_path={save}",
                "train.display_freq=1", f"train.valid_freq={CLI_STEPS}",
                f"train.save_freq={CLI_SPLIT}", *extra]

    # (a) 8 steps uninterrupted; 4 steps, a checkpoint, a resume to 8
    full_dir, split_dir = os.path.join(out, "full"), os.path.join(out, "split")
    (state, history), got, sec = _counted(main, argv(full_dir, CLI_STEPS), data_override=data)
    full_valid = history[0]["valid/loss"] if history else float("nan")
    check(state.step == CLI_STEPS and len(history) == 1
          and all(np.isfinite(v) for v in history[0].values()), f"cli: validation {history}")
    expect = _per_step(False, CLI_STEPS, len(data[1]))
    print(f"[cli] -c {os.path.basename(yml)} (cvppp, {json.dumps(CLI_SCHEDULE)}) -i {CLI_STEPS}: "
          f"{sec:.2f} s with validation; launches {json.dumps(got)}; {card}")
    check(got == expect, f"cli: launches {got}, expected {expect}")
    add(got)
    (_, _), got_a, _ = _counted(main, argv(split_dir, CLI_SPLIT), data_override=data)
    ck = os.path.join(split_dir, "cvppp", f"model-{CLI_SPLIT:06d}.ckpt")
    with open(ck, "rb") as f:
        head = f.read(1)
    tree = load_jax_checkpoint(ck)
    check(head == b"\x84" and sorted(tree) == ["batch_stats", "opt_state", "params", "step"]
          and int(tree["step"]) == CLI_SPLIT and int(tree["opt_state"]["2"]["count"]) == CLI_SPLIT,
          f"cli: {ck} is not the JAX package's msgpack train state")
    (state, history), got_b, sec = _counted(main, argv(split_dir, CLI_STEPS, "train.resume=True"),
                                            data_override=data)
    check(state.step == CLI_STEPS and len(history) == 1, f"cli: resumed run {history}")
    valid_rel = abs(history[0]["valid/loss"] - full_valid) / abs(full_valid)
    expect = _per_step(False, CLI_SPLIT, 0)
    check(got_a == expect, f"cli: launches of the first half {got_a}, expected {expect}")
    expect = _per_step(False, CLI_STEPS - CLI_SPLIT, len(data[1]))
    check(got_b == expect, f"cli: launches after the resume {got_b}, expected {expect}")
    add(got_a)
    add(got_b)
    sched = make_schedule(**{k: CLI_SCHEDULE[k] for k in CLI_SCHEDULE if k != "lr_mode"},
                          lr_mode="poly", total_iters=cvppp_cfg.train.total_iters)
    full = _logged(os.path.join(full_dir, "cvppp"))
    split = _logged(os.path.join(split_dir, "cvppp"))
    for rows, name in ((full, "uninterrupted"), (split, "resumed")):
        check([r["step"] for r in rows] == list(range(1, CLI_STEPS + 1)),
              f"cli: {name} run logged steps {[r['step'] for r in rows]}")
        off = [r["step"] for r in rows if r["lr"] != sched(r["step"] - 1)]
        check(not off, f"cli: {name} run's rate off the schedule at steps {off}")
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
           for a, b in zip(split[CLI_SPLIT:], full[CLI_SPLIT:])]
    print(f"[cli] rate per step {[r['lr'] for r in full]} (schedule(step - 1) at every step, "
          f"both runs); losses {[r['loss'] for r in full]}")
    print(f"[cli] resumed at step {CLI_SPLIT} from {os.path.relpath(ck, REPO)} (msgpack, "
          f"{os.path.getsize(ck)} bytes): steps {CLI_SPLIT + 1}-{CLI_STEPS} "
          f"{[r['loss'] for r in split[CLI_SPLIT:]]}, max rel {max(rel):.3e} against the "
          f"uninterrupted run; validation loss rel {valid_rel:.3e} (held bit for bit); {card}")
    check(max(rel) == 0, f"cli: resumed losses off by {max(rel)}")
    check(valid_rel == 0, f"cli: resumed validation loss off by {valid_rel}")

    # (b) SGD
    sgd_dir = os.path.join(out, "sgd")
    (state, _), got, sec = _counted(
        main, ["-c", "cvppp", "-i", str(HOST_STEPS), "-o", f"save_path={sgd_dir}",
               "train.opt_type=sgd", "train.display_freq=1", "train.if_valid=False"],
        data_override=data)
    losses = [r["loss"] for r in _logged(os.path.join(sgd_dir, "cvppp"))]
    moved = all(torch.count_nonzero(st["trace"]) > 0 for st in state.optimizer.state.values())
    print(f"[cli-sgd] -c cvppp -o train.opt_type=sgd -i {HOST_STEPS}: {sec:.2f} s, losses "
          f"{losses}; launches {json.dumps(got)}; {card}")
    check(isinstance(state.optimizer, SGD) and moved and len(losses) == HOST_STEPS
          and all(np.isfinite(losses)), "cli-sgd: a non-finite loss or no momentum")
    check(got == _per_step(False, HOST_STEPS, 0), f"cli-sgd: launches {got}")
    add(got)

    # (c) the host samplers, targets and EMA views built on the host
    for preset in ("cvppp", "bbbc039v1", "ac3ac4"):
        label = f"host-{preset}"
        t0 = time.perf_counter()
        cfg, train_ds, valid, arrays, valid_launches = _host_setup(preset, fixture, out)
        made = time.perf_counter() - t0
        _host_batch_checks(cfg, train_ds, label)
        timing: dict = {}
        (state, history), got, sec = _counted(train, cfg, max_iters=HOST_STEPS,
                                              data_override=(train_ds, valid), device="cuda",
                                              timing=timing)
        losses = [r["loss"] for r in _logged(os.path.join(cfg.save_path, cfg.name))]
        expect = _per_step(preset == "ac3ac4", HOST_STEPS, valid_launches)
        host_ms = 1e3 * float(np.median(timing["data_s"][1:]))
        step_ms = 1e3 * float(np.median(timing["step_s"][1:]))
        dev_enq, dev_done = _device_data_ms(cfg, arrays)
        print(f"[{label}] {preset} full width ({cfg.model.filters}), B={cfg.train.batch_size}, "
              f"{HOST_STEPS} steps from the host sampler (device_resident, device_gt, device_ema "
              f"False; data made in {made:.2f} s) + validation: {sec:.2f} s; losses {losses}; "
              f"launches {json.dumps(got)}")
        print(f"[{label}] data_s (median of steps 2..{HOST_STEPS}): host sampler "
              f"{host_ms:.4f} ms (2 sample threads, the batch's wait and copy), device sampler "
              f"{dev_enq:.4f} ms to launch, {dev_done:.4f} ms to completion; step "
              f"{step_ms:.4f} ms; {card}")
        check(len(losses) == HOST_STEPS and all(np.isfinite(losses)), f"{label}: losses {losses}")
        check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
              f"{label}: validation {history}")
        check(got == expect, f"{label}: launches {got}, expected {expect}")
        add(got)
    print(f"[cli] phase 21 launches {json.dumps(total)}")
    return total


# the model families' phase: the ResNet presets' steps (the first loss
# through the kernels against the plain path's, as HOST_PLAIN_RTOL), MALA at
# the reference geometry against its float64 run, relative to the largest
# output (float32 sums of up to 1500 x 27 products, TF32 off)
RESNET_STEPS = {"cvppp_resnet50": 8, "cvppp_resnet101": 3}
RESNET_PLAIN_RTOL = 1e-5
MALA_INPUT, MALA_OUTPUT = (1, 1, 53, 268, 268), (1, 16, 25, 56, 56)
MALA_F64_RTOL = 1e-4


def _train_resnet(name: str, arrays, valid, samples) -> dict:
    """train() on the full-width ``name`` preset from the device sampler,
    every 2D kernel's count set to 0 just before and read just after; the
    first step's loss through the kernels against the plain path, loss_disc
    finite, one step's device time and peak memory; for ResNet-50, 4
    images served at B=1 through K1f. Returns the launches."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.device_data import (
        sample_cvppp_batch, sampler_generator)
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import run_inference_2d
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad
    from pixel_embedded_affinity_torch.train import init_state, make_train_step, train

    steps = RESNET_STEPS[name]
    out = os.path.join(REPO, "build", f"chip_smoke_{name}")
    shutil.rmtree(out, ignore_errors=True)
    cfg = load_config(name, {"train": {"display_freq": 1, "valid_freq": steps,
                                       "save_freq": 10 ** 6},
                             "save_path": os.path.join(out, "models")})
    print(f"[{name}] {cfg.model.arch}, loss_mode {cfg.train.loss_mode} (disc_weight "
          f"{cfg.train.disc_weight}), B={cfg.train.batch_size} 544x544 from the device sampler "
          f"over {len(arrays[0])} leaf images, {steps} steps, validation on {len(valid)}, convs "
          f"in float32 (TF32 off)")

    # the first step's loss at the initial weights, through the kernels and
    # the plain path, on the sampler's first batch and EMA view
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg)
    images, labels = (torch.from_numpy(a).cuda() for a in arrays)
    batch = step.ema_batch(sample_cvppp_batch(images, labels,
                                              sampler_generator(cfg.train.random_seed, 0),
                                              cfg.train.batch_size, out=cfg.data.size), 0)
    first = {}
    for use_pallas in (True, False):
        step.use_pallas = use_pallas
        with torch.no_grad(), float32_convs():
            loss, _, metrics = step.loss(copy.deepcopy(state.model).train(), batch)
        first[use_pallas] = (loss.item(), metrics["loss_disc"].item())
    step.use_pallas = True
    rel = abs(first[True][0] - first[False][0]) / abs(first[False][0])
    print(f"[{name}] first loss {first[True][0]!r} through the kernels, {first[False][0]!r} "
          f"plain ({rel:.2e} relative, bound {RESNET_PLAIN_RTOL}); loss_disc {first[True][1]!r}")
    check(rel <= RESNET_PLAIN_RTOL, f"{name}: first loss off the plain path's by {rel}")
    check(np.isfinite(first[True][1]) and first[True][1] > 0, f"{name}: loss_disc {first}")

    launchers = {**_wmse_launchers(), "K1f": fused_affinity_2d, "CWg": conv_wgrad,
                 "CXg": conv_dgrad}
    for fn in launchers.values():
        fn.launches = 0
    timing: dict = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained, history = train(cfg, max_iters=steps, data_override=(arrays, valid),
                             device="cuda", log_dir=os.path.join(out, "log"), timing=timing)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: fn.launches for k, fn in launchers.items()}
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    print(f"[{name}] {wall:.2f} s for {steps} steps + validation + checkpoint; peak device "
          f"memory {peak:.4f} GiB; launches {json.dumps(launches)}; loss per step {losses}; "
          f"validation {json.dumps(history)}")
    n_w, n_x = conv_grads_per_step(name, arrays)
    for k, per_step in (("K2f", 5), ("K2b", 5), ("K3f", 1), ("K3b", 1), ("CWg", n_w),
                        ("CXg", n_x)):
        check(launches[k] == per_step * steps, f"{name}: {k} launched {launches[k]} times")
    check(launches["K1f"] == len(valid), f"{name}: K1f launched {launches['K1f']} times")
    check(len(losses) == steps and all(np.isfinite(losses)), f"{name}: losses {losses}")
    check(len(history) == 1 and all(np.isfinite(v) for v in history[0].values()),
          f"{name}: validation {history}")
    print_step_times(name, timing, steps, HOST_DATA_MS["cvppp"])
    device_breakdown(lambda: step(trained, batch), 1, iters=2, label=f"{name} step B=2 544x544",
                     unit="step", ours=("wmse",), split=STEP_SPLIT, require=WMSE_KERNELS)
    if name != "cvppp_resnet50":
        return launches
    sd = trained.model.state_dict()
    run_inference_2d(cfg, sd, samples[:1], batch_size=1, device="cuda")  # warm-up
    fused_affinity_2d.launches = 0
    served: dict = {}
    _, agg = run_inference_2d(cfg, sd, samples, timing=served, batch_size=1, device="cuda")
    k1f = fused_affinity_2d.launches
    print(f"[{name}] served {len(samples)} images at B=1: K1f launches {k1f}; timing "
          f"{json.dumps(served)}; metrics {json.dumps(agg)}; {card_line()}")
    check(k1f == len(samples) and all(np.isfinite(v) for v in agg.values()),
          f"{name} serving: {k1f} launches, {agg}")
    launches["K1f"] += k1f
    return launches


def phase_model_families(samples) -> dict:
    """The ResNet-50/101 presets trained at full width through K2f/K2b/
    K3f/K3b with the discriminative term (ResNet-50 validated and served
    through K1f), and MALA at the reference geometry against float64, with
    the small golden; returns the kernels' launches."""
    import torch

    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.models import UNet3DMALADeep

    arrays = pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED))
    valid = synthetic_leaves(2, 530, 500, SEED + 1)
    launches: dict = {}
    for name in RESNET_STEPS:
        for k, n in _train_resnet(name, arrays, valid, samples).items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()

    torch.manual_seed(SEED)
    model = UNet3DMALADeep(16).cuda().eval()
    x = torch.rand(MALA_INPUT, generator=torch.Generator(device="cuda").manual_seed(SEED),
                   device="cuda")
    with torch.no_grad(), float32_convs():
        out = model(x)  # cuDNN plans the 1500-channel convs at the first call
        torch.cuda.reset_peak_memory_stats()
        ms = timed_ms(lambda: model(x), n=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = model(x)
        t0 = time.perf_counter()
        ref = copy.deepcopy(model).double()(x.double())
        torch.cuda.synchronize()
        s64 = time.perf_counter() - t0
    err = (out.double() - ref).abs().max().item() / ref.abs().max().item()
    print(f"[mala] UNet3DMALADeep widths (12, 60, 300, 1500), emd 16: {tuple(x.shape)} -> "
          f"{tuple(out.shape)}; {ms:.4f} ms a forward (warm median of 5, TF32 off), peak "
          f"device memory {peak:.4f} GiB; against float64 on the card ({s64:.2f} s): "
          f"{err:.3e} of the largest output (bound {MALA_F64_RTOL}); {card_line()}")
    check(tuple(out.shape) == MALA_OUTPUT, f"MALA output {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()) and err <= MALA_F64_RTOL, f"MALA off float64 by {err}")
    del model, ref
    torch.cuda.empty_cache()

    data = np.load(os.path.join(REPO, "tests", "fixtures", "unet3d_mala_small.npz"))
    sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("sd/")}
    small = UNet3DMALADeep(int(data["emd"][0]), tuple(int(v) for v in data["widths"]))
    small.load_state_dict(sd)
    small = small.cuda().eval()
    xs = np.random.default_rng(int(data["input_seed"][0])).standard_normal(
        tuple(data["input_shape"])).astype(np.float32)
    with torch.no_grad(), float32_convs():
        got = small(torch.from_numpy(xs).cuda()).cpu().numpy()
    gerr = float(np.abs(got - data["out/0"]).max())
    print(f"[mala] the small golden (widths {tuple(int(v) for v in data['widths'])}, "
          f"{xs.shape} -> "
          f"{got.shape}): max error {gerr:.3e} (bound atol {FIXTURE_TOL['atol']}, rtol "
          f"{FIXTURE_TOL['rtol']})")
    check(got.shape == data["out/0"].shape and np.allclose(got, data["out/0"], **FIXTURE_TOL),
          f"MALA golden off by {gerr}")
    return launches


# ---- 23. the host library: the ablation losses, the decoders, clustering,
# the validation montage, FLOP counts, the deterministic step

# the decoders' crop of phase 9's served canvas, and waterz's thresholds
DECODE_CROP = (20, 512, 512)
DECODE_THRESHOLDS = (0.3, 0.5, 0.7)
MALIS_SLICES = 10
# LmcSuperpixel's long-range offsets ((-2, 0, 0), (0, -9, 0), (0, 0, -9)) are
# channels 3, 7 and 8 of the 12-channel canvas (channel i shifts axis i % 3
# by SHIFTS_3D[i])
LMC_LONG_CHANNELS = (3, 7, 8)
# the upsampling backward against its plain version's function (My^T g Mx
# with the forward's own weights on the card, the products in float64) on
# the same inputs, relative to the largest gradient: float32 sums of up to
# 5 x 5 products, the kernels' float32 gate; bfloat16 outputs rounded to
# 2^-8; float64 its own rounding. (Weights from a formula instead differ
# from the card's forward at some sizes by an ulp of the source index:
# 1.5e-5 of the gradient at 136 -> 272 on an H100, PERF.md.)
UPB_RTOL = {"float32": 1e-5, "bfloat16": 8e-3, "float64": 1e-12}
# its inputs at full width: the CVPPP model's four decoder upsamplings at
# B=2 544x544 (NCHW: up1..up4) and the 3D model's at B=2 18x160x160
# (NCDHW: up0..up3); timed at the largest, (2, 96, 272, 272)
UPB_SHAPES = [(2, 256, 34, 34), (2, 384, 68, 68), (2, 192, 136, 136), (2, 96, 272, 272),
              (2, 80, 18, 10, 10), (2, 64, 18, 20, 20), (2, 48, 18, 40, 40),
              (2, 36, 18, 80, 80)]
UPB_TIMED = 3
UPB_SOURCE = "pixel_embedded_affinity_torch/csrc/upsample_bwd.cu"
# each ablation loss in float32 (TF32 off) against the same loss in float64
# on the card: sums over ~6e6 terms in another precision
HOSTLIB_LOSS_RTOL = 1e-5
# the clustering's embedding: a 544x544 leaf image, each leaf's pixels at
# a random centre (16 channels, spread 3 per channel) plus Gaussian noise
# of CLUSTER_NOISE, far inside DBSCAN's eps 0.3 (pairs within a leaf
# ~0.11 apart) and MeanShift's bandwidth; MeanShift with that bandwidth,
# since the estimate (quantile 0.3) spans several leaves
CLUSTER_NOISE = 0.02
CLUSTER_MIN_PIXELS = 400
MEANSHIFT_BANDWIDTH = 1.0


def _ms(fn, dev) -> float:
    """fn's time in ms: CUDA events on the card (median of 5, after a
    warm-up), the host clock elsewhere."""
    if str(dev).startswith("cuda"):
        return timed_ms(fn, n=5)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def phase_upsample_bwd() -> dict:
    """The deterministic upsampling backward (csrc/upsample_bwd.cu) against
    its plain version at the decoders' shapes, float32, bfloat16 and
    float64, and against PyTorch's own (atomic) backward of F.interpolate;
    each shape's kernel run twice, bit for bit; its time at the largest 2D
    shape with L2 flushed beside the plain version's, PyTorch's backward
    (library_ms) and the bound. Returns the kernel line's fields."""
    import torch

    from pixel_embedded_affinity_torch.ops.upsample_cuda import (forward_matrix, upsample_bwd,
                                                                 upsample_bwd_plain,
                                                                 upsample_fwd)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    worst, worst_plain, worst_lib = {}, {}, {}
    atomic_repeats = 0
    for shape in UPB_SHAPES:
        out_shape = shape[:-2] + (2 * shape[-2], 2 * shape[-1])
        for name, rtol in UPB_RTOL.items():
            dt = getattr(torch, name)
            g = torch.randn(out_shape, generator=gen, device="cuda").to(dt)
            got, again = upsample_bwd(g), upsample_bwd(g)
            check(torch.equal(got, again), f"upsample_bwd {shape} {name}: two runs differ")
            # the plain version's function on the same inputs: the forward's
            # matrices on the card (float32 weights for float32 and
            # bfloat16), the products in float64
            acc = torch.float64 if name == "float64" else torch.float32
            my, mx = (forward_matrix(out_shape[ax] // 2, ax, len(shape), "cuda", acc).double()
                      for ax in (-2, -1))
            ref = my.t() @ g.double() @ mx
            err = rel_err64(got, ref)
            plain = rel_err64(upsample_bwd_plain(g), ref)
            check(err <= rtol, f"upsample_bwd {shape} {name}: {err:.3e} off the plain version "
                  f"(its products in float64; the plain version in {name}: {plain:.3e})")
            # PyTorch's own backward, held in float32, the training dtype:
            # in bfloat16 its atomics round each partial sum to bfloat16,
            # and in float64 its weights differ from its forward's by ~1e-8
            # on an H100, where the kernel takes the forward's
            x = torch.zeros(shape, dtype=dt, device="cuda", requires_grad=True)
            upsample_fwd(x).backward(g)
            lib = rel_err64(got, x.grad)
            check(name != "float32" or lib <= rtol, f"upsample_bwd {shape} {name}: "
                  f"{lib:.3e} off F.interpolate's backward")
            worst_lib[name] = max(worst_lib.get(name, 0.0), lib)
            x2 = torch.zeros(shape, dtype=dt, device="cuda", requires_grad=True)
            upsample_fwd(x2).backward(g)
            atomic_repeats += not torch.equal(x.grad, x2.grad)
            worst[name] = max(worst.get(name, 0.0), err)
            worst_plain[name] = max(worst_plain.get(name, 0.0), plain)
    torch.cuda.synchronize()
    print(f"[upsample] the deterministic upsampling backward against its plain version "
          f"(products in float64) at {len(UPB_SHAPES)} decoder shapes: max rel error "
          f"{json.dumps(worst)} "
          f"(the plain version in each dtype: {json.dumps(worst_plain)}; PyTorch's "
          f"backward, against the kernel: {json.dumps(worst_lib)}), two runs "
          f"bit-equal at every shape; PyTorch's own backward gave two different results at "
          f"{atomic_repeats} of {3 * len(UPB_SHAPES)} shape and dtype pairs")
    shape = UPB_SHAPES[UPB_TIMED]
    out_shape = shape[:-2] + (2 * shape[-2], 2 * shape[-1])
    g = torch.randn(out_shape, generator=gen, device="cuda")
    g16 = g.bfloat16()
    flush = 64 << 20

    def library():
        return torch.ops.aten.upsample_bilinear2d_backward(
            g, list(out_shape[-2:]), list(shape), True, None, None)

    t = {"ms": graph_ms(lambda: upsample_bwd(g), flush_bytes=flush),
         "event_ms": timed_ms(lambda: upsample_bwd(g), flush_bytes=flush),
         "plain_ms": timed_ms(lambda: upsample_bwd_plain(g), flush_bytes=flush),
         "library_ms": graph_ms(library, flush_bytes=flush),
         "bf16_ms": graph_ms(lambda: upsample_bwd(g16), flush_bytes=flush)}
    n_in = int(np.prod(shape))
    t_bytes = (g.numel() + n_in) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 8 * g.numel() / F32_FLOPS_PER_S * 1e3  # 4 multiply-adds an output gradient
    t["bound_ms"], t["bound_by"] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    t["max_abs_err"] = worst["float32"]
    print(f"[upsample] {shape} -> {out_shape} float32, L2 flushed: kernel {t['ms']:.4f} ms "
          f"(graph replay; events {t['event_ms']:.4f}), bf16 {t['bf16_ms']:.4f}, plain {t['plain_ms']:.4f}, PyTorch's atomic backward {t['library_ms']:.4f}, "
          f"bound {t['bound_ms']:.4f} ({t['bound_by']}); {card_line()}")
    return t


def _loss_cases(dev, dtype):
    """(name, fn) pairs: each ablation loss of the port's host library on
    full-width inputs in ``dtype`` on ``dev``, every input made from SEED
    on the host; fn() -> (loss, leaf tensors that take gradients)."""
    import torch
    import torch.nn.functional as F

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.ops import losses as L, losses_extra as X, spixel
    from pixel_embedded_affinity_torch.ops import multi_offset
    from pixel_embedded_affinity_torch.ops.affinity_np import gen_affs_mutex_3d
    from pixel_embedded_affinity_torch.ops.offsets import shift_channels_offsets
    from pixel_embedded_affinity_torch.ops.targets import gen_affs, weight_binary_ratio

    cfg = load_config("cvppp")
    offsets = multi_offset(list(cfg.data.shifts), cfg.data.neighbor)
    rng = np.random.default_rng(SEED + 41)
    side = HOSTLIB_SIDE
    seg_np = np.stack([lab for _, lab in leaf_pairs(2, side, side, SEED + 42)])
    seg = torch.from_numpy(seg_np).to(dev)
    affs, mask = gen_affs(seg, offsets)
    weight = weight_binary_ratio(affs)
    affs, mask, weight = (t.to(dtype) for t in (affs, mask, weight))

    def emb(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(
            dev, dtype).requires_grad_(True)

    e2 = emb((2, side, side, 16), SEED + 43)

    def affinity_loss(a):
        return sum(L.weighted_mse(a[:, i] * mask[:, i], affs[:, i] * mask[:, i], weight[:, i])
                   for i in range(a.shape[1]))

    cases = [
        ("cosine_affinity_2d", lambda: (affinity_loss(X.cosine_affinity_2d(e2, offsets)), [e2])),
        ("embeddings_to_affinities_distance",
         lambda: (affinity_loss(X.embeddings_to_affinities_distance(e2, offsets)), [e2])),
        ("rescaled_affinity", lambda: (affinity_loss(X.rescaled_affinity(
            L.embedding_loss_2d(e2, affs, weight, mask, offsets, use_pallas=False)[1])), [e2])),
        ("embedding_loss_orthogonal", lambda: (X.embedding_loss_orthogonal(
            e2, affs, weight, mask, L.weighted_mse, offsets)[0], [e2])),
        ("discriminative_loss", lambda: (X.discriminative_loss(e2, seg), [e2])),
    ]
    n_rows = int(seg_np.max())
    neigh = torch.from_numpy(np.stack([X.instance_neighbor_lists(s, n_rows, 8)
                                       for s in seg_np])).to(dev)
    cases.append(("local_embedding_loss", lambda: (X.local_embedding_loss(e2, seg, neigh),
                                                   [e2])))
    # deep supervision: the four auxiliary heads at 1/2 .. 1/16 with their
    # offsets' targets packed (affs | weights | masks)
    heads, downs = [], []
    for k in range(4):
        s_k = side >> (k + 1)
        n_off = 2 * (4 - k)
        seg_k = seg[:, ::2 ** (k + 1), ::2 ** (k + 1)]
        a_k, m_k = gen_affs(seg_k, offsets[:n_off])
        downs.append(torch.cat([a_k, weight_binary_ratio(a_k), m_k.to(a_k.dtype)], 1).to(dtype))
        heads.append(emb((2, s_k, s_k, 16), SEED + 44 + k))
    cases.append(("deep_supervision_losses_2d", lambda: (L.deep_supervision_losses_2d(
        heads, downs, offsets, use_pallas=False), heads)))
    # the superpixel loss: 16x16 cells, the leaves one-hot and the (x, y)
    # position features
    logits = emb((2, 9, side, side), SEED + 48)
    onehot = F.one_hot(seg.long(), n_rows + 1).permute(0, 3, 1, 2).to(dtype)
    yy, xx = torch.meshgrid(torch.arange(side, device=dev, dtype=dtype),
                            torch.arange(side, device=dev, dtype=dtype), indexing="ij")
    xy = torch.stack([xx, yy])[None].expand(2, -1, -1, -1) / 16
    labxy = torch.cat([onehot, xy], 1)
    cases.append(("compute_semantic_pos_loss", lambda: (spixel.compute_semantic_pos_loss(
        torch.softmax(logits, 1), labxy)[0], [logits])))
    # norm6 at the 3D training crop, the 23 mutex offsets, with its EMA form
    d3, s3 = HOSTLIB_3D
    offs3 = shift_channels_offsets(23)
    seg3 = np.stack([synthesize_labels_3d(d3, s3, SEED + 49 + i) for i in range(2)])
    t3 = torch.from_numpy(np.stack([gen_affs_mutex_3d(v, offs3) for v in seg3])).to(dev, dtype)
    w3 = weight_binary_ratio(t3, dims=(-3, -2, -1))
    e3 = emb((2, d3, s3, s3, 16), SEED + 51)
    ema3 = torch.from_numpy(rng.standard_normal((2, d3, s3, s3, 16))).to(dev, dtype)
    cases.append(("embedding_loss_norm6", lambda: (X.embedding_loss_norm6(
        e3, t3, w3, L.weighted_mse, offs3)[0], [e3])))
    cases.append(("embedding_loss_norm6 (EMA)", lambda: (X.embedding_loss_norm6(
        e3, t3, w3, L.weighted_mse, offs3, ema_embedding=ema3)[0], [e3])))
    return cases


def synthesize_labels_3d(d: int, side: int, seed: int) -> np.ndarray:
    """A (d, side, side) label volume of the 3D synthesizer's cells."""
    from pixel_embedded_affinity_torch.data import synthesize_volume

    return synthesize_volume(d, side, side, n_cells=40, seed=seed)[1].astype(np.int64)


# the losses' sizes: 2D at the CVPPP training batch, 3D at the training crop
HOSTLIB_SIDE = 544
HOSTLIB_3D = (18, 160)


def hostlib_losses(dev="cuda"):
    """Each ablation loss forward and backward at full width in float32
    (TF32 off) against the same in float64 on ``dev``; its ms a forward and
    backward by CUDA events."""
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs

    with float32_convs():
        cases32 = _loss_cases(dev, torch.float32)
        cases64 = dict(_loss_cases(dev, torch.float64))
        for name, fn in cases32:
            loss, leaves = fn()
            ref, ref_leaves = cases64[name]()
            for t in leaves + ref_leaves:  # the cases share their embeddings
                t.grad = None
            loss.backward()
            ref.backward()
            err = abs(loss.item() - ref.item()) / max(abs(ref.item()), 1e-30)
            gerr = max(rel_err(a.grad.double(), b.grad) for a, b in zip(leaves, ref_leaves))

            def fwd_bwd():
                for t in leaves:
                    t.grad = None
                fn()[0].backward()

            ms = _ms(fwd_bwd, dev)
            print(f"[hostlib] {name}: loss {loss.item():.6f}, rel {err:.3e} off float64 "
                  f"(gradient {gerr:.3e}); {ms:.4f} ms a forward and backward")
            check(np.isfinite(loss.item()) and err <= HOSTLIB_LOSS_RTOL,
                  f"{name}: {err:.3e} off float64")


def hostlib_decoders(canvas, label):
    """The host decoders on a crop of phase 9's served canvas: seg_waterz,
    agglomerate_multi, multicut_multi on the waterz fragments,
    LmcSuperpixel with the canvas' long-range channels, MALIS weights;
    seconds and VOI/ARAND against the crop's labels."""
    from pixel_embedded_affinity_torch.metrics import adapted_rand_error, voi
    from pixel_embedded_affinity_torch.postproc import (agglomerate_multi, multicut_multi,
                                                        seg_waterz, watershed_from_affs)
    from pixel_embedded_affinity_torch.postproc.malis import malis_weights
    from pixel_embedded_affinity_torch.postproc.mc_baselines import LmcSuperpixel

    affs = np.ascontiguousarray(canvas[:3])
    lab = label.astype(np.int64)

    def scored(name, fn):
        t0 = time.perf_counter()
        seg = fn()
        sec = time.perf_counter() - t0
        segs = seg if isinstance(seg, list) else [seg]
        scores = []
        for s in segs:
            check(s.shape == lab.shape, f"{name}: {s.shape}")
            vs, vm = voi(lab, s.astype(np.int64))
            scores.append((round(vs + vm, 6), round(adapted_rand_error(lab, s.astype(np.int64))[0],
                                                    6)))
        print(f"[hostlib] {name} on {lab.shape}: {sec:.3f} s, (VOI, ARAND) {scores}")
        return seg

    scored("seg_waterz", lambda: seg_waterz(affs, 0.5))
    frags = watershed_from_affs(affs)
    scored(f"agglomerate_multi {DECODE_THRESHOLDS}",
           lambda: agglomerate_multi(affs, frags, DECODE_THRESHOLDS))
    scored("multicut_multi (given the waterz fragments)", lambda: multicut_multi(affs, frags))
    scored("LmcSuperpixel", lambda: LmcSuperpixel()(affs, canvas[list(LMC_LONG_CHANNELS)]))
    # MALIS on the crop's first MALIS_SLICES slices: its Kruskal passes over
    # all 20 (15.7e6 edges) took 21.9 s on the H100's host (PERF.md)
    t0 = time.perf_counter()
    w = malis_weights(affs[:, :MALIS_SLICES], label[:MALIS_SLICES].astype(np.uint32))
    print(f"[hostlib] malis_weights on {lab[:MALIS_SLICES].shape}: "
          f"{time.perf_counter() - t0:.3f} s, "
          f"weights sum {float(w.sum()):.6f}, max {float(w.max()):.3e}")
    check(np.isfinite(w).all() and w.min() >= 0, "malis weights")


def cluster_leaves(side: int, seed: int):
    """(embedding (side, side, 16) float32, leaf labels): each leaf's pixels
    at its own random centre plus CLUSTER_NOISE."""
    _, lab = leaf_pairs(1, side, side, seed)[0]
    # leaves that later ones cover but for a sliver are background: DBSCAN
    # rightly calls a leaf of fewer than min_samples sampled pixels noise
    ids, counts = np.unique(lab, return_counts=True)
    lab[np.isin(lab, ids[(ids > 0) & (counts < CLUSTER_MIN_PIXELS)])] = 0
    rng = np.random.default_rng(seed + 1)
    centres = rng.uniform(-3, 3, (int(lab.max()) + 1, 16))
    emb = centres[lab] + CLUSTER_NOISE * rng.standard_normal((side, side, 16))
    return emb.astype(np.float32), lab


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """a and b split their pixels alike (a bijection between the labels)."""
    pairs = np.unique(np.stack([a.ravel(), b.ravel()]), axis=1)
    return len(np.unique(pairs[0])) == len(np.unique(pairs[1])) == pairs.shape[1]


def hostlib_cluster(dev="cuda", side=HOSTLIB_SIDE):
    """cluster_embeddings on ``dev`` over a side x side embedding of
    separable leaves, DBSCAN (its defaults) and MeanShift (bandwidth
    MEANSHIFT_BANDWIDTH): the clustered pixels' partition must equal the
    leaves'; seconds, and the share of the foreground the expansion labels
    as its leaf."""
    import torch

    from pixel_embedded_affinity_torch.postproc.cluster import (cluster_embeddings,
                                                                estimate_bandwidth)

    emb, lab = cluster_leaves(side, SEED + 52)
    fg = (lab > 0).astype(np.uint8)
    ys, xs = np.nonzero(fg)
    for method, kw in (("dbscan", {}), ("meanshift", {"bandwidth": MEANSHIFT_BANDWIDTH})):
        if dev.startswith("cuda"):
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        seeds = cluster_embeddings(emb, fg, method=method, expand=False, device=dev, **kw)
        sec = time.perf_counter() - t0
        at = (ys[::4], xs[::4])
        check((seeds[at] > 0).all() and _same_partition(seeds[at], lab[at]),
              f"{method}: the clusters are not the leaves")
        full = cluster_embeddings(emb, fg, method=method, device=dev, **kw)
        share = float(np.mean(
            [np.mean(full[lab == i] == np.bincount(full[lab == i]).argmax())
             for i in range(1, int(lab.max()) + 1) if (lab == i).any()]))
        print(f"[hostlib] cluster_embeddings {method} on {dev}: {len(at[0])} points of a "
              f"{side}x{side} embedding, {int(seeds.max())} clusters = the "
              f"{len(np.unique(lab)) - 1} leaves, {sec:.3f} s; after the watershed expansion {share:.4f} of each leaf's "
              f"pixels (mean) in its majority label")
    x = torch.from_numpy(emb[ys[::4], xs[::4]].astype(np.float64)).to(dev)
    t0 = time.perf_counter()
    bw = estimate_bandwidth(x)
    print(f"[hostlib] estimate_bandwidth (quantile 0.3) over {x.shape[0]} points: {bw:.6f} in "
          f"{time.perf_counter() - t0:.3f} s (it spans several leaves, so MeanShift ran at "
          f"{MEANSHIFT_BANDWIDTH})")


def hostlib_montage(montage: dict):
    """Phase 6's validation montage against the one built on the host from
    the same arrays: the trained state's eval step on the first validation
    image, its decode, val_show."""
    import cv2
    import torch

    from pixel_embedded_affinity_torch.ops import relabel
    from pixel_embedded_affinity_torch.ops.targets import gen_affs, weight_binary_ratio
    from pixel_embedded_affinity_torch.postproc import merge_func, seg_mutex
    from pixel_embedded_affinity_torch.train.loop import make_train_step
    from pixel_embedded_affinity_torch.train.train_step import make_eval_step_2d
    from pixel_embedded_affinity_torch.utils.show import val_show

    cfg, state, valid = montage["cfg"], montage["state"], montage["valid"]
    written = os.path.join(cfg.save_path, cfg.name, "valid", f"{TRAIN_STEPS:06d}.png")
    check(os.path.exists(written), f"no montage at {written}")
    step = make_train_step(cfg)
    s = valid[0]
    seg_t = torch.from_numpy(np.asarray(s["seg"], np.int64)[None]).cuda()
    affs, mask = gen_affs(seg_t, step.offsets)
    batch = {"image": torch.from_numpy(np.ascontiguousarray(s["image"][None])).cuda(),
             "affs": affs, "wmap": weight_binary_ratio(affs), "mask": mask}
    eval_step = make_eval_step_2d(step.offsets, criterion=step.criterion,
                                  use_pallas=cfg.train.use_pallas)
    with torch.no_grad():
        _, pred, _, _ = eval_step(state.model, batch)
    out_affs = pred[0].float().cpu().numpy()
    gt = np.asarray(s["seg"]).astype(np.uint16)
    seg = seg_mutex(out_affs, offsets=step.offsets, strides=list(cfg.data.strides),
                    mask=(gt > 0).astype(np.uint8)).astype(np.uint16)
    seg = relabel(merge_func(seg, variant="cvppp")).astype(np.uint16)
    host_dir = os.path.join(montage["run"], "host_montage")
    val_show(TRAIN_STEPS, out_affs[-1], affs[0, -1].float().cpu().numpy(), seg, gt, host_dir)
    a = cv2.imread(written, cv2.IMREAD_UNCHANGED)
    b = cv2.imread(os.path.join(host_dir, f"{TRAIN_STEPS:06d}.png"), cv2.IMREAD_UNCHANGED)
    check(a is not None and b is not None and a.shape == b.shape and np.array_equal(a, b),
          "phase 6's montage differs from the host's")
    print(f"[hostlib] phase 6's validation montage {os.path.relpath(written, REPO)} "
          f"{a.shape}: pixel-equal to val_show of the same arrays on the host")


def hostlib_flops(step2d_ms: float, step3d_ms: float):
    """utils/flops.py's counts beside measured device times: CVPPP serving
    at B=4 (the dense module's forward and K1f), the CVPPP and 3D training
    steps (phases 6 and 10; a step counted as 3 forwards of the student and
    one of the teacher), a 3D tile batch (4 x 18x160x160); TFLOP/s and the
    share of the float32 peak (TF32 off)."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.ops import fused_affinity_2d, multi_offset
    from pixel_embedded_affinity_torch.utils.flops import (emb2aff2d_flops, resunet2d_flops,
                                                           roofline_fields, unet3d_pni_flops)

    kind = torch.cuda.get_device_name(0)
    c2, c3 = load_config("cvppp"), load_config("ac3ac4")
    offsets = multi_offset(list(c2.data.shifts), c2.data.neighbor)
    rows = []
    with torch.no_grad(), float32_convs():
        torch.manual_seed(SEED)
        m2 = model_from_config(c2.model).cuda().eval()
        x = torch.randn(4, 3, 544, 544, device="cuda")

        def serve():
            emb = m2(x)[4]
            return fused_affinity_2d(emb.permute(0, 2, 3, 1), offsets)

        f2, b2, _ = resunet2d_flops(4, 544, 544, nfeatures=tuple(c2.model.filters),
                                    emd=c2.model.emd, act_bytes=4)
        fa, _ = emb2aff2d_flops(4, 544, 544, len(offsets), c2.model.emd)
        rows.append(("CVPPP serving B=4 544x544", f2 + fa, b2, timed_ms(serve, n=10)))
        m3 = model_from_config(c3.model).cuda().eval()
        t3 = torch.randn(4, 1, 18, 160, 160, device="cuda")
        f3, b3, _ = unet3d_pni_flops(4, 18, 160, 160, filters=tuple(c3.model.filters),
                                     emd=c3.model.emd, act_bytes=4)
        rows.append(("3D tile batch 4 x 18x160x160", f3, b3, timed_ms(lambda: m3(t3), n=10)))
    fs, bs, _ = resunet2d_flops(2, 544, 544, nfeatures=tuple(c2.model.filters),
                                emd=c2.model.emd, act_bytes=4)
    rows.append(("CVPPP training step B=2 544x544 (phase 6)", 4 * fs, 4 * bs, step2d_ms))
    fs3, bs3, _ = unet3d_pni_flops(2, 18, 160, 160, filters=tuple(c3.model.filters),
                                   emd=c3.model.emd, act_bytes=4)
    rows.append(("3D training step B=2 18x160x160 (phase 10)", 4 * fs3, 4 * bs3, step3d_ms))
    for label, flops, nbytes, ms in rows:
        r = roofline_fields(flops, nbytes, ms / 1e3, kind, "f32")
        print(f"[flops] {label}: {flops / 1e9:.3f} GFLOP (utils/flops.py), {ms:.4f} ms, "
              f"{flops / ms / 1e9:.3f} TFLOP/s, {r.get('mfu_pct', 'n/a')}% of the float32 "
              f"peak, HBM floor {r.get('hbm_bw_pct', 'n/a')}% of its rate; {card_line()}")


def first_difference(make_model, backward_of):
    """Where two forward and backward passes ``backward_of(model)`` over two
    models from ``make_model()`` (the same state) first part: the first
    module (in call order) whose forward output differs, else the first
    parameter, in the backward's order, whose gradient differs; None if
    they agree."""
    import torch

    runs = []
    for _ in range(2):
        model = make_model()
        outs = []
        hooks = [m.register_forward_hook(
            lambda mod, i, o, n=n: outs.append((n, o.detach().clone()))
            if torch.is_tensor(o) else None) for n, m in model.named_modules() if n]
        backward_of(model)
        for h in hooks:
            h.remove()
        grads = [(n, p.grad.detach().clone()) for n, p in model.named_parameters()
                 if p.grad is not None]
        runs.append((outs, grads))
    (oa, ga), (ob, gb) = runs
    for (n, a), (_, b) in zip(oa, ob):
        if not torch.equal(a, b):
            return f"the forward output of {n} (max diff {(a - b).abs().max().item():.3e})"
    for (n, a), (_, b) in zip(reversed(ga), reversed(gb)):
        if not torch.equal(a, b):
            return f"the gradient of {n} (max diff {(a - b).abs().max().item():.3e})"
    return None


def hostlib_determinism(run3d: dict):
    """Phase 10's training run again from the same seed and data: its
    logged losses and its final parameters and buffers bit for bit, or the
    first operation that differs."""
    import torch

    from pixel_embedded_affinity_torch.data.device_data import (sample_ac3ac4_batch,
                                                                sampler_generator)
    from pixel_embedded_affinity_torch.train import TrainStep3D, init_state, train

    cfg = copy.deepcopy(run3d["cfg"])
    out = os.path.join(REPO, "build", "chip_smoke_train3d_again")
    shutil.rmtree(out, ignore_errors=True)
    cfg.save_path = os.path.join(out, "models")
    state, _ = train(cfg, max_iters=TRAIN_STEPS, data_override=run3d["data"], device="cuda",
                     log_dir=os.path.join(out, "log"))
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
    sd = state.model.state_dict()
    differ = [k for k, v in run3d["state"].items() if not torch.equal(v, sd[k])]
    same = losses == run3d["losses"] and not differ
    print(f"[determinism] phase 10's 3D training ({TRAIN_STEPS} steps) again from seed "
          f"{cfg.train.random_seed}: losses {'bit-equal' if losses == run3d['losses'] else 'differ'}"
          f" ({losses} against {run3d['losses']}), {len(differ)} of {len(sd)} parameters and "
          f"buffers differ")
    if not same:
        raw, labels = (torch.from_numpy(a).cuda() for a in run3d["data"][0])
        batch = TrainStep3D(ema_seed=cfg.train.random_seed).ema_batch(
            sample_ac3ac4_batch(raw, labels, sampler_generator(cfg.train.random_seed, 0),
                                cfg.train.batch_size, crop_size=tuple(cfg.data.crop_size),
                                padding=cfg.data.padding_3d), 0)
        step = TrainStep3D(ema_seed=cfg.train.random_seed)

        def make_model():
            st = init_state(cfg, "cuda")
            st.model.load_state_dict(run3d["state"])
            return st.model

        where = first_difference(make_model, lambda m: step.grads(m, batch))
        print(f"[determinism] one step twice from phase 10's final state: first difference "
              f"at {where}")
    check(same, "the 3D training step is not bit-reproducible")


def phase_host_library(train2d: dict, train3d: dict, crop) -> dict:
    """23: the upsampling backward's kernel check, the ablation losses, the
    decoders, clustering, the montage, FLOP counts, the determinism check;
    returns the upsampling kernel's line fields."""
    up = phase_upsample_bwd()
    hostlib_losses()
    hostlib_decoders(*crop)
    hostlib_cluster()
    hostlib_montage(train2d["montage"])
    hostlib_flops(train2d["step_ms"], train3d["run"]["step_ms"])
    hostlib_determinism(train3d["run"])
    return up


# 24. data parallelism: two ranks on one card (gloo: NCCL refuses two
# ranks on one GPU), the single process on the same global batch beside
DP_WORLD = 2
DP_STEPS = 2
DP_PRESETS = {"cvppp": "cvppp", "3d": "ac3ac4", "bbbc": "bbbc039v1"}
DP_LOSS_RTOL = 1e-5
# the ranks' step-1 gradients against float64 (the plain path on the same
# batch and EMA view): at most DP_GRAD_EXCESS times the single process's
# float32 error, plus DP_GRAD_RTOL (each tensor, relative to its norm). The
# two float32 steps differ by summation order alone, and on the full-width
# 2D models that is up to 2.1e-3 of a tensor's norm, where the single
# process's own float32 gradient is 2.8e-3 off float64 (the card, PR 18)
DP_GRAD_RTOL = 1e-4
DP_GRAD_EXCESS = 2.0
DP_TOL = dict(rtol=3e-3, atol=2.5e-4)  # tests/test_dp_parity.py's
DP_CANVAS_ATOL = 1e-5  # JAX's own bound for run (tests/test_tiling.py)
DP_CROP = (20, 512, 512)
DP_CLI_STEPS = 4
DP_ZERO_BIAS = re.compile(BIAS_BEFORE_BN.pattern + "|" + BIAS_BEFORE_BN_3D.pattern)
DP_TIMEOUT_S = 600
DP_SPC = 4  # steps_per_call of the meshed graphed runs
# the NCCL capture probe: replays held against the eager all-reduce, each
# on new inputs; the BatchNorm vector [sum x, sum x^2, n] of the widest
# BatchNorm of the cvppp model (256 channels)
DP_PROBE_REPLAYS = 20
DP_PROBE_BN = 2 * 256 + 1
# NCCL issues no work for an in-place SUM over one rank, the step's op; a
# PREMUL_SUM by this factor runs NCCL's one-rank reduce kernel, so a replay
# that gives factor x the input ran the captured collective
DP_PROBE_FACTOR = 0.5
DP_PROBE_NCCL = re.compile(r"nccl|oneRankReduce", re.I)  # NCCL's kernels in a profile


def _dp_launchers():
    from pixel_embedded_affinity_torch.ops.upsample_cuda import upsample_bwd

    return {**_bbbc_launchers(), **_train3d_launchers(), "UPb": upsample_bwd}


def _dp_case(kind: str, arrays, steps: int = DP_STEPS):
    """(config, seeded state dict on the CPU, the first ``steps`` global
    batches of the preset's resident sampler on the card, moved to the
    CPU)."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.train.loop import resident_sampler

    cfg = load_config(DP_PRESETS[kind])
    torch.manual_seed(cfg.train.random_seed)
    sd = model_from_config(cfg.model).state_dict()
    draw = resident_sampler(cfg, arrays, "cuda")
    return cfg, sd, [{k: v.cpu() for k, v in draw(s).items()} for s in range(steps)]


def _dp_record(rec: dict, run, model):
    """run() (a step), timed on the host clock around a synchronize; its
    metrics, the model's gradients and state after it appended to ``rec``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = run()
    torch.cuda.synchronize()
    rec["ms"].append(1e3 * (time.perf_counter() - t0))
    rec["metrics"].append({k: float(v) for k, v in metrics.items()})
    rec["grads"].append({n: p.grad.detach().to("cpu", copy=True)
                         for n, p in model.named_parameters() if p.grad is not None})
    rec["states"].append({k: v.detach().to("cpu", copy=True)
                          for k, v in model.state_dict().items()})


def dp_steps(kind: str, case: dict, mesh=None, reference: bool = False) -> dict:
    """The preset's train step (the EMA view and targets drawn on the card
    from the global batch) over the case's batches, data-parallel on
    ``mesh``: each step's metrics, gradients, state and host ms, and each
    kernel's launches in those steps. With ``reference``, before each step
    the single-process step on the whole batch from a copy of the same
    state (its model and optimizer), under "ref"."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.models.common import bind_mesh
    from pixel_embedded_affinity_torch.train import TrainState, make_optimizer
    from pixel_embedded_affinity_torch.train.loop import make_train_step

    cfg = load_config(DP_PRESETS[kind])
    model = model_from_config(cfg.model)
    model.load_state_dict(case["state_dict"])
    model = model.cuda().train()
    state = TrainState(model, make_optimizer(model.parameters(), cfg.train), 0)
    step, single = make_train_step(cfg, mesh), make_train_step(cfg)
    launchers = _dp_launchers()
    launches = dict.fromkeys(launchers, 0)
    out = {"metrics": [], "grads": [], "states": [], "ms": []}
    ref = {"metrics": [], "grads": [], "states": [], "ms": []}
    for b in case["batches"]:
        batch = {k: v.cuda() for k, v in b.items()}
        if reference:
            copied = copy.deepcopy(state)
            bind_mesh(copied.model, None)
            _dp_record(ref, lambda: single(copied, batch), copied.model)
        before = {k: fn.launches for k, fn in launchers.items()}
        _dp_record(out, lambda: step(state, batch), model)
        for k, fn in launchers.items():
            launches[k] += fn.launches - before[k]
    out["launches"] = launches
    if reference:
        out["ref"] = ref
    return out


def dp_profile_replays(runner, next_batch, label: str):
    """SPC_TIMED + SPC_PROFILED more calls of a graphed ``runner`` on
    ``next_batch()``, timed and profiled by :func:`_spc_profile`, which
    holds each kernel's launches that the profiler saw against the
    wrappers' counts plus ``runner.per_replay`` a replay. Returns (the
    wrappers' counts in these calls, the replays' launches that the
    profiler saw, both by wrapper; ms a call by CUDA events)."""
    from pixel_embedded_affinity_torch.ops.launch_count import launch_counts

    before = launch_counts()
    ev_ms, _, _, seen = _spc_profile(lambda: runner(next_batch()), label, runner.per_replay)
    counted = {k: n - before.get(k, 0) for k, n in launch_counts().items()
               if n != before.get(k, 0)}
    want = {w: n * SPC_PROFILED for w, n in runner.per_replay.items()}
    check(seen == want, f"{label}: the profiler saw the replays launch {seen}, "
                        f"{SPC_PROFILED} x a replay's {want}")
    return counted, seen, ev_ms


def dp_graphed(kind: str, case: dict, mesh) -> dict:
    """The preset's meshed step over the case's batches as one call of
    ``train.steps_per_call``: the first step eager, the second captured
    (collectives included) and replayed, the rest replayed; each step's
    metrics and state; then :func:`dp_profile_replays` on the last batch:
    the kernels the wrappers counted, and those the profiler saw the
    replays launch."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.train import GraphedStep, TrainState, make_optimizer
    from pixel_embedded_affinity_torch.train.loop import make_train_step

    cfg = load_config(DP_PRESETS[kind])
    model = model_from_config(cfg.model)
    model.load_state_dict(case["state_dict"])
    model = model.cuda().train()
    state = TrainState(model, make_optimizer(model.parameters(), cfg.train), 0)
    runner = GraphedStep(make_train_step(cfg, mesh), state, graph=True)
    launchers = _dp_launchers()
    before = {k: fn.launches for k, fn in launchers.items()}
    out = {"metrics": [], "states": []}
    for b in case["batches"]:
        _, metrics = runner({k: v.cuda() for k, v in b.items()})
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["states"].append({k: v.detach().to("cpu", copy=True)
                              for k, v in model.state_dict().items()})
    batch = {k: v.cuda() for k, v in case["batches"][-1].items()}
    _, seen, ev_ms = dp_profile_replays(runner, lambda: batch,
                                        f"{kind} NCCL rank {mesh.rank} meshed graph replay")
    torch.cuda.synchronize()
    out.update(per_replay=runner.per_replay, replays=runner.replays, seen=seen, ms=ev_ms,
               capture_s=runner.capture_s,
               launches={k: fn.launches - before[k] for k, fn in launchers.items()})
    return out


def nccl_capture_probe(mesh, n_grad: int) -> dict:
    """Whether this card's PyTorch and NCCL hold the data-parallel step's
    collectives in a CUDA graph: ``dist.all_reduce`` of a flat buffer of
    ``n_grad`` values (the flat gradient's size) and of a BatchNorm's [sum
    x, sum x^2, n] vector (DP_PROBE_BN values), each in float32 and
    float64, by SUM (the step's op) and then by PREMUL_SUM(DP_PROBE_FACTOR),
    captured once on ``mesh``'s NCCL group after an eager warm-up on a side
    stream, as the training step's graph is; then DP_PROBE_REPLAYS replays,
    each on new inputs copied into the graph's static sources, held bit for
    bit against the eager all-reduces of the same inputs, each output
    DP_PROBE_FACTOR x its input: only the captured PREMUL_SUM, run by the
    replay, can scale the copy. Over one rank NCCL issues no work for an
    in-place SUM, so that half shows only that its capture does not
    raise. A profile of one replay is printed, with the NCCL kernels in it
    (over one rank the PREMUL_SUMs' only); it is a record, not
    the hold, since the profiler has missed them where the replay's
    outputs show they ran. Returns the capture seconds, one replay's ms by
    CUDA events, whether every replay equalled the eager call and scaled
    its input, and the NCCL kernels the profile showed."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    srcs = [torch.zeros(n, dtype=dt, device=dev) for n in (n_grad, DP_PROBE_BN)
            for dt in (torch.float32, torch.float64)]
    bufs = [torch.empty_like(t) for t in srcs]
    premul = dist._make_nccl_premul_sum(DP_PROBE_FACTOR)

    def reduce(t):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(t, op=premul, group=mesh.group)

    def body():
        for src, buf in zip(srcs, bufs):
            buf.copy_(src)
            reduce(buf)

    def eager():
        outs = [src.clone() for src in srcs]
        for t in outs:
            reduce(t)
        return outs

    def refill():
        for src in srcs:
            src.copy_(torch.randn(src.shape, generator=gen, device=dev, dtype=src.dtype))

    refill()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        body()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    equal = True
    for _ in range(DP_PROBE_REPLAYS):
        refill()
        graph.replay()
        ref = eager()
        equal = equal and all(torch.equal(b, r) for b, r in zip(bufs, ref))
    moved = not any(torch.equal(b, s) for b, s in zip(bufs, srcs))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    seen = [e.name for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    nccl_kernels = [n for n in seen if DP_PROBE_NCCL.search(n)]
    want = len(bufs) * (1 if mesh.size == 1 else 2)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(DP_PROBE_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / DP_PROBE_REPLAYS
    nccl = torch.cuda.nccl.version()
    nccl = ".".join(map(str, nccl)) if isinstance(nccl, tuple) else str(nccl)
    kinds = sorted({n.split("(")[0][-48:] for n in seen})
    print(f"[dp-probe] NCCL {nccl} (world size {mesh.size}, torch {torch.__version__}): "
          f"dist.all_reduce by SUM then PREMUL_SUM({DP_PROBE_FACTOR}) of {n_grad} and "
          f"{DP_PROBE_BN} values in float32 and float64 captured in one CUDA graph in "
          f"{capture_s:.4f} s; {DP_PROBE_REPLAYS} replays on new inputs equal to the eager "
          f"all-reduces bit for bit: {equal}, each output {DP_PROBE_FACTOR} x its input "
          + ("and not the input: the captured collectives ran in each replay" if moved
             else "but one equal to its input: a collective did not run")
          + (" (over one rank NCCL issues no work for the in-place SUMs, the step's op, so "
             "their half shows only that capture does not raise)" if mesh.size == 1 else "")
          + f"; the profiler saw in one replay {len(seen)} device events {kinds}, "
          f"{len(nccl_kernels)} of them NCCL kernels ({want} ran); one replay "
          f"{replay_ms:.4f} ms by CUDA events; {card_line()}")
    return {"capture_s": capture_s, "replay_ms": replay_ms, "equal": equal and moved,
            "nccl_kernels": len(nccl_kernels)}


def dp_f64_grads(kind: str, case: dict) -> dict:
    """Step 1's gradients in float64 through the plain path, on the first
    batch with the EMA view the float32 step draws for it."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.train.loop import make_train_step

    cfg = load_config(DP_PRESETS[kind])
    batch = make_train_step(cfg).ema_batch({k: v.cuda() for k, v in case["batches"][0].items()},
                                           0)
    batch = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    cfg.train.use_pallas, cfg.data.device_ema = False, False
    model = model_from_config(cfg.model)
    model.load_state_dict(case["state_dict"])
    model = model.double().cuda()
    make_train_step(cfg).grads(model, batch)
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None}


def dp_tiles(case: dict, mesh=None):
    """The dense 3D module served tiled (``run``) over the crop, split over
    ``mesh``: (canvas, K5f launches, the tile batch sizes predicted, host
    s)."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.infer.inference3d import build_tiled_predictor
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.ops import fused_affinity_3d
    from pixel_embedded_affinity_torch.parallel import TiledInference3D

    cfg = load_config("ac3ac4")
    model = model_from_config(cfg.model)
    model.load_state_dict(case["state_dict"])
    predictor = build_tiled_predictor(model.cuda().eval())
    sizes = []

    def predict(tiles):
        sizes.append(tiles.shape[0])
        return predictor(tiles)

    engine = TiledInference3D(crop_size=cfg.data.crop_size, batch_size=4, mesh=mesh)
    fused_affinity_3d.launches = 0
    t0 = time.perf_counter()
    canvas = engine.run(case["volume"], predict, 12, device="cuda")
    return canvas, fused_affinity_3d.launches, sizes, time.perf_counter() - t0


def _dp_rank(rank: int, world: int, folder: str, backend: str):
    """One rank of phase 24: joins the group (gloo: every rank on cuda:0;
    NCCL: rank r on cuda:r) and writes its readings to rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from pixel_embedded_affinity_torch.parallel.multihost import initialize

    dev = "cuda:0" if backend == "gloo" else f"cuda:{rank}"
    mesh = initialize(dev, backend=backend, init_method=f"file://{folder}/pg_init",
                      rank=rank, world_size=world)
    try:
        cases = torch.load(os.path.join(folder, "cases.pt"), weights_only=False)
        out = {k: dp_steps(k, c, mesh, reference=rank == 0)
               for k, c in cases.items() if k in DP_PRESETS}
        if "cvppp_spc" in cases:  # the same batches, eager and as one graphed call
            case = cases["cvppp_spc"]
            out["cvppp_spc"] = {"eager": dp_steps("cvppp", case, mesh),
                                "graphed": dp_graphed("cvppp", case, mesh)}
        if "tiles" in cases:
            out["tiles"] = dp_tiles(cases["tiles"], mesh)
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_spawn(folder: str, cases: dict, backend: str):
    """Start DP_WORLD ranks of ``cases``; returns a join function that
    gives each rank's readings."""
    import torch
    import torch.multiprocessing as mp

    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    torch.save(cases, os.path.join(folder, "cases.pt"))
    ctx = mp.start_processes(_dp_rank, args=(DP_WORLD, folder, backend), nprocs=DP_WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT_S

    def join():
        try:
            while not ctx.join(timeout=1.0):
                check(time.monotonic() < deadline, f"the {backend} ranks ran over "
                      f"{DP_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_WORLD)]

    return join


def _dp_grad_errors(got: dict, ref: dict, per_tensor: bool = False):
    """(worst tensor: |grad - ref| / |ref|, its name; the conv biases in
    front of BatchNorm, whose true gradient is 0: largest |grad - ref| over
    the largest |ref| of the model; the whole gradient's |grad - ref| /
    |ref|), or with ``per_tensor`` each tensor's error, the biases in front
    of BatchNorm against the largest |ref|."""
    import torch

    top = max(float(g.norm()) for g in ref.values())
    errs = {n: float((got[n].double() - g.double()).norm())
            / (top if DP_ZERO_BIAS.search(n) else max(float(g.norm()), 1e-30))
            for n, g in ref.items()}
    if per_tensor:
        return errs
    worst, name, zero = 0.0, None, 0.0
    for n, e in errs.items():
        if DP_ZERO_BIAS.search(n):
            zero = max(zero, e)
        elif e > worst:
            worst, name = e, n
    flat = torch.cat([(got[n].double() - g.double()).reshape(-1) for n, g in ref.items()])
    whole = float(flat.norm()) / float(torch.cat([g.double().reshape(-1)
                                                 for g in ref.values()]).norm())
    return worst, name, zero, whole


def dp_compare(kind: str, ranks: list, f64: dict, misses: list, label: str):
    """Phase 24's holds of one step kind: each step of the ranks against the
    single process's step from the same state (rank 0's "ref"), step 1's
    gradients against float64 (``f64``), and the ranks against each
    other."""
    import torch

    r0 = ranks[0]
    one = r0["ref"]
    dp64, one64 = (_dp_grad_errors(g, f64, per_tensor=True) for g in (r0["grads"][0],
                                                                    one["grads"][0]))
    over = {n: (e, one64[n]) for n, e in dp64.items()
            if e > DP_GRAD_EXCESS * one64[n] + DP_GRAD_RTOL}
    print(f"[dp] {label} step 1 gradients against float64 (plain path), each tensor relative "
          f"to its norm: ranks worst {max(dp64.values()):.3e}, single process worst "
          f"{max(one64.values()):.3e}; tensors past {DP_GRAD_EXCESS} x the single process's + "
          f"{DP_GRAD_RTOL}: {over or 'none'}")
    if over:
        misses.append(f"{label} step 1 gradients against float64: {over}")
    for s in range(DP_STEPS):
        for k, v in one["metrics"][s].items():
            rel = abs(r0["metrics"][s][k] - v) / max(abs(v), 1e-30)
            if k == "loss":
                print(f"[dp] {label} step {s + 1}: loss {r0['metrics'][s][k]!r} on the ranks, "
                      f"{v!r} in one process ({rel:.3e} relative, bound {DP_LOSS_RTOL})")
            if rel > DP_LOSS_RTOL:
                misses.append(f"{label} step {s + 1} {k} {rel:.3e} off the single process")
        worst, name, zero, whole = _dp_grad_errors(r0["grads"][s], one["grads"][s])
        print(f"[dp] {label} step {s + 1}: all-reduced gradients against the single process's: "
              f"worst tensor {name} {worst:.3e} of its norm, the whole gradient {whole:.3e}, "
              f"the biases in front of BatchNorm {zero:.3e} of the largest norm")
        for r in range(1, DP_WORLD):
            same = all(torch.equal(r0["states"][s][k], ranks[r]["states"][s][k])
                       for k in r0["states"][s])
            if not same:
                misses.append(f"{label} step {s + 1}: rank {r}'s parameters or buffers differ")
        floats = [k for k, v in one["states"][s].items() if v.is_floating_point()]
        worst_p = max(float(((r0["states"][s][k].double() - one["states"][s][k].double()).abs()
                             - DP_TOL["atol"] - DP_TOL["rtol"] * one["states"][s][k].double()
                             .abs()).max()) for k in floats)
        moved = max(float((r0["states"][s][k].double() - one["states"][s][k].double())
                          .abs().max()) for k in floats)
        print(f"[dp] {label} step {s + 1}: parameters and BatchNorm statistics at most "
              f"{moved:.3e} off the single process's (TOL {DP_TOL})")
        if worst_p > 0:
            misses.append(f"{label} step {s + 1}: a parameter or statistic past TOL by {worst_p}")
    print(f"[dp] {label}: each step against the single process's from the same state; "
          f"parameters and BatchNorm buffers bit-equal across the "
          f"{DP_WORLD} ranks after each step; host ms a step, ranks "
          f"{[[round(m, 2) for m in r['ms']] for r in ranks]} (sharing one card: a record, "
          f"not a speed), one process {[round(m, 2) for m in one['ms']]}; launches per rank "
          f"{[{k: n for k, n in r['launches'].items() if n} for r in ranks]}; {card_line()}")


def dp_cli(arrays, valid, out: str) -> dict:
    """The training CLI with ``--distributed`` under torchrun's environment
    for one process (NCCL at world size 1) and the same run without it, at
    steps_per_call 1 and DP_SPC. The first run makes its process group and
    ends it; for the others this function joins one NCCL group first
    (``multihost.initialize``, which the CLI then joins), runs the capture
    probe on it, profiles more replays of the S=DP_SPC run's meshed graph
    (:func:`dp_profile_replays`), and ends it after. Returns the
    distributed runs' launches (those the wrappers counted, and those the
    profiler saw the meshed graph's replays make, by kernel label), the
    latter apart, whether every run's losses and parameters are bit-equal,
    the files of the first run and the probe's readings."""
    import socket

    import torch
    import torch.distributed as dist

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.models import model_from_config
    from pixel_embedded_affinity_torch.parallel.multihost import initialize
    from pixel_embedded_affinity_torch.train import loop as train_loop
    from pixel_embedded_affinity_torch.train.__main__ import main
    from pixel_embedded_affinity_torch.train.loop import resident_sampler

    def run(name, distributed, spc=1):
        argv = ["-c", "ac3ac4", "-i", str(DP_CLI_STEPS), "-o",
                f"save_path={os.path.join(out, name)}", "train.display_freq=1",
                "train.if_valid=False", "train.save_freq=1000000",
                f"train.steps_per_call={spc}"]
        state, _ = main(argv + (["--distributed"] if distributed else []),
                        data_override=(arrays, valid))
        with open(os.path.join(out, name, "ac3ac4", "log", "scalars.jsonl")) as f:
            losses = [json.loads(ln)["loss"] for ln in f if '"loss"' in ln]
        return losses, {k: v.detach().cpu() for k, v in state.model.state_dict().items()}

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])

    def per_call(losses):  # the displays of a run at DP_SPC steps a call
        out = []
        for i in range(0, len(losses), DP_SPC):
            total = 0.0
            for v in losses[i:i + DP_SPC]:
                total += v
            out.append(total / len(losses[i:i + DP_SPC]))
        return out

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    launchers = _dp_launchers()
    for fn in launchers.values():
        fn.launches = 0
    runners = []
    graphed_step = train_loop.GraphedStep

    class Recorded(graphed_step):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runners.append(self)

    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        dist1 = run("distributed", True)
        secs = time.perf_counter() - t0
        check(not dist.is_initialized(), "the CLI left its process group open")
        with socket.socket() as sock:  # a new store for the new group
            sock.bind(("localhost", 0))
            os.environ["MASTER_PORT"] = str(sock.getsockname()[1])
        mesh = initialize("cuda")
        check(dist.get_backend(mesh.group) == "nccl" and mesh.size == 1,
              f"a world-size-1 group on {dist.get_backend(mesh.group)}, size {mesh.size}")
        try:
            n_grad = sum(p.numel() for p in model_from_config(load_config("cvppp").model)
                         .parameters())
            probe = nccl_capture_probe(mesh, n_grad)
            train_loop.GraphedStep = Recorded
            t0 = time.perf_counter()
            dist4 = run("distributed_spc", True, DP_SPC)
            secs4 = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in launchers.items()}
            check(len(runners) == 1 and runners[0].step.mesh is not None
                  and runners[0].cuda_graph is not None,
                  f"the --distributed run at steps_per_call={DP_SPC} graphed no meshed step")
            runner = runners[0]
            cli_replays = runner.replays
            draw = resident_sampler(load_config("ac3ac4"), arrays, mesh.device)
            counted, seen, replay_ms = dp_profile_replays(
                runner, lambda: draw(runner.state.step),
                f"--distributed S={DP_SPC} meshed graph replay")
        finally:
            train_loop.GraphedStep = graphed_step
            dist.destroy_process_group()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    plain1 = run("plain", False)
    plain4 = run("plain_spc", False, DP_SPC)
    ckpts = sorted(os.listdir(os.path.join(out, "distributed", "ac3ac4")))
    graph = {k: seen.get(fn.__name__, 0) for k, fn in launchers.items()}
    checks = {"--distributed = without, S=1": same(dist1, plain1),
              f"--distributed S={DP_SPC} = without, S={DP_SPC}": same(dist4, plain4),
              f"--distributed S={DP_SPC} = --distributed S=1": same(dist4, (per_call(dist1[0]),
                                                                            dist1[1]))}
    print(f"[dp] the CLI with --distributed, NCCL at world size 1 (torchrun's environment, "
          f"MASTER_PORT {port}), ac3ac4 {DP_CLI_STEPS} steps from the device sampler in "
          f"{secs:.2f} s: losses {dist1[0]}; without --distributed {plain1[0]}; the run's "
          f"files {ckpts}; launches the wrappers counted in this and the next --distributed "
          f"run {json.dumps({k: n for k, n in launches.items() if n})}")
    print(f"[dp] the same at train.steps_per_call={DP_SPC} ({secs4:.2f} s): one meshed step "
          f"graphed (mesh size {runner.step.mesh.size}, NCCL; capture {runner.capture_s:.3f} "
          f"s, {cli_replays} replays), losses {dist4[0]}; without --distributed "
          f"{plain4[0]}; bit-equal (losses and parameters): {json.dumps(checks)}; kernels a "
          f"replay {json.dumps(runner.per_replay)} (at capture); then {SPC_TIMED + SPC_PROFILED} "
          f"more replays, {replay_ms:.4f} ms a step by CUDA events, in {SPC_PROFILED} of them "
          f"the profiler saw the meshed graph launch "
          f"{json.dumps({k: n for k, n in graph.items() if n})}; {card_line()}")
    for k, fn in launchers.items():
        launches[k] += counted.get(fn.__name__, 0) + graph[k]
    return {"launches": launches, "same": all(checks.values()), "ckpts": ckpts,
            "probe": probe, "graph": graph, "replay_ms": replay_ms}


def dp_spc_compare(ranks: list, launches: dict, misses: list):
    """Two NCCL ranks' CVPPP step at steps_per_call=DP_SPC (one graphed
    call) against their eager meshed steps on the same batches: the losses
    within SPC_STEP_RTOL (the one-process 2D float32 step is bit-reproducible
    since ROADMAP §3 item 18 closed, the two-card NCCL step has not been run
    yet) and bit-equality printed; the ranks bit-equal; the launches that the
    wrappers counted and that the profiler saw the replays make added to
    ``launches``."""
    import torch

    for r, run in enumerate(ranks):
        eager, graphed = run["eager"], run["graphed"]
        le = [m["loss"] for m in eager["metrics"]]
        lg = [m["loss"] for m in graphed["metrics"]]
        exact = le == lg and all(torch.equal(eager["states"][-1][k], v)
                                 for k, v in graphed["states"][-1].items())
        loss_d = _spc_loss_d(le, lg)
        print(f"[dp] cvppp NCCL rank {r}, {DP_SPC} steps: eager {le}, one graphed call {lg} "
              f"(capture {graphed['capture_s']:.3f} s, {graphed['replays']} replays; then "
              f"{graphed['ms']:.4f} ms a replay by CUDA events); "
              f"bit-equal {exact}; losses rel {loss_d:.3e}")
        if loss_d > SPC_STEP_RTOL:
            misses.append(f"cvppp NCCL rank {r}: the graphed call off the eager steps "
                          f"({loss_d:.3e}, bit-equal {exact})")
    if not all(torch.equal(ranks[0]["graphed"]["states"][-1][k], v)
               for k, v in ranks[1]["graphed"]["states"][-1].items()):
        misses.append("cvppp NCCL: the ranks' graphed runs differ")
    names = {fn.__name__: k for k, fn in _dp_launchers().items()}
    for run in ranks:
        g = run["graphed"]
        for k, n in g["launches"].items():
            launches[k] += n
        for w, n in g["seen"].items():
            if w in names:
                launches[names[w]] += n


def phase_data_parallel(crop, bbbc_arrays) -> dict:
    """24: the CVPPP, 3D and BBBC train steps on two gloo ranks sharing
    cuda:0 against the single process, the tiled engine split over them,
    the CLI's --distributed on NCCL at world size 1 (and the CVPPP step on
    NCCL over two cards where there are two). ``crop``: the DP_CROP corner
    of phase 9's volume in [0, 1]. Returns each kernel's launches in the
    phase's data-parallel runs."""
    import torch

    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays

    out = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    (arrays3d, valid3d), _ = train3d_data()
    data = {"cvppp": pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED)), "3d": arrays3d,
            "bbbc": bbbc_arrays}
    cases, cfgs = {}, {}
    for kind in DP_PRESETS:
        cfgs[kind], sd, batches = _dp_case(kind, data[kind])
        cases[kind] = {"state_dict": sd, "batches": batches}
    cases["tiles"] = {"state_dict": cases["3d"]["state_dict"], "volume": crop}
    print(f"[dp] {DP_WORLD} gloo ranks on cuda:0, float32 (TF32 off), {DP_STEPS} steps each "
          f"from the same seeded weights and global batches: "
          + "; ".join(f"{DP_PRESETS[k]} B={cfgs[k].train.batch_size} "
                      f"{tuple(cases[k]['batches'][0]['image'].shape[1:])} filters "
                      f"{cfgs[k].model.filters}" for k in DP_PRESETS)
          + f"; the dense 3D module served tiled over a {crop.shape} crop of phase 9's volume; "
          f"set up in {time.perf_counter() - t0:.2f} s")
    join = _dp_spawn(os.path.join(out, "gloo"), cases, "gloo")
    # float64 and the single process's canvas, on the card beside the ranks' start-up
    f64 = {k: dp_f64_grads(k, cases[k]) for k in DP_PRESETS}
    one_canvas, one_k5, one_sizes, one_s = dp_tiles(cases["tiles"])
    t1 = time.perf_counter()
    ranks = join()
    print(f"[dp] the ranks done {time.perf_counter() - t1:.2f} s after the single process")
    misses: list = []
    for kind in DP_PRESETS:
        dp_compare(kind, [r[kind] for r in ranks], f64[kind], misses, DP_PRESETS[kind])
    (c0, k0, n0, s0), (c1, k1, n1, s1) = ranks[0]["tiles"], ranks[1]["tiles"]
    delta = float(np.abs(c0 - one_canvas).max())
    print(f"[dp] tiled {crop.shape}: canvas max |delta| against the single process {delta:.3e} "
          f"(bound {DP_CANVAS_ATOL}), ranks' canvases equal: {np.array_equal(c0, c1)}; K5f "
          f"launches {k0} + {k1} on the ranks, {one_k5} in one process; host s {s0:.2f}, "
          f"{s1:.2f} on the ranks, {one_s:.2f} in one process")
    # each tile predicted once, by one rank, K5f launched once a part
    once = sum(n0) + sum(n1) == sum(one_sizes) and (k0, k1, one_k5) == (len(n0), len(n1),
                                                                        len(one_sizes))
    print(f"[dp] tiled: {sum(one_sizes)} tiles in {len(one_sizes)} batches of up to 4; the "
          f"ranks' parts {n0} and {n1}")
    if delta > DP_CANVAS_ATOL or not np.array_equal(c0, c1) or not once:
        misses.append(f"tiled canvas {delta:.3e}, ranks equal {np.array_equal(c0, c1)}, "
                      f"each tile once with one K5f launch a part: {once}")
    launches = {k: sum(r[kind]["launches"][k] for r in ranks for kind in DP_PRESETS)
                for k in _dp_launchers()}
    launches["K5f"] += k0 + k1
    for kind in DP_PRESETS:
        if not all(r[kind]["launches"]["UPb"] for r in ranks):
            misses.append(f"{kind}: a rank ran no upsampling backward")
    need = {"cvppp": ("K2f", "K2b", "K3f", "K3b"), "3d": ("K5f", "K5b", "K6f", "K6b"),
            "bbbc": ("K3f", "K3b")}
    for kind, names in need.items():
        for k in names:
            if not all(r[kind]["launches"][k] for r in ranks):
                misses.append(f"{kind}: a rank never launched {k}")
    # the CLI, NCCL at world size 1, at steps_per_call 1 and DP_SPC; the
    # capture probe
    cli = dp_cli(arrays3d, valid3d, os.path.join(out, "cli"))
    if not cli["same"] or cli["ckpts"] != ["log", f"model-{DP_CLI_STEPS:06d}.ckpt"]:
        misses.append(f"CLI --distributed: bit-equal {cli['same']}, files {cli['ckpts']}")
    if not cli["probe"]["equal"]:
        misses.append("NCCL capture probe: a replay differs from the eager all-reduce")
    for k in ("K5f", "K5b", "K6f", "K6b", "UPb"):
        if not cli["graph"][k]:
            misses.append(f"the meshed graph launched no {k}")
    for k, n in cli["launches"].items():
        launches[k] += n
    ran = ["gloo x2 on cuda:0 (CVPPP, 3D, BBBC steps; tiled serving)",
           "NCCL x1 (the CLI, ac3ac4)"]
    ran.append(f"NCCL x1 (the CLI at steps_per_call={DP_SPC}, one meshed graph; the capture "
               f"probe)")
    if torch.cuda.device_count() >= 2:
        spc_case = dict(zip(("state_dict", "batches"),
                            _dp_case("cvppp", data["cvppp"], DP_SPC)[1:]))
        nccl = _dp_spawn(os.path.join(out, "nccl"), {"cvppp": cases["cvppp"],
                                                     "cvppp_spc": spc_case}, "nccl")()
        dp_compare("cvppp", [r["cvppp"] for r in nccl], f64["cvppp"], misses, "cvppp NCCL")
        for k in launches:
            launches[k] += sum(r["cvppp"]["launches"][k] + r["cvppp_spc"]["eager"]["launches"][k]
                               for r in nccl)
        dp_spc_compare([r["cvppp_spc"] for r in nccl], launches, misses)
        ran.append("NCCL x2 on cuda:0, cuda:1 (CVPPP step, eager and as one graphed call)")
    print(f"[dp] ran: {'; '.join(ran)}; not run: "
          f"{'none' if len(ran) == 4 else 'NCCL over two cards (one card here)'}; launches "
          f"{json.dumps({k: n for k, n in launches.items() if n})}")
    check(not misses, "data parallelism: " + "; ".join(misses))
    return launches


# ---- 25. int8 serving, serving artifacts, DCP checkpoints

I8C_SOURCE = "pixel_embedded_affinity_torch/csrc/conv_i8.cu"
I8C_REPLACES = ("none: no TPU site; the JAX package's int8 conv is an XLA conv "
                "(pixel_embedded_affinity_tpu/ops/quant.py:51 conv_i8)")
I8Q_REPLACES = ("none: no TPU site; the JAX package's activation quantizer is a jnp "
                "expression (pixel_embedded_affinity_tpu/ops/quant.py:45 quantize_act)")
INT8_OPS_PER_S = H100_PEAKS["int8"]
# tests/test_int8_quant.py's bars of the int8 forward against float32
INT8_COS_MIN, INT8_AFF_MAX, INT8_AFF_MEAN = 0.99, 0.05, 0.005
# the percentile of serving's calibration check (model.int8_calib_pct), and
# the hold of each site's statistic against a float64 sort: both pick the
# same order statistics, so only the float32 interpolation may differ
INT8_CALIB_PCT = 0.999
QUANTILE_RTOL = 1e-6
EXPORT_ATOL = 1e-5


class _Recorder:
    """Wraps fast_forward's conv_i8 and quantize_act: each call's arguments
    and output, in order, while the wrappers still launch the kernels."""

    def __init__(self):
        from pixel_embedded_affinity_torch.models import fast_forward

        self.ff, self.convs, self.quants = fast_forward, [], []
        self.real = (fast_forward.conv_i8, fast_forward.quantize_act)

    def __enter__(self):
        conv, quant = self.real

        def conv_rec(x_q, w, out_scale, shift=None, padding=(1, 1, 1, 1)):
            out = conv(x_q, w, out_scale, shift, padding=padding)
            self.convs.append((x_q, w, out_scale, shift, tuple(padding), out))
            return out

        def quant_rec(x, scale):
            out = quant(x, scale)
            self.quants.append((x, scale, out))
            return out

        self.ff.conv_i8, self.ff.quantize_act = conv_rec, quant_rec
        return self

    def __exit__(self, *exc):
        self.ff.conv_i8, self.ff.quantize_act = self.real


def i8c_bound(x_q, w, padding) -> tuple:
    """The two least times of one I8c call (its bound is the larger): x read
    once, the int8 weights once, the float32 output written once (and the
    scale/shift), and 2 operations a multiply-add at the int8 tensor cores'
    rate."""
    b, h, wd, cin = x_q.shape
    pt, pb, pl, pr = padding
    n_out = b * (h + pt + pb - w.kh + 1) * (wd + pl + pr - w.kw + 1)
    nbytes = x_q.numel() + w.packed.numel() + n_out * w.cout * 4 + 8 * w.cout
    ops = 2 * n_out * w.cout * w.packed.shape[1]
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3


def _i8_library(x_q, w, padding):
    """The yardsticks of one I8c call, none of which the port calls: cuDNN's
    F.conv2d of the same shape in bfloat16 and in float32 (TF32 off), and
    torch._int_mm on its im2col matrix (built outside the timed call)."""
    import torch
    import torch.nn.functional as F

    from pixel_embedded_affinity_torch.device import float32_convs

    pt, pb, pl, pr = padding
    w4 = w.packed.reshape(w.cout, w.kh, w.kw, w.cin).permute(0, 3, 1, 2)
    xc = F.pad(x_q.permute(0, 3, 1, 2).float(), (pl, pr, pt, pb))
    x16, w16 = xc.bfloat16().contiguous(memory_format=torch.channels_last), w4.bfloat16()
    x32, w32 = xc.contiguous(memory_format=torch.channels_last), w4.float()
    cols = F.unfold(xc, (w.kh, w.kw)).transpose(1, 2).reshape(-1, w.cin * w.kh * w.kw)
    a = cols.to(torch.int8).contiguous()
    bmat = w4.reshape(w.cout, -1).t().contiguous()

    def f32():
        with float32_convs():
            return F.conv2d(x32, w32)

    return {"cudnn_bf16": lambda: F.conv2d(x16, w16), "cudnn_f32": f32,
            "int_mm_im2col": lambda: torch._int_mm(a, bmat)}


def _graph_ms_or_none(fn, flush: int):
    """graph_ms, or None (printed) where the call is refused on this card."""
    try:
        return graph_ms(fn, flush_bytes=flush)
    except RuntimeError as e:
        print(f"[int8] yardstick refused: {str(e).splitlines()[0][:200]}")
        return None


def _quantize_library(x, scale: float):
    """torch.quantize_per_tensor(x, scale, 0, qint8): I8q's yardstick (it
    divides by the scale and clamps at -128; the port never calls it)."""
    import torch

    return lambda: torch.quantize_per_tensor(x, scale, 0, torch.qint8)


def i8c_sass() -> dict:
    """I8c's wgmma (IGMMA) and TMA load (UTMALDG) instructions in the SASS
    of csrc/conv_i8.cu's build, by kernel, beside ptxas's registers and
    spills; fails unless every conv_i8_kernel has both."""
    from pixel_embedded_affinity_torch import cuda_build
    from pixel_embedded_affinity_torch.ops import conv_i8_cuda as c8

    so = cuda_build.library_path(c8.SOURCE)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed on {so}: {out.stderr[-500:]}")
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = {"IGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += op in ln
    ptxas = ptxas_info(c8.SOURCE)
    res = {nice: {**counts[k], "ptxas": ptxas.get(k, "n/a")}
           for k, nice in zip(counts, demangled(counts))}
    for nice, r in res.items():
        print(f"[int8] sass {nice}: {json.dumps(r)}")
    convs = {k: v for k, v in res.items() if "conv_i8_kernel" in k}
    check(convs and all(v["IGMMA"] > 0 and v["UTMALDG"] > 0 for v in convs.values()),
          f"I8c without wgmma or TMA loads in its SASS: {convs}")
    return res


# the groups of int8 serving's profile: a kernel goes to the first group
# one of whose name parts its lower-cased name holds
INT8_PROFILE_GROUPS = (
    ("I8c", ("conv_i8_kernel",)), ("I8q", ("quantize_kernel",)),
    ("K1f affinity", ("affinity",)), ("K7/K9/K8", ("conv3x3", "s2d_block")),
    ("cuDNN convs", ("fprop", "cudnn", "implicit", "conv")),
    ("matmul (the einsum upsampling)", ("gemm", "cutlass", "matmul", "splitk")),
    ("elementwise and copies", ("elementwise", "copy", "cat", "fill", "reduce", "pad", "index",
                                "clamp", "where")))


def phase_int8_kernels(cfg, sd, samples) -> dict:
    """I8c and I8q on the card against their plain versions at the real
    shapes: every conv_i8 and quantize_act call of the int8 fast forward
    (INT8_DEFAULT_SITES, the served s2d input and full-resolution head) of
    the full-width cvppp model at B=1 and B=4, float32 and bfloat16
    compute; the int32 accumulators exact, the outputs equal to the bit.
    Then each call of the B=1 float32 forward timed by CUDA graph replay,
    L2 flushed, beside its bound, the plain version and the yardsticks."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model
    from pixel_embedded_affinity_torch.models import (INT8_DEFAULT_SITES,
                                                      build_fast_resunet_forward,
                                                      calibrate_int8_ranges, pack_image_s2d)
    from pixel_embedded_affinity_torch.ops import conv_i8_cuda as c8

    sd = bn_stats_sd(sd, SEED + 25)
    packed = torch.from_numpy(pack_image_s2d(np.stack([s["image"] for s in samples]))).cuda()
    recorded = {}
    n_sites = len(INT8_DEFAULT_SITES)
    for dtype in ("float32", "bfloat16"):
        model = build_model(cfg, sd, device="cuda", dtype=dtype)
        kw = dict(dtype=model.compute_dtype, input_format="s2d")
        ranges = calibrate_int8_ranges(model, [packed], **kw)
        fwd = build_fast_resunet_forward(model, head_at_fullres=True, int8_sites=INT8_DEFAULT_SITES,
                                         act_ranges=ranges, **kw)
        for bs in (1, 4):
            with _Recorder() as rec:
                fwd(packed[:bs])
            torch.cuda.synchronize()
            for x_q, w, sc, sh, pad, out in rec.convs:
                acc = c8.conv_i8_acc(x_q, w, pad)
                check(torch.equal(acc, c8.conv_i8_acc_plain(x_q, w, pad)),
                      f"I8c {dtype} B={bs} {tuple(x_q.shape)} -> {w.cout}: accumulators differ")
                ref = c8.conv_i8_plain(x_q, w, sc, sh, pad)
                check(torch.equal(out, ref), f"I8c {dtype} B={bs} {tuple(x_q.shape)}: output "
                      f"off the plain version by {(out - ref).abs().max().item()}")
            for x, scale, out in rec.quants:
                check(torch.equal(out, c8.quantize_act_plain(x, scale)),
                      f"I8q {dtype} B={bs} {tuple(x.shape)} {x.dtype}: codes differ")
            if dtype == "bfloat16" and bs == 1:  # the yardstick on a bf16 input, once
                x16, s16, _ = rec.quants[0]
                try:
                    _quantize_library(x16, s16)()
                    print("[int8] torch.quantize_per_tensor takes a bfloat16 input here")
                except RuntimeError as e:
                    print(f"[int8] torch.quantize_per_tensor refuses a bfloat16 input: "
                          f"{str(e).splitlines()[0][:200]}")
            in_types = sorted({str(x.dtype) for x, _, _ in rec.quants})
            print(f"[int8] {dtype} B={bs}: {len(rec.convs)} I8c calls and {len(rec.quants)} I8q "
                  f"calls ({in_types} in) at the {n_sites} sites; accumulators exact, outputs "
                  f"and codes equal to the bit")
            check(len(rec.convs) == 23 and len(rec.quants) == 18,
                  f"{len(rec.convs)} I8c, {len(rec.quants)} I8q calls, expected 23 and 18")
            recorded[(dtype, bs)] = rec
    sass = i8c_sass()
    # the B=1 float32 forward's calls, timed
    flush = 64 << 20
    rows, tot, split = [], {}, {"bytes": 0.0, "operations": 0.0}
    card = card_line()
    one = torch.zeros(1, device="cuda")
    floor_ms = graph_ms(lambda: one.add_(1.0), flush_bytes=flush)
    print(f"[int8] the floor of one call timed alike (a one-element kernel by CUDA graph "
          f"replay, L2 flushed): {floor_ms} ms, {card}")
    for x_q, w, sc, sh, pad, _ in recorded[("float32", 1)].convs:
        t_bytes, t_ops = i8c_bound(x_q, w, pad)
        split["bytes"] += t_bytes
        split["operations"] += t_ops
        b_ms, b_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
        fns = {"ms": lambda: c8.conv_i8(x_q, w, sc, sh, pad),
               "plain_ms": lambda: c8.conv_i8_plain(x_q, w, sc, sh, pad),
               **{f"{k}_ms": f for k, f in _i8_library(x_q, w, pad).items()}}
        r = {k: (graph_ms(f, flush_bytes=flush) if k in ("ms", "plain_ms")
                 else _graph_ms_or_none(f, flush)) for k, f in fns.items()}
        r.update(bound_ms=b_ms, bound_by=b_by, shape=list(x_q.shape), cout=w.cout,
                 taps=[w.kh, w.kw], padding=list(pad), plan=c8.conv_plan(x_q.shape, w, pad))
        rows.append(r)
        for k in ("ms", "plain_ms", "cudnn_bf16_ms", "cudnn_f32_ms", "int_mm_im2col_ms",
                  "bound_ms"):
            tot[k] = None if r[k] is None or tot.get(k, 0.0) is None else tot.get(k, 0.0) + r[k]
        print(f"[int8] I8c {tuple(x_q.shape)} {w.kh}x{w.kw} -> {w.cout} pad {pad}: "
              + json.dumps({k: v for k, v in r.items() if k.endswith("ms")})
              + f" ({b_by}); plan {json.dumps(r['plan'])}, {card}")
    qtot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    qrows = []
    for x, scale, _ in recorded[("float32", 1)].quants:
        xq = x.contiguous()
        q = {"ms": graph_ms(lambda: c8.quantize_act(xq, scale), flush_bytes=flush),
             "plain_ms": graph_ms(lambda: c8.quantize_act_plain(xq, scale), flush_bytes=flush),
             "library_ms": _graph_ms_or_none(_quantize_library(xq, scale), flush),
             "bound_ms": xq.numel() * (xq.element_size() + 1) / HBM_BYTES_PER_S * 1e3,
             "shape": list(xq.shape)}
        qrows.append(q)
        for k in qtot:
            qtot[k] = None if q[k] is None or qtot[k] is None else qtot[k] + q[k]
    # the summed bound is labelled by the larger of its two sums; the calls
    # bound each way are counted beside it
    by_rows = {k: sum(r["bound_by"] == k for r in rows) for k in split}
    print(f"[int8] one B=1 float32 int8 forward's 23 I8c calls, summed (ms by CUDA graph "
          f"replay, L2 flushed): {json.dumps(tot)}; the bound's sums by bytes and by "
          f"operations {json.dumps(split)}, calls bound each way {json.dumps(by_rows)}; its 18 "
          f"I8q calls (library_ms: torch.quantize_per_tensor): {json.dumps(qtot)}, {card}")
    print(f"[int8] I8c rows: {json.dumps(rows)}")
    print(f"[int8] I8q rows: {json.dumps(qrows)}")
    return {"I8c": {"max_abs_err": 0.0, **tot, "library_ms": tot["cudnn_bf16_ms"],
                    "bound_by": max(split, key=split.get), "bound_by_calls": by_rows,
                    "rows": rows, "floor_ms": floor_ms, "sass": sass},
            "I8q": {"max_abs_err": 0.0, **qtot, "bound_by": "bytes", "rows": qrows,
                    "floor_ms": floor_ms}}


def phase_int8_serving(cfg, sd, samples) -> dict:
    """CVPPP int8 serving (model.int8_infer through use_fast) at full width,
    B=1 and B=4, with I8c's and I8q's counts set to 0 just before each run
    and read just after; the forward+affinity device ms/img of the int8,
    float32 and bfloat16 fast forwards; the int8 embedding's cosine and
    affinities against float32's at JAX's bars; the metrics beside
    float32's. Returns the launches."""
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import build_model, fast_affinities, run_inference_2d
    from pixel_embedded_affinity_torch.models import (INT8_DEFAULT_SITES,
                                                      build_fast_resunet_forward,
                                                      calibrate_int8_ranges, pack_image_s2d)
    from pixel_embedded_affinity_torch.ops import conv_i8_cuda as c8
    from pixel_embedded_affinity_torch.ops import multi_offset

    cfg8 = copy.deepcopy(cfg)
    cfg8.model.int8_infer = True
    launches = {"I8c": 0, "I8q": 0}
    for bs in (1, 4):
        c8.conv_i8.launches = c8.quantize_act.launches = 0
        timing: dict = {}
        _, agg = run_inference_2d(cfg8, sd, samples, timing=timing, batch_size=bs, device="cuda",
                                  use_fast=True)
        n = {"I8c": c8.conv_i8.launches, "I8q": c8.quantize_act.launches}
        _, ref = run_inference_2d(cfg, sd, samples, batch_size=bs, device="cuda", use_fast=True)
        batches = -(-len(samples) // bs)
        check(n == {"I8c": 23 * batches, "I8q": 18 * batches},
              f"int8 serving B={bs}: launches {n}, {batches} batches")
        for k in launches:
            launches[k] += n[k]
        print(f"[int8] serving B={bs} (int8_infer, use_fast): metrics {json.dumps(agg)}; float32 "
              f"fast forward {json.dumps(ref)}; launches {json.dumps(n)}; ms/img wall "
              f"{timing['total_s'] / len(samples) * 1e3:.4f} (setup with calibration "
              f"{timing['setup_s'] * 1e3:.4f} ms a run)")
        check(all(np.isfinite(v) for v in agg.values()), "int8 serving metrics")
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    packed = torch.from_numpy(pack_image_s2d(np.stack([s["image"] for s in samples]))).cuda()
    fwds = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(cfg, sd, device="cuda", dtype=dtype)
        kw = dict(dtype=model.compute_dtype, input_format="s2d", head_at_fullres=True)
        fwds[dtype] = build_fast_resunet_forward(model, **kw)
        if dtype == "float32":
            ranges = calibrate_int8_ranges(model, [packed], dtype=model.compute_dtype,
                                           input_format="s2d")
            fwds["int8"] = build_fast_resunet_forward(model, int8_sites=INT8_DEFAULT_SITES,
                                                      act_ranges=ranges, **kw)
    with torch.no_grad(), float32_convs():
        e32, _ = fwds["float32"](packed)
        e8, _ = fwds["int8"](packed)
        a32 = fast_affinities(fwds["float32"], packed, offsets)
        a8 = fast_affinities(fwds["int8"], packed, offsets)
    n32 = torch.nn.functional.normalize(e32.double(), dim=-1)
    n8 = torch.nn.functional.normalize(e8.double(), dim=-1)
    cos = (n32 * n8).sum(-1)
    d = (a8 - a32).abs()
    quality = {"cos_min": cos.min().item(), "cos_mean": cos.mean().item(),
               "aff_max": d.max().item(), "aff_mean": d.mean().item()}
    print(f"[int8] int8 against the float32 fast forward, 4 images: {json.dumps(quality)} "
          f"(bars: cos > {INT8_COS_MIN}, max < {INT8_AFF_MAX}, mean < {INT8_AFF_MEAN})")
    check(quality["cos_min"] > INT8_COS_MIN and quality["aff_max"] < INT8_AFF_MAX
          and quality["aff_mean"] < INT8_AFF_MEAN, f"int8 off float32: {quality}")
    # ms/img of each forward + affinity: CUDA events around the eager call
    # (the host's launch gaps included) and CUDA graph replay (device time)
    times, graphed = {}, {}
    for bs in (1, 4):
        pb = packed[:bs]
        with torch.no_grad(), float32_convs():
            times[bs] = {k: timed_ms(lambda f=f: fast_affinities(f, pb, offsets)) / bs
                         for k, f in fwds.items()}
            graphed[bs] = {k: _graph_ms_or_none(lambda f=f: fast_affinities(f, pb, offsets), 0)
                           for k, f in fwds.items()}
        graphed[bs] = {k: None if v is None else v / bs for k, v in graphed[bs].items()}
    print(f"[int8] fast forward + affinity, ms/img by CUDA events around the eager call "
          f"(warm median of 20, host launch gaps included): {json.dumps(times)}; by CUDA "
          f"graph replay (median of 20, device time): {json.dumps(graphed)}, {card_line()}")
    # where one graphed B=4 forward + affinity spends the card's time, by
    # kernel group, int8 beside bf16
    pb = packed[:4]
    for k in ("int8", "bfloat16"):
        with torch.no_grad(), float32_convs():
            graph = capture_graph(lambda f=fwds[k]: fast_affinities(f, pb, offsets))
        device_breakdown(graph.replay, 4, label=f"int8 serving, {k} B=4 graphed",
                         split=INT8_PROFILE_GROUPS,
                         require=("conv_i8_kernel", "quantize_kernel") if k == "int8" else ())
    return {"launches": launches, "quality": quality, "times": times, "graphed": graphed}


def phase_export(cfg, sd, samples) -> dict:
    """The serving artifact on the card: export_checkpoint at 544x544 on
    cuda (the plain affinity and upsampling inside), load_artifact, batches
    1 and 4 against the serving path's affinities (the dense module and
    K1f) at EXPORT_ATOL; the artifact's bytes and times."""
    import torch

    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.infer import (build_model, export_checkpoint,
                                                     forward_affinities, load_artifact)
    from pixel_embedded_affinity_torch.ops import multi_offset

    out = os.path.join(REPO, "build", "chip_smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    path = os.path.join(out, "cvppp.pt2")
    hw = samples[0]["image"].shape[:2]
    t0 = time.perf_counter()
    export_checkpoint(cfg, sd, path, hw=hw, device="cuda")
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_artifact(path).module()
    t_load = time.perf_counter() - t0
    model = build_model(cfg, sd, device="cuda")
    offsets = multi_offset(cfg.data.shifts, cfg.data.neighbor)
    x = torch.from_numpy(np.stack([s["image"] for s in samples])).cuda()
    res = {"bytes": os.path.getsize(path), "export_s": t_export, "load_s": t_load}
    for bs in (1, 4):
        with torch.no_grad(), float32_convs():
            (got,) = program(x[:bs])
            want = forward_affinities(model, x[:bs].permute(0, 3, 1, 2).contiguous(), offsets)
            err = (got - want).abs().max().item()
            res[f"B{bs}_err"] = err
            res[f"B{bs}_ms"] = timed_ms(lambda: program(x[:bs])) / bs
        check(got.shape == want.shape and err <= EXPORT_ATOL,
              f"artifact at B={bs}: {tuple(got.shape)}, {err} off the serving path")
    print(f"[export] {json.dumps(res)} (ms/img by CUDA events, float32, TF32 off), {card_line()}")
    return res


def phase_dcp() -> dict:
    """The full-width CVPPP train state after one step saved with
    save_checkpoint_dcp and read back: the tree bit-equal to the state's,
    a restored state bit-equal; bytes and seconds."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.convert import train_state_to_flax
    from pixel_embedded_affinity_torch.train import (init_state, load_checkpoint_dcp, restore,
                                                     save_checkpoint_dcp)

    cfg = load_config("cvppp")
    state = init_state(cfg, "cuda")
    x = torch.randn(2, 3, 544, 544, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    sum(o.float().square().mean() for o in state.model(x)).backward()
    state.optimizer.step()
    state.step = 1
    out = os.path.join(REPO, "build", "chip_smoke_dcp")
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target = save_checkpoint_dcp(out, state, 1)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = load_checkpoint_dcp(target)
    t_load = time.perf_counter() - t0
    want = train_state_to_flax(state.model, state.optimizer, 1)
    got_items, want_items = dict(tree_items(tree)), dict(tree_items(want))
    check(got_items.keys() == want_items.keys(), "DCP tree keys")
    check(all(np.asarray(got_items[k]).dtype == np.asarray(v).dtype
              and np.array_equal(got_items[k], v) for k, v in want_items.items()),
          "DCP round trip is not bit-equal")
    fresh = init_state(load_config("cvppp", {"train": {"random_seed": 7}}), "cuda")
    restore(fresh, tree)
    check(all(torch.equal(fresh.model.state_dict()[k], v)
              for k, v in state.model.state_dict().items() if "num_batches" not in k),
          "restored model differs")
    nbytes = sum(os.path.getsize(os.path.join(target, f)) for f in os.listdir(target))
    res = {"bytes": nbytes, "save_s": t_save, "load_s": t_load, "entries": len(want_items)}
    print(f"[dcp] CVPPP train state, full width: {json.dumps(res)}; round trip bit-equal")
    return res


def phase_int8_quantile(cfg, sd) -> dict:
    """The percentile calibration at full width: calibrate_int8_ranges of
    the cvppp model on model.int8_calib_k (8) 544x544 images in one batch
    with quantile INT8_CALIB_PCT, as serving with model.int8_calib_pct does;
    its largest sites hold more than 2^24 elements. Each site's statistic
    (torch.kthvalue on the card) against a reference from a full torch.sort
    of the same |x| in float64: the two order statistics around the
    position that jnp.quantile forms in float32, interpolated in float64,
    within QUANTILE_RTOL. The distance to the quantile at the exact float64
    position is printed beside it."""
    import torch

    from pixel_embedded_affinity_torch.infer import build_model
    from pixel_embedded_affinity_torch.models import calibrate_int8_ranges, pack_image_s2d
    from pixel_embedded_affinity_torch.models import fast_forward as ff

    k = cfg.model.int8_calib_k
    check(k == 8, f"model.int8_calib_k is {k}, the JAX package's default is 8")
    images = synthetic_leaves(k, 530, 500, SEED + 26)
    packed = torch.from_numpy(pack_image_s2d(np.stack([s["image"] for s in images]))).cuda()
    model = build_model(cfg, bn_stats_sd(sd, SEED + 25), device="cuda")
    real, rows = ff._quantile, []

    def at(v, pos: float) -> float:
        lo = min(max(int(np.floor(pos)), 0), len(v) - 1)
        hi = min(max(int(np.ceil(pos)), 0), len(v) - 1)
        f = pos - np.floor(pos)
        return float(v[lo].item() * (1.0 - f) + v[hi].item() * f)

    def recorded(x, q):
        got = real(x, q)
        n = x.numel()
        v = torch.sort(x.double()).values
        pos32 = float(np.float32(q) * (np.float32(n) - np.float32(1)))
        rows.append({"n": n, "got": got.item(), "ref": at(v, pos32),
                     "exact_position": at(v, q * (n - 1))})
        del v
        return got

    ff._quantile = recorded
    try:
        t0 = time.perf_counter()
        ranges = calibrate_int8_ranges(model, [packed], dtype=model.compute_dtype,
                                       input_format="s2d", quantile=INT8_CALIB_PCT)
        t_cal = time.perf_counter() - t0
    finally:
        ff._quantile = real
    errs = [abs(r["got"] - r["ref"]) / r["ref"] for r in rows]
    off = [abs(r["exact_position"] - r["ref"]) / r["ref"] for r in rows]
    res = {"sites": len(rows), "largest_site": max(r["n"] for r in rows),
           "past_2_24": sum(r["n"] > 1 << 24 for r in rows), "max_rel_err": max(errs),
           "max_rel_to_exact_position": max(off), "calibration_s_with_references": t_cal}
    print(f"[int8] percentile calibration, {k} images, q {INT8_CALIB_PCT}: {json.dumps(res)}; "
          f"sites (elements, port, reference): "
          + "; ".join(f"{r['n']} {r['got']!r} {r['ref']!r}" for r in rows) + f", {card_line()}")
    check(len(rows) == len(ranges) and all(np.isfinite(v) and v > 0 for v in ranges.values()),
          f"percentile calibration: {len(rows)} statistics, ranges {ranges}")
    check(res["past_2_24"] > 0, "no calibration site past 2^24 elements")
    check(res["max_rel_err"] <= QUANTILE_RTOL,
          f"percentile calibration off the float64 sort by {res['max_rel_err']}")
    return res


def phase_int8_export_dcp(cfg, sd, samples) -> dict:
    """Phase 25: int8 serving's kernels and path, its percentile
    calibration, the serving artifact, DCP checkpoints."""
    kernels = _timed("I8c, I8q", phase_int8_kernels, cfg, sd, samples)
    serving = _timed("int8 serving", phase_int8_serving, cfg, sd, samples)
    _timed("int8 quantile", phase_int8_quantile, cfg, sd)
    _timed("export", phase_export, cfg, sd, samples)
    _timed("dcp", phase_dcp)
    return {"kernels": kernels, "launches": serving["launches"]}


# ---- 26. train.steps_per_call: the training step as a CUDA graph
SPC = 4  # steps_per_call of the graphed runs
SPC_STEPS = 8
SPC_TIMED, SPC_PROFILED = 4, 2  # steps timed by CUDA events, profiled, a path
SPC_OPT_STEPS = 5
# one step from one state, eager on a copy and by a replay: where the eager
# step is not known to be bit-reproducible (the ResNet's bfloat16 step), the
# loss and the update of the parameters and of the BatchNorm statistics may
# differ from the eager step's by this much, relative; a replay whose update
# reads the previous step's scalars must lie farther off. On an H100 two eager 2D
# float32 steps' parameter updates lay 5.1e-6-3.1e-5 apart while cuDNN
# gave their convs' backward, the stale-scalar replay 2.2e-2 off
SPC_STEP_RTOL = 1e-4
# (label, preset, overrides, eager bit-reproducible); the 2D float32 steps
# are since their convs' backward is CWg and CXg (csrc/conv_grad.cu, ROADMAP
# §3 item 18), and cuDNN's deterministic algorithms for the ResNet's
# strided and 7x7 convs; the ResNet's bfloat16 step is not known to be
SPC_RUNS = (("cvppp", "cvppp", {}, ("float32", "bfloat16")),
            ("bbbc039v1", "bbbc039v1", {}, ("float32", "bfloat16")),
            ("bbbc039v1 unfused", "bbbc039v1", {"train": {"fuse_loss": False}},
             ("float32", "bfloat16")),
            ("ac3ac4", "ac3ac4", {}, ("float32", "bfloat16")),
            ("cvppp_resnet50", "cvppp_resnet50", {}, ("float32",)))
# a counted wrapper of the training step -> a pattern of its CUDA kernel's
# name in a profile: K2b and K3b by template argument; K2f and K3f are one
# kernel, K3f each step's last launch of it (phase 6's rule); K4f and K6f
# are one kernel that no step launches for both; CWg and CXg launch one of
# two kernels a call by shape (their helper launches, the split sum, dy's
# and the weights' remainders, are not counted)
SPC_KERNELS = {"wmse2d_fwd": r"\bwmse_fwd_kernel", "cross_wmse2d_fwd": r"\bwmse_fwd_kernel",
               "wmse2d_bwd": r"\bwmse_bwd_kernel<\w+, true",
               "cross_wmse2d_bwd": r"\bwmse_bwd_kernel<\w+, false",
               "fused_affinity_2d": r"\baffinity2d_fwd_kernel",
               "fused_cross_affinity_2d": r"\bcross_affinity_fwd_kernel",
               "cross_affinity_fwd": r"\bcross_affinity_fwd_kernel",
               "affinity_bwd": r"\baffinity_bwd_kernel",
               "cross_affinity_bwd": r"\bcross_affinity_bwd_kernel",
               "fused_affinity_3d": r"\baffinity3d_fwd_kernel",
               "upsample_bwd": r"\bupsample_bwd_kernel",
               "conv_wgrad": r"\b(conv_wgrad_kernel|wgrad_wgmma_kernel)",
               "conv_dgrad": r"\b(conv_dgrad_kernel|dgrad_wgmma_kernel)"}


def _spc_loss_d(a, b) -> float:
    """The largest relative difference of two runs' losses, step by step."""
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))


def _spc_param_d(a: dict, b: dict, p0: dict) -> float:
    """The distance of two runs' float tensors (parameters and BatchNorm
    statistics), the largest over tensors of ||a - b|| / ||a - p0||: as a
    share of how far the run moved them from p0; inf where a tensor that
    did not move differs."""
    out = 0.0
    for k, v in a.items():
        if not v.is_floating_point():
            continue
        moved = float((v.double() - p0[k].double()).norm())
        diff = float((v.double() - b[k].double()).norm())
        out = max(out, diff / moved if moved else (0.0 if diff == 0 else float("inf")))
    return out


def _spc_counted(total: dict, fn, *args, **kwargs):
    """fn(*args, **kwargs) with every counted wrapper's count set to 0 just
    before; its counts, read just after, are added to ``total``. Returns
    (result, counts, seconds)."""
    from pixel_embedded_affinity_torch.ops.launch_count import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    sec = time.perf_counter() - t0
    counts = launch_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return res, counts, sec


def _float_updates(opt_type, params, grads, sched):
    """The parameters after one update for each of ``grads``, the chain
    written with its scalars as Python floats: AMSGrad (eps 0.01, weight
    decay 1e-6) or SGD (momentum 0.9, weight decay 1e-4)."""
    import torch

    ps = [p.clone() for p in params]
    mu, nu, nu_max, trace = ([torch.zeros_like(p) for p in ps] for _ in range(4))
    for n, g in enumerate(grads):
        lr = float(sched(n))
        if opt_type == "sgd":
            g = torch._foreach_add(g, torch._foreach_mul(ps, 1e-4))
            torch._foreach_mul_(trace, 0.9)
            torch._foreach_add_(trace, g)
            torch._foreach_add_(ps, torch._foreach_mul(trace, -lr))
            continue
        b1, b2, c = 0.9, 0.999, np.float32(n + 1)
        g = torch._foreach_add(g, torch._foreach_mul(ps, 1e-6))
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, bc2))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, 0.01)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))
    return ps


def spc_optimizer_check():
    """AMSGrad (poly schedule) and SGD on the full-width cvppp model's
    parameters, SPC_OPT_STEPS updates, their scalars read from the device
    tensor, against the same updates with the scalars as Python floats,
    bit for bit."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.optim import SGD, AMSGrad, make_schedule

    params = [p.detach() for p in init_state(load_config("cvppp"), "cuda").model.parameters()]
    sched = make_schedule("poly", 1e-4, 1e-6, 1000, warmup_iters=2, decay_iters=6)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [[torch.randn(p.shape, generator=gen, device="cuda") for p in params]
             for _ in range(SPC_OPT_STEPS)]
    for opt_type in ("adam", "sgd"):
        ps = [torch.nn.Parameter(p.clone()) for p in params]
        opt = (AMSGrad(ps, eps=0.01, weight_decay=1e-6, schedule=sched) if opt_type == "adam"
               else SGD(ps, schedule=sched))
        for g in grads:
            for p, gi in zip(ps, g):
                p.grad = gi
            opt.step()
        ref = _float_updates(opt_type, params, grads, sched)
        same = all(torch.equal(a, b) for a, b in zip(ps, ref))
        worst = max(float((a - b).detach().abs().max()) for a, b in zip(ps, ref))
        print(f"[spc] {type(opt).__name__}: {SPC_OPT_STEPS} updates of {len(params)} tensors, "
              f"scalars from the device tensor against floats: bit-equal {same} (max |d| "
              f"{worst:.3e})")
        check(same, f"{type(opt).__name__}: the device-scalar update differs from the float one")


def _spc_train(total: dict, cfg, data, steps: int, spc: int, out: str):
    """train() from the config's seed with steps_per_call=spc, validation
    off; (state, timing, launches, seconds, peak GiB)."""
    import torch

    from pixel_embedded_affinity_torch.train import train

    cfg = copy.deepcopy(cfg)
    cfg.train.steps_per_call = spc
    cfg.save_path = out
    timing: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (state, _), launches, sec = _spc_counted(total, train, cfg, max_iters=steps,
                                             data_override=data, device="cuda", timing=timing)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return state, timing, launches, sec, peak


def _spc_seen(prof, label: str, counted: dict, replayed: dict) -> dict:
    """Each kernel's launches in a profile of SPC_PROFILED calls, held
    against what the wrappers counted in them (``counted``) plus what one
    call replays uncounted (``replayed``, by wrapper); the launches the
    profiler saw, by wrapper."""
    per_call = {}
    for w in set(counted) | set(replayed):
        check(w in SPC_KERNELS, f"{label}: {w} launched, no kernel name known for it")
        check(counted.get(w, 0) % SPC_PROFILED == 0,
              f"{label}: {w} counted {counted.get(w, 0)} in {SPC_PROFILED} calls")
        per_call[w] = counted.get(w, 0) // SPC_PROFILED + replayed.get(w, 0)
    names = [e.name for e in sorted((e for e in prof.events()
                                     if str(getattr(e, "device_type", "")).endswith("CUDA")),
                                    key=lambda e: e.time_range.start)]
    seen = {}
    for pat in sorted({SPC_KERNELS[w] for w in per_call}):
        ws = sorted(w for w in per_call if SPC_KERNELS[w] == pat)
        got = [n for n in names if re.search(pat, n)]
        want = sum(per_call[w] for w in ws)
        check(len(got) == SPC_PROFILED * want,
              f"{label}: the profiler saw {len(got)} launches of {pat} in {SPC_PROFILED} calls, "
              f"the wrappers and the graph {want} a call ({ws})")
        if len(ws) == 1:
            seen[ws[0]] = len(got)
            continue
        # K3f is each call's last launch of the WMSE forward
        check(ws == ["cross_wmse2d_fwd", "wmse2d_fwd"],
              f"{label}: {ws} launch one kernel and cannot be told apart")
        k3f = per_call["cross_wmse2d_fwd"]
        seen["cross_wmse2d_fwd"] = SPC_PROFILED * k3f
        seen["wmse2d_fwd"] = len(got) - SPC_PROFILED * k3f
    return seen


def _spc_profile(fn, label: str, replayed: dict):
    """ms a step of fn() by CUDA events over SPC_TIMED calls, and a
    torch.profiler trace of SPC_PROFILED more: device busy ms a step, the
    idle share of the host-clock wall, the port's kernels, each one's
    launches held against the wrappers' counts and the graph's
    (:func:`_spc_seen`; ``replayed``: each wrapper's launches that a call
    makes uncounted, by a replay). Returns (event ms, busy ms, idle share,
    the replays' launches that the profiler saw, by wrapper)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pixel_embedded_affinity_torch.ops.launch_count import launch_counts

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(SPC_TIMED):
        fn()
    end.record()
    torch.cuda.synchronize()
    ev_ms = start.elapsed_time(end) / SPC_TIMED
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(SPC_PROFILED):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / SPC_PROFILED
    counted = {k: n - before.get(k, 0) for k, n in launch_counts().items()
               if n != before.get(k, 0)}
    busy = 0.0
    n_kernels = 0
    for e in prof.key_averages():
        t_us = getattr(e, "self_device_time_total", None)
        if t_us is None:
            t_us = getattr(e, "self_cuda_time_total", 0)
        if t_us > 0:
            busy += t_us / 1e3 / SPC_PROFILED
            n_kernels += e.count // SPC_PROFILED
    idle = max(0.0, 1 - busy / wall) if wall > 0 else float("nan")
    seen = _spc_seen(prof, label, counted, replayed)
    by_replay = {w: n - counted.get(w, 0) for w, n in seen.items() if n != counted.get(w, 0)}
    print(f"[spc] {label}: {ev_ms:.4f} ms a step by CUDA events ({SPC_TIMED} steps, the "
          f"sampler's draw and the EMA view included); profile of {SPC_PROFILED}: device busy "
          f"{busy:.4f} of {wall:.4f} ms wall a step, idle share {idle:.3f}, {n_kernels} kernels "
          f"a step; the port's kernels the profiler saw a step {_per(seen)}, of them by the "
          f"graph's replays {_per(by_replay)}, counted by the wrappers {_per(counted)}")
    return ev_ms, busy, idle, by_replay


def _per(counts: dict) -> dict:
    return {k: v // SPC_PROFILED for k, v in sorted(counts.items())}


def _spc_step_d(a, b, la, lb, before: dict) -> tuple:
    """One step's distance of state b from state a, both from ``before``
    (a state dict): the losses' relative difference, and for the
    parameters and for the buffers the norm of the difference of the two
    updates over the norm of a's update."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    params = {n for n, _ in a.model.named_parameters()}

    def rel(keys):
        num = sum(float((sa[k].double() - sb[k].double()).norm()) ** 2 for k in keys)
        den = sum(float((sa[k].double() - before[k].double()).norm()) ** 2 for k in keys)
        return (num / den) ** 0.5 if den else (0.0 if num == 0 else float("inf"))

    floats = [k for k, v in sa.items() if v.is_floating_point()]
    return (abs(la - lb) / abs(la), rel([k for k in floats if k in params]),
            rel([k for k in floats if k not in params]))


def _spc_one_step(step_fn, runner, batch, tag: str, exact: bool):
    """One step from the runner's state on ``batch``: eagerly on two copies
    and by a replay; held bit for bit where the eager step is
    bit-reproducible, else within SPC_STEP_RTOL. Then the planted fault:
    the state put back, a replay whose update reads the previous step's
    scalars (the load skipped), which must lie off by more than the bar."""
    import torch

    st, opt = runner.state, runner.state.optimizer
    tensors = (list(st.model.state_dict().values()) + list(opt.scalar_buffers)
               + [v for s in opt.state.values() for v in s.values() if torch.is_tensor(v)])
    saved = [t.clone() for t in tensors]
    counts = (st.step, opt.count, [(s, s["count"]) for s in opt.state.values() if "count" in s])
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    e1, e2 = copy.deepcopy(st), copy.deepcopy(st)
    l1 = float(step_fn(e1, batch)[1]["loss"])
    l2 = float(step_fn(e2, batch)[1]["loss"])
    lg = float(runner(batch)[1]["loss"])
    spread = _spc_step_d(e1, e2, l1, l2, before)
    got = _spc_step_d(e1, st, l1, lg, before)
    same = l1 == lg and all(torch.equal(v, st.model.state_dict()[k])
                            for k, v in e1.model.state_dict().items())
    for t, s in zip(tensors, saved):
        t.copy_(s)
    st.step, opt.count = counts[0], counts[1]
    for s, n in counts[2]:
        s["count"] = n
    opt.load_device_scalars = lambda: None  # the planted fault
    try:
        lf = float(runner(batch)[1]["loss"])
    finally:
        del opt.load_device_scalars
    fault = _spc_step_d(e1, st, l1, lf, before)
    print(f"[spc] {tag}: one step at step {counts[0] + 1} from one state, eager against eager "
          f"(loss, parameters' update, buffers' update, relative) {spread}; eager against a "
          f"replay {got}, bit-equal {same}; a replay with the previous step's scalars {fault} "
          f"(held {'bit for bit' if exact else f'within {SPC_STEP_RTOL}'})")
    if exact:
        check(same, f"{tag}: one replayed step differs from the eager step by {got}")
    else:
        check(max(got) <= SPC_STEP_RTOL, f"{tag}: one replayed step off the eager step by {got}")
    check(fault[1] > SPC_STEP_RTOL, f"{tag}: the stale-scalar replay is not caught: {fault}")


def phase_steps_per_call(bbbc_arrays, bbbc_valid) -> dict:
    """Phase 26: each preset trained SPC_STEPS steps eagerly and at
    steps_per_call=SPC from one seed, in float32 and bfloat16: losses and
    parameters against each other, step times, capture seconds, peak
    memory, a profile of the replays, one step from one state; then the
    CLI at steps_per_call=SPC with a resume. Returns each counted
    wrapper's launches over the phase's runs: those the wrappers counted,
    and of the replays those the profiler saw."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays
    from pixel_embedded_affinity_torch.train import init_state, make_train_step
    from pixel_embedded_affinity_torch.train.__main__ import main
    from pixel_embedded_affinity_torch.train.graph_step import GraphedStep
    from pixel_embedded_affinity_torch.train.loop import resident_sampler

    out = os.path.join(REPO, "build", "chip_smoke_spc")
    shutil.rmtree(out, ignore_errors=True)
    card = card_line()
    print(f"[spc] torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    spc_optimizer_check()
    cvppp_data = (pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED)), [])
    data_3d = (train3d_data()[0][0], None)
    data = {"cvppp": cvppp_data, "cvppp_resnet50": cvppp_data, "ac3ac4": data_3d,
            "bbbc039v1": (bbbc_arrays, [])}
    total: dict = {}
    runs_3d = {}
    for label, preset, overrides, exact_dtypes in SPC_RUNS:
        for dtype in ("float32", "bfloat16"):
            tag = f"{label} {dtype}"
            cfg = load_config(preset, {**overrides, "model": {"dtype": dtype},
                                       "train": {**overrides.get("train", {}), "if_valid": False,
                                                 "display_freq": 1, "save_freq": 10 ** 6}})
            base = os.path.join(out, tag.replace(" ", "_"))
            exact = dtype in exact_dtypes
            se, te, le, sec_e, peak_e = _spc_train(total, cfg, data[preset], SPC_STEPS, 1,
                                                   os.path.join(base, "eager"))
            sg, tg, lg, sec_g, peak_g = _spc_train(total, cfg, data[preset], SPC_STEPS, SPC,
                                                   os.path.join(base, "graphed"))
            # the graphed run's wrappers count its first step (eager) and the
            # capture, not the replays
            step_launches = {k: v // SPC_STEPS for k, v in le.items() if v}
            check(all(v % SPC_STEPS == 0 for v in le.values()) and step_launches
                  and lg == {k: 2 * step_launches.get(k, 0) for k in lg},
                  f"{tag}: launches eager {le}, graphed (first step and capture) {lg}")
            pe, pg = se.model.state_dict(), sg.model.state_dict()
            p0 = init_state(cfg, "cuda").model.state_dict()
            same = (te["loss"] == tg["loss"] and all(torch.equal(pe[k], pg[k]) for k in pe))
            loss_d = _spc_loss_d(te["loss"], tg["loss"])
            param_d = _spc_param_d(pe, pg, p0)
            med = {}
            for name, t in (("eager", te), ("graphed", tg)):
                d = [1e3 * x for x in t["data_s"][2:]]
                s = [1e3 * x for x in t["step_s"][2:]]
                med[name] = (float(np.median(d)), float(np.median(s)))
            print(f"[spc] {tag}: {SPC_STEPS} steps eager and at steps_per_call={SPC}: "
                  f"losses {te['loss']} / {tg['loss']}; bit-equal {same}; largest loss "
                  f"difference rel {loss_d:.3e}, parameters {param_d:.3e} of their movement "
                  f"({'held bit for bit' if exact else 'not held: one step is, below'})")
            print(f"[spc] {tag}: warm median ms a step (steps 3..{SPC_STEPS}, synchronised): "
                  f"eager data {med['eager'][0]:.4f} + step {med['eager'][1]:.4f}, graphed data "
                  f"{med['graphed'][0]:.4f} + step {med['graphed'][1]:.4f}; capture "
                  f"{tg.get('capture_s', float('nan')):.3f} s; peak memory {peak_e:.4f} GiB eager, "
                  f"{peak_g:.4f} GiB graphed; train() {sec_e:.2f} / {sec_g:.2f} s; launches a "
                  f"step {step_launches}; {card}")
            if exact:
                check(same, f"{tag}: the graphed run differs from the eager run "
                            f"(loss {loss_d:.3e}, parameters {param_d:.3e})")
            if preset == "ac3ac4" and dtype == "float32":
                runs_3d = {"graphed": (tg["loss"], {k: v.clone() for k, v in pg.items()})}

            # steady steps of each path on its own state, by CUDA events and
            # profiled, the replays' launches seen by the profiler
            next_batch = resident_sampler(cfg, data[preset][0], torch.device("cuda"))
            step_fn = make_train_step(cfg)
            runner = GraphedStep(step_fn, sg, graph=True)

            def warm():
                runner(next_batch(sg.step))  # the warm-up step
                runner(next_batch(sg.step))  # the capture and its first replay

            _spc_counted(total, warm)
            check(runner.per_replay == step_launches,
                  f"{tag}: a replay holds {runner.per_replay}, an eager step {step_launches}")
            (ev_e, busy_e, idle_e, _), _, _ = _spc_counted(
                total, _spc_profile, lambda: step_fn(se, next_batch(se.step)), f"{tag} eager", {})
            (ev_g, busy_g, idle_g, seen), _, _ = _spc_counted(
                total, _spc_profile, lambda: runner(next_batch(sg.step)), f"{tag} graph replay",
                runner.per_replay)
            for k, v in seen.items():
                total[k] = total.get(k, 0) + v
            print(f"[spc] {tag}: ms a step by CUDA events eager {ev_e:.4f} (idle {idle_e:.3f}), "
                  f"graph replay {ev_g:.4f} (idle {idle_g:.3f}): {ev_e / ev_g:.3f}x; {card}")
            _spc_counted(total, _spc_one_step, step_fn, runner, next_batch(sg.step), tag,
                         exact)
            del runner, se, sg, pe, pg, p0
            torch.cuda.empty_cache()

    # the CLI at steps_per_call=SPC: ac3ac4 4 steps, a checkpoint, a resume to 8
    cli_dir = os.path.join(out, "cli")
    def argv(iters, *extra):
        return ["-c", "ac3ac4", "--device", "cuda", "-i", str(iters), "-o",
                f"save_path={cli_dir}", f"train.steps_per_call={SPC}", "train.display_freq=1",
                "train.if_valid=False", f"train.save_freq={SPC}", *extra]

    (_, _), got_a, sec_a = _spc_counted(total, main, argv(SPC), data_override=data_3d)
    (state, _), got_b, sec_b = _spc_counted(total, main, argv(SPC_STEPS, "train.resume=True"),
                                            data_override=data_3d)
    losses = [r["loss"] for r in _logged(os.path.join(cli_dir, "ac3ac4"))]
    logged = [r["step"] for r in _logged(os.path.join(cli_dir, "ac3ac4"))]
    got = state.model.state_dict()
    ref_losses, ref = runs_3d["graphed"]
    # num_batches_tracked restarts at a resume: JAX's msgpack state has no such counter
    differ = [k for k in ref if not k.endswith("num_batches_tracked")
              and not torch.equal(got[k], ref[k])]
    same = not differ
    print(f"[spc-cli] -c ac3ac4 -o train.steps_per_call={SPC}: {SPC} steps ({sec_a:.2f} s), "
          f"a checkpoint, a resume to {SPC_STEPS} ({sec_b:.2f} s); logged steps {logged}, "
          f"losses {losses}; parameters bit-equal to the uninterrupted graphed run: {same}; "
          f"launches counted (first steps and captures) {json.dumps(got_a)} + "
          f"{json.dumps(got_b)}; {card}")
    check(state.step == SPC_STEPS and same, f"spc-cli: the resumed graphed run differs at {differ}")
    # displays at it <= S and at multiples of S: steps 1..S's average at S, then S
    check(logged == [SPC, SPC_STEPS], f"spc-cli: logged steps {logged}")
    check(np.isclose(losses[-1], np.mean(ref_losses[SPC:]), rtol=1e-6),
          f"spc-cli: last display {losses[-1]}, uninterrupted {np.mean(ref_losses[SPC:])}")
    print(f"[spc] launches in phase 26 by wrapper (counted, and the profiled replays'): "
          f"{json.dumps(total)}")
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import conv_dgrad, conv_wgrad
    from pixel_embedded_affinity_torch.ops.upsample_cuda import upsample_bwd

    labels = {**_all_launchers(), "UPb": upsample_bwd, "CWg": conv_wgrad, "CXg": conv_dgrad}
    return {k: total.get(f.__name__, 0) for k, f in labels.items()}


CG_SOURCE = "pixel_embedded_affinity_torch/csrc/conv_grad.cu"
CG_REPLACES = ("none: no TPU site; the deterministic float32 backward of the 2D models' "
               "stride-1 1x1 and 3x3 convs (models/common.py; XLA's conv backward is "
               "deterministic)")
# the 2D float32 steps whose convs CWg and CXg serve: the U-Nets' every
# conv, the ResNets' stride-1 1x1 and 3x3 ones (their 7x7 stem and strided
# convs keep cuDNN's backward)
CG_PRESETS = ("cvppp", "bbbc039v1", "cvppp_resnet50", "cvppp_resnet101")
CG_UNETS = ("cvppp", "bbbc039v1")
CG_REPEATS = 3  # runs of each kernel and of cuDNN's default backward a conv


def recorded_convs(preset: str, data) -> tuple:
    """One float32 training step of the full-width ``preset`` (B=2, the
    device-resident sampler over ``data``): (name, conv, input, output
    gradient, whether the input needs a gradient) for every Conv2d that the
    backward reached and CWg and CXg serve, in call order, and the names of
    those that take cuDNN's deterministic backward instead (the ResNets'
    7x7 stem and strided convs)."""
    import torch

    from pixel_embedded_affinity_torch.config import load_config
    from pixel_embedded_affinity_torch.train import init_state
    from pixel_embedded_affinity_torch.train.loop import make_train_step, resident_sampler

    cfg = load_config(preset)
    state = init_state(cfg, "cuda")
    step = make_train_step(cfg)
    batch = step.ema_batch(resident_sampler(cfg, data, torch.device("cuda"))(0), 0)
    seen: dict = {}
    hooks = []
    for name, m in state.model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            def fwd(mod, inp, out, name=name):
                if torch.is_grad_enabled():
                    seen[name] = {"conv": mod, "x": inp[0].detach(),
                                  "need_x": inp[0].requires_grad}

            def bwd(mod, gin, gout, name=name):
                seen[name]["dy"] = gout[0].detach()

            hooks += [m.register_forward_hook(fwd), m.register_full_backward_hook(bwd)]
    step.grads(state.model, batch)
    for h in hooks:
        h.remove()
    reached = [(n, r["conv"], r["x"], r["dy"], r["need_x"]) for n, r in seen.items()
               if "dy" in r]
    return ([c for c in reached if c[1]._kernel_grad],
            [c[0] for c in reached if not c[1]._kernel_grad])


def conv_grads_per_step(preset: str, data) -> tuple:
    """(CWg, CXg) launches of one float32 training step of ``preset``: each
    conv of :func:`recorded_convs`, and of those each whose input needs a
    gradient (not the image's convs)."""
    convs, _ = recorded_convs(preset, data)
    return len(convs), sum(c[4] for c in convs)


def cg_wgmma(cin: int, cout: int, h: int, w: int, k: int) -> bool:
    """Whether CWg takes its wgmma kernel at a shape (csrc/conv_grad.cu's
    rule, asked of its build; CXg takes it wherever H W % 4 == 0)."""
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import load

    return bool(load().conv_wgrad_wgmma(cin, cout, h, w, k))


def conv_grad_bound(b: int, cin: int, cout: int, h: int, w: int, k: int) -> tuple:
    """Least time in ms of one CWg or CXg call, and what bounds it: x, dy
    and the weights (or their gradients) each moved once over HBM, against
    2 Cout Cin k^2 B H W flops at the 3xTF32 rate."""
    px = b * h * w
    t_bytes = 4 * (px * (cin + cout) + cout * cin * k * k) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * cout * cin * k * k * px / TF32X3_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nhwc_dgrad(dy, wt):
    """CXg's alternative for a 3x3 conv: dy permuted to NHWC, K7's kernel
    (conv3x3_fused) with the flipped, transposed weights as HWIO, the result
    permuted back to NCHW."""
    import torch

    from pixel_embedded_affinity_torch.ops.conv3x3_cuda import conv3x3_fused

    w_hwio = wt.flip(2, 3).permute(2, 3, 0, 1).contiguous()
    ones = torch.ones(wt.shape[1], dtype=torch.float32, device=dy.device)
    out = conv3x3_fused(dy.permute(0, 2, 3, 1).contiguous(), w_hwio, ones, ones * 0, False)
    return out.permute(0, 3, 1, 2).contiguous()


def phase_conv_grad(bbbc_arrays) -> dict:
    """Phase 27: CWg and CXg (csrc/conv_grad.cu) at every conv they serve
    in one full-width float32 training step of each of CG_PRESETS (every
    conv of the U-Nets), on the step's own inputs and output gradients:
    each call CG_REPEATS times, bit for bit, against the plain version in
    float64 within GRAD_RTOL of the largest gradient (the float32 plain
    version's distance, cuDNN's with TF32 off, and its own from float64
    printed); cuDNN's default weight and input gradients CG_REPEATS times,
    to see which vary; each conv shape's time, once a shape (the ResNets
    repeat theirs), by CUDA graph replay with L2 flushed: CWg, CXg, CXg's
    NHWC alternative (3x3: the permutes and K7), cuDNN's default and
    deterministic ``aten.convolution_backward`` and the plain float64
    version. Each row names the path each kernel took (wgmma or, for CWg's
    small convs and shapes with H W % 4 != 0, mma.sync) and its share of
    the bound; each preset's sums print the shares and the ratios to cuDNN's
    default and deterministic backward. Then the mma.sync path at two
    shapes with H W % 4 != 0, against float64 and on repeat. Returns each
    kernel's sums over a step of each preset (cvppp's go on the ``kernels``
    line) and the rows."""
    import torch

    from pixel_embedded_affinity_torch.data.device_data import pack_cvppp_arrays
    from pixel_embedded_affinity_torch.device import float32_convs
    from pixel_embedded_affinity_torch.ops.conv_grad_cuda import (
        conv_dgrad, conv_dgrad_plain, conv_wgrad, conv_wgrad_plain, wgrad_splits)

    def cudnn(dy, x, wt, mask, deterministic=False):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic
        try:
            k = wt.shape[-1]
            return torch.ops.aten.convolution_backward(
                dy, x, wt, None, [1, 1], [k // 2, k // 2], [1, 1], False, [0, 0], 1, mask)
        finally:
            torch.backends.cudnn.deterministic = prev

    cvppp = pack_cvppp_arrays(leaf_pairs(4, 530, 500, SEED))
    data = {"cvppp": cvppp, "bbbc039v1": bbbc_arrays, "cvppp_resnet50": cvppp,
            "cvppp_resnet101": cvppp}
    flush = 2 * 50 * 2 ** 20
    sums, rows = {}, []
    times: dict = {}  # a conv shape's times, taken at its first conv
    time_cols = ("w_ms", "w_lib_ms", "w_lib_det_ms", "w_plain_ms", "x_ms", "x_nhwc_ms",
                 "x_lib_ms", "x_lib_det_ms", "x_plain_ms")
    with float32_convs():
        for preset in CG_PRESETS:
            convs, others = recorded_convs(preset, data[preset])
            check(preset not in CG_UNETS or not others,
                  f"{preset}: convs that keep cuDNN's backward: {others}")
            tot = {k: 0.0 for k in ("w_ms", "x_ms", "x_nhwc_ms", "w_bound", "x_bound",
                                    "w_lib", "w_lib_det", "x_lib", "x_lib_det", "w_plain",
                                    "x_plain", "w_lib_varied", "w_lib_det_varied", "w_ms_varied")}
            err = {"w": 0.0, "x": 0.0, "w_abs": 0.0, "x_abs": 0.0}
            by = {"w": {"bytes": 0.0, "operations": 0.0}, "x": {"bytes": 0.0, "operations": 0.0}}
            varied_w, varied_x, n_x = [], [], 0
            for name, conv, x, dy, need_x in convs:
                wt = conv.weight.detach()
                b, cin, h, w = x.shape
                cout, k = wt.shape[0], wt.shape[-1]
                row = {"preset": preset, "conv": name, "x": list(x.shape),
                       "weight": list(wt.shape), "splits": wgrad_splits(b, cin, cout, h, w, k),
                       "w_path": "wgmma" if cg_wgmma(cin, cout, h, w, k) else "mma.sync",
                       "x_path": "wgmma" if h * w % 4 == 0 else "mma.sync"}
                shape = (tuple(x.shape), tuple(wt.shape), need_x)
                known = times.get(shape)
                if known:
                    row.update(known)
                dws = [conv_wgrad(x, dy, wt.shape) for _ in range(CG_REPEATS)]
                ref32 = conv_wgrad_plain(x, dy, wt.shape)
                ref64 = conv_wgrad_plain(x.double(), dy.double(), wt.shape)
                row["w_err"] = rel_err64(dws[0], ref64)
                row["w_err_f32_plain"] = rel_err64(dws[0], ref32)
                err["w"] = max(err["w"], row["w_err"])
                err["w_abs"] = max(err["w_abs"], float((dws[0].double() - ref64).abs().max()))
                check(all(torch.equal(dws[0], d) for d in dws[1:]),
                      f"{preset} {name}: CWg differs from run to run")
                row["f32_plain_err"] = rel_err64(ref32, ref64)
                check(row["w_err"] <= GRAD_RTOL, f"{preset} {name}: CWg off the plain version "
                                                 f"in float64: {row}")
                lib = [cudnn(dy, x, wt, [False, True, False])[1] for _ in range(CG_REPEATS)]
                row["w_lib_varied"] = not all(torch.equal(lib[0], d) for d in lib[1:])
                row["w_bound"], row["w_bound_by"] = conv_grad_bound(b, cin, cout, h, w, k)
                by["w"][row["w_bound_by"]] += row["w_bound"]
                if not known:
                    x64, dy64 = x.double(), dy.double()
                    row["w_ms"] = graph_ms(lambda: conv_wgrad(x, dy, wt.shape),
                                           flush_bytes=flush)
                    row["w_lib_ms"] = graph_ms(lambda: cudnn(dy, x, wt, [False, True, False]),
                                               flush_bytes=flush)
                    row["w_lib_det_ms"] = graph_ms(
                        lambda: cudnn(dy, x, wt, [False, True, False], True), flush_bytes=flush)
                    row["w_plain_ms"] = graph_ms(lambda: conv_wgrad_plain(x64, dy64, wt.shape),
                                                 n=5, flush_bytes=flush)
                for key, col in (("w_ms", "w_ms"), ("w_bound", "w_bound"), ("w_lib", "w_lib_ms"),
                                 ("w_lib_det", "w_lib_det_ms"), ("w_plain", "w_plain_ms")):
                    tot[key] += row[col]
                if row["w_lib_varied"]:
                    varied_w.append(name)
                    tot["w_lib_varied"] += row["w_lib_ms"]
                    tot["w_lib_det_varied"] += row["w_lib_det_ms"]
                    tot["w_ms_varied"] += row["w_ms"]
                if need_x:
                    n_x += 1
                    dxs = [conv_dgrad(dy, wt) for _ in range(CG_REPEATS)]
                    ref32 = conv_dgrad_plain(dy, wt)
                    ref64 = conv_dgrad_plain(dy.double(), wt.double())
                    row["x_err"] = rel_err64(dxs[0], ref64)
                    row["x_err_f32_plain"] = rel_err64(dxs[0], ref32)
                    err["x"] = max(err["x"], row["x_err"])
                    err["x_abs"] = max(err["x_abs"], float((dxs[0].double() - ref64).abs().max()))
                    check(all(torch.equal(dxs[0], d) for d in dxs[1:]),
                          f"{preset} {name}: CXg differs from run to run")
                    row["x_f32_plain_err"] = rel_err64(ref32, ref64)
                    check(row["x_err"] <= GRAD_RTOL, f"{preset} {name}: CXg off the plain "
                                                     f"version in float64: {row}")
                    lib = [cudnn(dy, x, wt, [True, False, False])[0] for _ in range(CG_REPEATS)]
                    row["x_lib_varied"] = not all(torch.equal(lib[0], d) for d in lib[1:])
                    if row["x_lib_varied"]:
                        varied_x.append(name)
                    row["x_bound"], row["x_bound_by"] = conv_grad_bound(b, cin, cout, h, w, k)
                    by["x"][row["x_bound_by"]] += row["x_bound"]
                    if k == 3:
                        row["x_nhwc_err"] = rel_err64(_nhwc_dgrad(dy, wt), ref64)
                    if not known:
                        row["x_ms"] = graph_ms(lambda: conv_dgrad(dy, wt), flush_bytes=flush)
                        row["x_nhwc_ms"] = (graph_ms(lambda: _nhwc_dgrad(dy, wt),
                                                     flush_bytes=flush)
                                            if k == 3 else row["x_ms"])
                        row["x_lib_ms"] = graph_ms(
                            lambda: cudnn(dy, x, wt, [True, False, False]), flush_bytes=flush)
                        row["x_lib_det_ms"] = graph_ms(
                            lambda: cudnn(dy, x, wt, [True, False, False], True),
                            flush_bytes=flush)
                        wt64 = wt.double()
                        row["x_plain_ms"] = graph_ms(lambda: conv_dgrad_plain(dy64, wt64), n=5,
                                                     flush_bytes=flush)
                    for key, col in (("x_ms", "x_ms"), ("x_nhwc_ms", "x_nhwc_ms"),
                                     ("x_bound", "x_bound"), ("x_lib", "x_lib_ms"),
                                     ("x_lib_det", "x_lib_det_ms"), ("x_plain", "x_plain_ms")):
                        tot[key] += row[col]
                if not known:
                    times[shape] = {c: row[c] for c in time_cols if c in row}
                    times[shape]["times_of"] = f"{preset} {name}"
                row["w_share_of_bound"] = row["w_bound"] / row["w_ms"]
                if need_x:
                    row["x_share_of_bound"] = row["x_bound"] / row["x_ms"]
                print(f"[conv-grad] {json.dumps(row)}")
                rows.append(row)
            del convs
            torch.cuda.empty_cache()
            summary = {"preset": preset, "convs": sum(r["preset"] == preset for r in rows),
                       "dgrad_convs": n_x, "cudnn_backward_convs": others,
                       "cudnn_wgrad_varied": varied_w,
                       "cudnn_dgrad_varied": varied_x, **tot, **err,
                       **{f"{key}_bound_by": max(v, key=v.get) for key, v in by.items()},
                       "w_share_of_bound": tot["w_bound"] / tot["w_ms"],
                       "x_share_of_bound": tot["x_bound"] / tot["x_ms"],
                       "w_against_cudnn": tot["w_ms"] / tot["w_lib"],
                       "w_against_cudnn_det": tot["w_ms"] / tot["w_lib_det"],
                       "x_against_cudnn": tot["x_ms"] / tot["x_lib"],
                       "x_against_cudnn_det": tot["x_ms"] / tot["x_lib_det"]}
            print(f"[conv-grad] {preset} step, ms summed over its convs (graph replay, L2 "
                  f"flushed): {json.dumps(summary)}; {card_line()}")
            sums[preset] = summary
        # the mma.sync kernels at shapes whose H W % 4 != 0 (no main path has
        # one; CXg takes them only there): against float64 and on repeat
        gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
        for b, cin, cout, h, w, k in ((2, 16, 40, 37, 41, 3), (2, 64, 2, 35, 35, 1)):
            x = torch.randn(b, cin, h, w, device="cuda", generator=gen)
            dy = torch.randn(b, cout, h, w, device="cuda", generator=gen)
            wt = torch.randn(cout, cin, k, k, device="cuda", generator=gen)
            dws = [conv_wgrad(x, dy, wt.shape) for _ in range(CG_REPEATS)]
            dxs = [conv_dgrad(dy, wt) for _ in range(CG_REPEATS)]
            errs = (rel_err64(dws[0], conv_wgrad_plain(x.double(), dy.double(), wt.shape)),
                    rel_err64(dxs[0], conv_dgrad_plain(dy.double(), wt.double())))
            same = all(torch.equal(dws[0], d) for d in dws) and all(
                torch.equal(dxs[0], d) for d in dxs)
            print(f"[conv-grad] mma.sync path {(b, cin, cout, h, w, k)}: CWg, CXg within "
                  f"{errs[0]:.3e}, {errs[1]:.3e} of float64, bit-equal on repeat {same}")
            check(max(errs) <= GRAD_RTOL and same,
                  f"the mma.sync path at {(b, cin, cout, h, w, k)}: {errs}, repeat {same}")
    return {"sums": sums, "rows": rows}


def _timed(name: str, fn, *args):
    """fn(*args), its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # 2. build
    _timed("build", phase_build)
    cfg, sd, samples = serving_setup()
    # 3. kernels vs plain, 4. fixture, 5. serving, 6. training
    k1 = _timed("K1f", phase_kernels, main_path_embedding(cfg, sd, samples))
    k1b_err = _timed("K1b", phase_k1_grad)
    k4f = _timed("K4f", phase_k4f)
    wmse = _timed("K2, K3", phase_wmse_kernels)
    _timed("fixture", phase_fixture)
    launches = _timed("serving", phase_main_path, cfg, sd, samples)
    train2d = _timed("training", phase_train)
    train_launches = train2d["launches"]
    # 7. 3D kernels, 8. 3D fixture, 9. 3D serving, 10. 3D training
    k5 = _timed("K5f", phase_kernels_3d)
    grad = _timed("3D train kernels", phase_train_kernels_3d)
    _timed("3D fixture", phase_fixture_3d)
    serve3d = _timed("3D serving", phase_serving_3d)
    train3d = _timed("3D training", phase_train_3d)
    train3d_launches = train3d["launches"]
    # 11. BBBC training, 12. the unfused path, 13. BBBC serving
    arrays, valid = bbbc_setup()
    bbbc = _timed("BBBC training", phase_train_bbbc, arrays, valid)
    unfused = _timed("unfused", phase_unfused_bbbc, arrays, bbbc["batch"], bbbc["state"])
    serve_bbbc = _timed("BBBC serving", phase_serving_bbbc)
    # 14. K7/K9a/K9b, 15. K8, 16. the fast forward
    conv = _timed("K7, K9a, K9b", phase_conv3x3)
    k8 = _timed("K8", phase_s2d_block)
    fast = _timed("fast forward", phase_fast_forward, cfg, sd, samples)
    # 17. the device-resident samplers at the real geometry, 18. P and the probe
    volume = serve3d.pop("volume")
    ema = _timed("samplers", phase_samplers, volume)
    dp_crop = volume[0][tuple(slice(0, n) for n in DP_CROP)].astype(np.float32) / 255.0
    del volume
    p = _timed("P", phase_tile_copy)
    # 19. the quality gates
    quality = _timed("quality", phase_quality)
    # 20. bf16: the WMSE kernels' bf16 forms, training, serving, the BBBC gate
    wmse16 = _timed("bf16 K2, K3", phase_wmse_bf16)
    train16 = _timed("bf16 training", phase_train_bf16, arrays, valid)
    _timed("bf16 serving", phase_serving_bf16, cfg, sd, samples)
    gate16 = _timed("bf16 quality", phase_gate_bf16)
    # 21. the training CLI, SGD, the host samplers
    cli = _timed("training CLI", phase_training_cli)
    # 22. the model families: ResNet-50/101, MALA
    families = _timed("model families", phase_model_families, samples)
    # 23. the host library: the upsampling backward's kernel, losses,
    # decoders, clustering, the montage, FLOPs, a bit-reproducible 3D step
    up = _timed("host library", phase_host_library, train2d, train3d, serve3d.pop("crop"))
    # 24. data parallelism: two gloo ranks on the card, NCCL through the CLI
    dp = _timed("data parallel", phase_data_parallel, dp_crop, arrays)
    # 25. int8 serving (I8c, I8q), its percentile calibration, the serving
    # artifact, DCP
    p25 = _timed("int8, export, dcp", phase_int8_export_dcp, cfg, sd, samples)
    # 26. train.steps_per_call: the step as a CUDA graph against the eager step
    spc = _timed("steps_per_call", phase_steps_per_call, arrays, valid)
    # 27. CWg and CXg at every conv of the 2D float32 training steps
    cg = _timed("conv grads", phase_conv_grad, arrays)
    # 28. kernels line, card, 29. last line
    trained = {k: train_launches.get(k, 0) + bbbc["launches"][k] + unfused[k] + ema.get(k, 0)
               + quality.get(k, 0) + families.get(k, 0) for k in bbbc["launches"]}
    t1 = k1["times"][1]
    kernels = [{
        "name": "affinity2d_fwd", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": (sum(launches.values()) + trained["K1f"] + serve_bbbc["launches"]
                     + fast["launches"]["K1f"] + cli["K1f"] + dp["K1f"] + spc["K1f"]),
        "cli_launches": cli["K1f"], "dp_launches": dp["K1f"], "spc_launches": spc["K1f"],
        "max_abs_err": k1["max_abs_err"], "ms": t1["view"], "event_ms": t1["view_event"],
        "plain_ms": t1["plain_view"], "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"], "library_ms": None}]
    for k, name in WMSE_NAMES.items():
        r = wmse[k]
        kernels.append({
            "name": name, "route": "cuda", "source": WMSE_SOURCE,
            "replaces": WMSE_REPLACES[k], "launches": trained[k] + cli[k] + dp[k] + spc[k],
            "cli_launches": cli[k], "dp_launches": dp[k], "spc_launches": spc[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "event_ms": r["event_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, **wmse16[k], "bf16_launches": train16[k] + gate16[k]})
        if k == "K3b":  # ms: without db, the training steps' form; db_*: with db
            kernels[-1].update({f: r[f] for f in ("db_ms", "db_event_ms", "db_plain_ms",
                                                  "db_bound_ms")})
    kernels.append({
        "name": "affinity3d_fwd", "route": "cuda", "source": K5_SOURCE,
        "replaces": K5_REPLACES,
        "launches": (serve3d["launches"] + train3d_launches["K5f"] + quality["K5f"] + cli["K5f"]
                     + dp["K5f"] + spc["K5f"]),
        "cli_launches": cli["K5f"], "dp_launches": dp["K5f"], "spc_launches": spc["K5f"],
        "max_abs_err": max(k5["max_abs_err"], serve3d["max_abs_err"]), "ms": k5["ms"],
        "event_ms": k5["event_ms"], "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None})
    grad["K5b"]["max_abs_err"] = max(grad["K5b"]["max_abs_err"], k1b_err)
    # the 2D train path's launches of the D = 1 backwards: K1b's, K4b's
    in_2d = {"K5b": trained["K1b"], "K6f": 0, "K6b": trained["K4b"]}
    for k, name in GRAD_NAMES.items():
        r = grad[k]
        kernels.append({
            "name": name, "route": "cuda", "source": GRAD_SOURCE, "replaces": GRAD_REPLACES[k],
            "launches": train3d_launches[k] + in_2d[k] + quality[k] + cli[k] + dp[k] + spc[k],
            "cli_launches": cli[k], "dp_launches": dp[k], "spc_launches": spc[k],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "event_ms": r["event_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None})
        if k != "K5b":  # a channels-last student with each teacher
            kernels[-1]["channels_last_student_ms"] = {
                t: r[f"{t}_ms"] for t in ("ndhwc", "swapped", "view")}
    kernels.append({
        "name": "cross_affinity_fwd_2d", "route": "cuda", "source": GRAD_SOURCE,
        "replaces": K4F_REPLACES, "launches": trained["K4f"] + cli["K4f"] + dp["K4f"] + spc["K4f"],
        "cli_launches": cli["K4f"], "dp_launches": dp["K4f"], "spc_launches": spc["K4f"],
        "max_abs_err": k4f["max_abs_err"],
        "ms": k4f["ms"], "event_ms": k4f["event_ms"], "plain_ms": k4f["plain_ms"],
        "bound_ms": k4f["bound_ms"], "bound_by": k4f["bound_by"], "library_ms": None,
        "swapped_ms": k4f["swapped_ms"]})
    for k, name in CONV_NAMES.items():
        r = conv[k]
        kernels.append({
            "name": name, "route": "cuda", "source": CONV_SOURCE, "replaces": CONV_REPLACES[k],
            "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    kernels.append({
        "name": "s2d_block_fwd", "route": "cuda", "source": K8_SOURCE, "replaces": K8_REPLACES,
        "launches": fast["launches"]["K8"], "max_abs_err": k8["max_abs_err"], "ms": k8["ms"],
        "plain_ms": k8["plain_ms"], "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "library_ms": k8["library_ms"]})
    kernels.append({
        "name": "tile_copy", "route": "cuda", "source": P_SOURCE, "replaces": P_REPLACES,
        "launches": p["launches"], "max_abs_err": p["max_abs_err"], "ms": p["ms"],
        "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"], "bound_by": p["bound_by"],
        "library_ms": p["library_ms"]})
    kernels.append({
        "name": "upsample_bwd", "route": "cuda", "source": UPB_SOURCE,
        "replaces": "none: no TPU kernel; the deterministic backward of the decoders' "
                    "upsampling (models/common.py)",
        "launches": train_launches["UPb"] + train3d_launches["UPb"] + dp["UPb"] + spc["UPb"],
        "dp_launches": dp["UPb"], "spc_launches": spc["UPb"],
        "max_abs_err": up["max_abs_err"], "ms": up["ms"], "event_ms": up["event_ms"],
        "plain_ms": up["plain_ms"], "bound_ms": up["bound_ms"], "bound_by": up["bound_by"],
        "library_ms": up["library_ms"], "bf16_ms": up["bf16_ms"]})
    cvppp = cg["sums"]["cvppp"]
    for name, key, short in (("conv_wgrad", "w", "CWg"), ("conv_dgrad", "x", "CXg")):
        kernels.append({
            "name": name, "route": "cuda", "source": CG_SOURCE, "replaces": CG_REPLACES,
            "launches": (train_launches[short] + bbbc["conv_grad"][short] + families[short]
                         + spc[short]),
            "spc_launches": spc[short], "max_abs_err": cvppp[f"{key}_abs"],
            "max_rel_err": max(r[key] for r in cg["sums"].values()),
            "ms": cvppp[f"{key}_ms"], "plain_ms": cvppp[f"{key}_plain"],
            "bound_ms": cvppp[f"{key}_bound"], "bound_by": cvppp[f"{key}_bound_by"],
            "library_ms": cvppp[f"{key}_lib"], "library_deterministic_ms": cvppp[f"{key}_lib_det"],
            "library": "cuDNN's aten.convolution_backward in float32, TF32 off (default "
                       "algorithms; deterministic ones beside), a yardstick the port never calls",
            **{preset: {f: cg["sums"][preset][f"{key}_{f}"]
                        for f in ("ms", "bound", "lib", "lib_det", "plain")}
               for preset in CG_PRESETS if preset != "cvppp"}})
    kernels[-1]["nhwc_alternative_ms"] = cvppp["x_nhwc_ms"]
    for entry in kernels:
        entry["timed_by"] = "cuda graph replay"
    kernels[-2]["timed_by"] = kernels[-1]["timed_by"] = (
        "cuda graph replay, L2 flushed, summed over the calls of one full-width cvppp float32 "
        "training step (one a conv); the other CG_PRESETS' steps beside")
    kernels[-4]["timed_by"] = "cuda graph replay, 96 calls a graph"
    i8 = p25["kernels"]
    for name, key, replaces in (("conv_i8_fwd", "I8c", I8C_REPLACES),
                                ("quantize_i8", "I8q", I8Q_REPLACES)):
        r = i8[key]
        kernels.append({
            "name": name, "route": "cuda", "source": I8C_SOURCE, "replaces": replaces,
            "launches": p25["launches"][key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "floor_ms": r["floor_ms"],
            "timed_by": f"cuda graph replay, L2 flushed, summed over the "
                        f"{23 if key == 'I8c' else 18} calls of one B=1 float32 int8 forward"})
        if key == "I8c":
            kernels[-1].update(library="cuDNN F.conv2d in bfloat16 (a yardstick the port never "
                                       "calls)", library_f32_ms=r["cudnn_f32_ms"],
                               bound_by_calls=r["bound_by_calls"],
                               library_int_mm_im2col_ms=r["int_mm_im2col_ms"])
        else:
            kernels[-1]["library"] = ("torch.quantize_per_tensor to qint8 (a yardstick the port "
                                      "never calls)")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
