#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernel,kernel_bwd,kernel_conv,kernel_domain,serve,train,train_chained,
                                    serve_per_layer,train_per_layer,kernel_1d,audio,serve_faults,train_gan,
                                    autotune,train_mesh,lm_serve,lm_archs,lm_mesh]

Phases, each printing one JSON line:
  env     torch / CUDA versions, the card's name and power limit; TF32 off.
  build   nvcc builds the kernels in src/repro_torch/kernels/csrc/ (sm_90a):
          fused_engine.cu, fused_engine_bwd.cu, conv_engine.cu,
          domain_engine.cu, engine1d.cu (the three bwd_x kernels share
          bwd_x_core.cuh, the three bwd_w kernels bwd_w_core.cuh, the 1D
          engine fwd_core.cuh).
Each kernel phase also calls each of its wrappers once with a misaligned
contiguous view of one operand that the kernel moves in 16-byte copies: the
call must raise ValueError before any launch, and an aligned launch after it
must still run (no sticky CUDA error).  At one relu shape of each epilogue
source (NAN_CASES: fused_engine.cu's CUDA-core and tensor-core epilogues,
conv_engine.cu, engine1d.cu) the kernel also runs on weights holding NaN
(poison): its output must be NaN exactly where the plain version's is, and
agree with it elsewhere (nan_case).
  kernel  the fused Winograd-DeConv kernel (TPU kernel 3 at the deconv
          corner) against its plain PyTorch version at the four DCGAN layer
          shapes as a generate serves them (batch 8: the CUDA-core kernel)
          and as a train step runs them (batch 128: deconv0-2 on the tensor
          cores, fused_epi_mma_kernel on fwd_core.cuh; deconv3's three
          channels on the CUDA cores), a K4S2, a K3S1 and a K2S3 shape, and a
          ragged K5S2 shape on the tensor cores (batch 127), each also
          checked against conv_transpose2d plus the same epilogue; two
          launches bitwise equal, the instantiation that ran (held to the
          plan's choice) and its bound (the products at the 3xTF32 rate on
          the tensor cores, the fp32 bound beside it), TFLOP/s and error
          share; kernel, plain and library device times (profiler, mean
          of 20 calls) and wall times (CUDA events, median of >= 20 calls).
  kernel_bwd
          the two backward kernels (fused_engine_bwd.cu) against their plain
          versions at the four DCGAN layer shapes at the training batch 128,
          the K4S2, K3S1 and K2S3 shapes above and a ragged K5S2 shape (N, M
          not multiples of the block tile, T not of the chunk, T split);
          bwd_x (TPU kernel 6, bwd_x_core.cuh) and bwd_w (TPU kernel 7,
          bwd_w_core.cuh), on the tensor cores, also against themselves: two
          launches bitwise equal, the instantiation that ran, its bound with
          the products at the 3xTF32 rate where they ran on the tensor cores
          (the fp32 one beside it), and its plan (bwd_x: how its blocks
          spend their tile slots; bwd_w: the T split, the block tile and how
          often it forms each value of xw);
          device, one-call and
          plain times, the bound, and as a yardstick aten's
          convolution_backward of the layer's conv_transpose2d (input grad
          for bwd_x, raw-weight grad for bwd_w).
  kernel_conv
          the three conv-corner kernels (conv_engine.cu: forward, bwd_x,
          bwd_w) against their plain versions at the DCGAN discriminator's
          four layers at batch 128, an odd-extent K4S2, a K3S2 and a K3S1
          shape and a ragged K4S2 shape (N, M not multiples of the block
          tiles, T not of the chunk, T split); bwd_x (TPU kernel 6,
          bwd_x_core.cuh) and bwd_w (TPU kernel 7, bwd_w_core.cuh), on the
          tensor cores, as kernel_bwd holds the deconv corner's: two launches
          bitwise equal, the instantiation that ran and its bound, and their
          plan (bwd_x: its tile slots and the blocks it launches against the
          SMs; bwd_w: split, block tile, xw formed per value); the forward
          (TPU kernel 3, conv_fwd_mma_kernel on fwd_core.cuh at conv1-3 and
          the odd and ragged shapes, its passes split over blocks where the
          grid is small; conv0's RGB input on the fp32 CUDA-core kernel) two
          launches bitwise equal, the instantiation that ran (held to the
          plan's choice at DCGAN's layers), its bound, plan, TFLOP/s and
          error share; device,
          one-call and plain times, the bound, and as yardsticks F.conv2d
          plus the epilogue and aten's convolution_backward (input grad,
          raw-weight grad).
  kernel_domain
          the per-layer path's kernels: the unfused engine and its backward
          (domain_engine.cu: kernels 1, 4, 5) against their plain versions at
          the four DCGAN layer shapes at batch 128, the K4S2, K3S1 and K2S3
          shapes and kernel_bwd's ragged shape, kernel 1 also at the four
          layers at batch 8 (as it serves); the fused engine's scratch mode
          (kernel 2) at the four layers at batch 8 and 128; one FusedPreFn
          and one EngineFn gradient (deconv2, batch 128) against autograd of
          the plain versions; kernels 4 and 5 (on the tensor cores) two
          launches bitwise equal and their bound as kernels 6 and 7's,
          kernel 5 its plan as kernel 7's; device, one-call and plain
          times, the bound, and as
          yardsticks conv_transpose2d (1, 2) and aten's convolution_backward
          (input grad for 4, raw-weight grad for 5).
  serve   DCGAN at its published widths through GanServeEngine (random
          weights from a seed): requests of 1, 3 and 8 images, then a run of
          more; checks the images against the plain-version generator, and
          that the kernel ran exactly 4 times per generate; images/s.
  train   DCGAN at its published widths, batch 128: 3 steps of make_gan_step
          with the generator on the CUDA kernels (cuda_chained, discriminator
          lax) and the same 3 steps on the plain versions (chained_ref) from
          the same params and batches; checks metrics, parameters, the
          non-finite flag, the step-1 gradients (each run's AdamW first
          moment) and 4/4/4 launches of the three kernels per step,
          with none of the backward ones in the discriminator's gradient
          pull.  Step 1 compares on the kernel run's side of each activation
          kink: the kernel run records which side of relu / leaky_relu every
          input took (kink_sides), the plain run takes those sides, and the
          inputs whose sides differ (flips) must lie within the forward
          tolerance of zero in both runs, at most 1e-5 of a call's inputs
          (compare_kinks; the flips and the unmasked share of the step-1
          tolerance are printed as readings).  Step ms, device ms, idle
          share, images/s, peak memory; the profile must show cuDNN
          convolutions (the check's own control) and the forward kernels by
          name (the tensor-core and the CUDA-core instantiation).
  train_chained
          the same with the discriminator on the conv kernels too
          (conv_impl="cuda_chained") against chained_ref on both nets:
          launches per step (4/4/4 and 8/11/12) and per pull, the conv
          launches by layer, no F.conv2d call, and no cuDNN or aten
          convolution kernel in the profile.
  serve_per_layer
          the serve phase's requests through GanServeEngine(chained=False),
          once with "pallas_prepacked" (kernel 1) and once with
          "pallas_fused_pre_prepacked" (kernel 2): images against the
          per-layer plain generator (prepacked_ref), 4 launches of the
          variant's kernel per generate and none of kernel 3; images/s.
  train_per_layer
          the train phase's 3 steps with both nets per layer on the kernels
          (cuda_prepacked: kernels 1, 4, 5 and the conv corner's 3, 6, 7 in
          nhwc mode) against prepacked_ref on both: launches per step
          (4/4/4, none of the deconv corner's 3, 6, 7, and 8/11/12) and per
          pull, no F.conv2d call, no cuDNN or aten convolution kernel in the
          profile; step ms, idle share, images/s, peak memory.
  kernel_1d
          the 1D engine (engine1d.cu: TPU kernels 8 and 9) against its plain
          version in nlc and scratch mode at the audio decoder's three
          layers at full width (256 -> 128 -> 64 -> 1, K4S2, batch 16,
          4096 latent frames), the reference benchmark's conv1d (K4 causal,
          (8, 2048, 256) -> 256) and deconv1d (K4S2, (8, 1024, 128) -> 64), a
          K3S2 OP1 and a K6S3 deconv, a phases=2 scratch shape, and the nlc
          epilogue with each activation (two launches bitwise equal, the
          instantiation that ran and its bound: the tensor cores,
          fwd_core.cuh, at the decoder's deconv0-1); rank-1 kernels 4 and 5
          (domain_engine.cu, m2 = 2) against theirs at the decoder's three
          layers (both also two launches bitwise equal and their bound as
          kernels 6 and 7's, kernel 5 its plan), rank-1 kernel 4 also at the conv1d shape
          above (n2 = 5 positions: the tensor-core instantiation for more
          than 4); device, one-call and plain ms, the bound, and as
          yardsticks conv_transpose1d / conv1d and aten's
          convolution_backward (input grad for 4, raw-weight grad for 5).
  audio   the audio decoder at full width through audio_decoder_apply
          (impl "cuda"), batch 16 and 1, 4096 frames (32768 samples a clip):
          3 launches of the 1D engine per forward and none of any other
          kernel, no plain-version call; the waveform finite, in [-1, 1],
          against impl "ref" and "lax"; the gradient of sum(y^2) against
          "ref" leaf by leaf (1e-3 of each leaf's largest; the plain
          gradient on the kernel run's side of each relu kink, as the train
          phases' step 1), with its
          launches of rank-1 kernels 4 and 5; forward ms, device ms, idle
          share, samples/s, gradient ms, peak memory.
  serve_faults
          the serve stack's failure semantics at DCGAN's published widths
          (random weights from a seed), registered with
          register_prepacked_generator and made resident by name, on the
          reference chaos harness's engine (batch 8, chained, NaN guard, 2
          retries, breaker 3 failures / 150 ms): (A) AsyncGanServer
          (max_queue 64) under open-loop Poisson traffic at 200 requests/s
          for 1 s, sizes 1-8, deadline 100 ms, with FaultPlan(kind="mix",
          rate=0.1, delay_ms=10) and then without (NaN guard on, then off):
          no future hung, submitted = delivered + failed + rejected, every
          failure a GanServeError of a kind the plan explains, NaN-guard
          trips = injected NaN batches, 4 launches of kernel 3 per generate,
          every delivered image against the plain chained generator;
          p50 / p99 end-to-end ms, mean compute ms, images/s; (B) the
          quarantine drill: a persistent raise trips the breaker, a submit
          fast-rejects, a half-open probe through weights holding a NaN is
          refused with kind "nan" (the NaN guard: the kernels' relu keeps
          the NaN, so the batch is not finite) and reopens it, the restored
          weights' probe serves and closes it (params_finite on clean / inf
          / NaN weights); (C) the watchdog drill: the generate loop raises once
          outside the isolation boundary, one restart, its request fails
          "loop_dead", the next four serve; (D) host ms per batch-8
          generate pipelined, with the stream synchronized, and with the
          NaN guard's read: what the sync and the guard cost a dispatch.
  train_gan
          the port's train_gan loop at DCGAN's published widths, batch 128,
          both nets cuda_chained: A a clean run of 16 steps (and A' again),
          B a chaos run checkpointing every 4 steps into a fresh directory
          under TRAIN_GAN_PLAN (raise at 5, NaN batch at 9, a truncated
          checkpoint at 10, raise at 11, preempt at 14), C a run resuming
          B's directory; B's and C's counters, fault log, injected faults
          and final step must be the reference's (TRAIN_GAN_EXPECTED), C's
          metrics history and final params A's bit for bit, the NaN batch's
          metrics non-finite, and kernels 3/6/7 4/4/4 and the conv corner's
          8/11/12 per step call; loop ms per step with the sentinel on and
          off against a bare make_gan_step loop (medians of three rounds in
          turns), checkpoint bytes, save ms
          (device-to-host, sha256, write and fsync), restore and verify ms,
          peak memory.
  autotune
          kernels/autotune.py at DCGAN's published widths: autotune_deconv over
          the generator's four layers at batch 128 with the gradient (in the
          weights and the input: both backward kernels) and at batch 8
          forward, each for the unfused (kernels 1, 4, 5) and the fused pre-PE
          engine (kernels 2, 6, 7); autotune_conv over the discriminator's
          conv0-3 at batch 128 with the gradient, with the epilogue and
          emit-cells axes; autotune_conv1d over the audio decoder's three
          layers at batch 16 and 1.  Each layer's candidates vary one axis
          each: every instantiation of each kernel it launches
          (engine.INSTANTIATIONS), the split counts 1, 2, 4; the library
          baseline (cfg None) beside them.  Before any timing: at every shape
          the layer's launches take, each instantiation and split is taken by
          the engine's table exactly where its C plan takes it
          (table_checks); each candidate the table takes is held against the
          plain version (forward 1e-4 * max + 5e-5, loss 1e-4 relative,
          gradient 1e-4 * max + 1e-5), its profile must show every
          instantiation it names (INSTANTIATION_KERNELS), and one that
          forces a split runs twice bitwise equal; one the table refuses is
          an ok=False row.  Then autotune_* times all in two rounds
          (each the best of 5 calls); a row prints each candidate's ms, the
          plan's choice and ms, the fastest other launch and its margin, the
          library's ms and the spreads.  Then install_tuned_blocks for
          cuda_prepacked at batch 128 (grad), the discriminator's winners by
          set_deconv_blocks, and train_tuned: the train_per_layer phase's
          3 steps and checks on the tuned table (no tolerance moved); a
          batch-8 generate of GanServeEngine(chained=False) with the table
          against prepacked_ref, timed against the same generate without the
          table in turns (the key holds no batch); the table cleared after.
  train_mesh
          parallel/ on torch.distributed at DCGAN's published widths, batch
          128 global, both nets cuda_chained, fp32, TF32 off, random weights
          from a seed (train_chained's).  Every sharded run is held against
          train_chained's single-device kernel step: as a trajectory (step
          1's metrics 1e-3 relative, int8 the reference's 2e-2; the params
          after 3 steps 6·lr, uncompressed) and step by step from one state
          (each step from the run's own gathered params and optimizer state
          against the single-device step from the same: metrics 1e-3
          relative and params 6·lr, int8 losses 2e-2 and params 5e-3);
          later steps' trajectory metrics and every leaf's largest
          difference are printed.  The int8 step's step-1 reduced gradient
          plus the ranks' mean residual must be the uncompressed one (error
          feedback's identity, 1e-5 of each bucket's largest).  (1) World 1
          on NCCL in this process, mesh (1,) ("data",): 3 steps each of the
          mesh step, the overlap step at the default bucket size (4
          generator buckets) and at 16 MiB (2), and the int8 step; kernels
          3/6/7 4/4/4 and the conv corner's 8/11/12 a step; the NCCL kernels
          and copies the overlap step's profile shows; each step's ms
          against the single-device step's in this call.  (2) Worlds of 2
          ((2,) ("data",): 64 images a rank) and 4 ((2, 2) ("data",
          "model")), spawned with torch.multiprocessing, every rank on
          cuda:0, gloo with CUDA tensors (no host staging): 3 overlap steps
          with each rank's launches counted (4/4/4 and 8/11/12 a step), then
          the overlap and the int8 step held as above; at world 2 step 1's
          reduced gradients against the plain single-device step on the
          kernel run's side of each kink (the ranks' kink records merged
          over the batch), the step ms, the opening gather's ms, each
          bucket's all-reduce ms, the wire report (bytes a step).  (3)
          train_gan on the world-2 mesh: 4 steps, a checkpoint every 2: A
          clean, B with a raise at step 3 (restores step 2 and replays), C
          resuming B's step-2 checkpoint: B and C end on A's bits, launches
          4/4/4 and 8/11/12 a step call; B's checkpoint restored onto the
          mesh with shardings= (each rank's blocks the full leaves'), and
          resumed on one device without a mesh: held against A as (1).  (4)
          serve_mesh, sharded residency on the world-2 mesh: DCGAN at its
          published widths (the serve phase's params), chained, batch 8,
          GanServeEngine(mesh=): each rank holds its blocks of the packed
          weights and gathers them a generate; its images against the
          single-device engine's at atol 1e-5 / rtol 1e-4, 4 launches of
          kernel 3 a generate on each rank; a rank's bytes at rest against
          the whole tree's, the generate's and the gather's ms.  One
          card: the worlds share it, so the figures show correctness and the
          machinery's cost, not scaling.
  lm_serve
          Mamba2-780m at its published size (48 layers, d_model 1536, d_inner
          3072 in 48 heads of 64, d_state 128, d_conv 4, chunk 256, vocab
          50280; fp32, random weights from a seed) through ServeEngine: 4
          slots, prompt_len 256, max_len 512, 8 requests of 16 new tokens
          with prompts from lm_batch, once with the prefill conv "direct"
          and once on "engine" (kernel 9, engine1d.cu in nlc mode): 3 x 48
          launches of kernel 9 a prefill on "engine", none on "direct", and
          none of any other kernel.  First the one-layer _causal_conv at the
          model's shapes (C = 3072 and 128, T = 256, batch 1 and 4) against
          its plain version (the plain 1D engine) and "direct", atol 5e-5 /
          rtol 1e-4, and its gradient (kernels 9 / 4 / 5) at 1e-4 * max +
          1e-5; the wrapper's device ms a launch, plain and library
          (dense and depthwise conv1d) ms and its 3xTF32 bound at each
          shape.  The engine run is teacher-forced on the direct run's
          tokens: every prefill's and decode step's logits within
          LM_LOGIT_GAIN * 144 * LM_CONV_EPS * max|logits| + 1e-5 of the
          direct run's (LM_CONV_EPS: the conv checks' largest relative
          error on the first full runs, which this run's must not exceed),
          and the greedy tokens equal wherever
          the direct run's top-2 margin exceeds twice the largest logit
          error measured.  Prefill ms a request (direct, engine), kernel 9's
          device ms in a profiled engine prefill, decode ms a step with 4
          slots at their own positions and tokens/s, peak memory.
  lm_archs
          the nine other LM archs at smoke_config on the card (MoE at
          no-drop capacity): a decode of token T - 1 after a prefill of
          T - 1 tokens against the full prefill's logits, atol 2e-4 / rtol
          2e-3 (test_arch_smoke.py's check), no kernel launched.
  lm_mesh the LM stack on a mesh (launch/steps.py::build_lm_step), random
          weights from a seed, TF32 off; every spawned world's ranks share
          the card over gloo (CUDA tensors; the expert-parallel all-to-all
          staged through the host), world 1 runs on NCCL in this process.
          The single-device runs each is held to come first, the card freed
          after them.  (1) prefill: Mamba2-780m at its published size (fp32)
          on world 2 (2, 1), 2 prompts of 256 tokens (prefill_32k's 32 x
          32768 cut), its conv on "engine": each rank's logits and every
          leaf of its cache block against the single-device prefill of both
          prompts within lm_serve's logit tolerance (relative to the largest
          magnitude), 144 launches of kernel 9 a rank (the main path: counts
          at 0 just before, read just after); prefill and gather ms.  (2)
          train: phi3-mini-3.8b at its published widths, 4 of 32 layers
          (0.650 G parameters, fp32), batch 4 x 512 (train_4k's 256 x 4096
          cut), 3 steps of AdamW (lr 3e-4, clip 1.0) on world 1 (NCCL) and
          world 2, each step held from one shared state against the
          single-device step (this rank's block of it): loss 1e-3 and the
          global gradient norm 1e-4 relative, parameters 6·lr; each step's
          gather, forward and backward, all-reduce and update ms, the
          single-device step's ms, the bytes a rank holds.  On (2, 2):
          jamba-v0.1-52b at smoke_config with its conv on "engine", one step
          counted (kernel 9, rank-1 kernels 4 and 5 a rank and step; the
          main path), finite; mixtral-8x22b at smoke_config and capacity
          factor 1.0: the step drops assignments and equals the
          single-device step as above.  (3) ep: mixtral's MoE with one
          expert a rank on (4, 1): moe_apply_ep's forward against moe_apply
          on each source shard's rows (atol 1e-5 / rtol 1e-4), one EP train
          step finite.  (4) decode: gemma3-12b at its published widths, one
          super-block (5 local + 1 global layers, 2.334 G parameters), over
          long_500k's 524288-position cache filled from a seed to cache_len
          524283, batch 1, sequence-sharded over world 2 (build_lm_step's
          long_500k cell): 4 steps against the single-device decode_step
          from the same cache, in bf16 (the reference's PARAM_DTYPE;
          max|err| <= 2^-5 max|logits|: the two attentions round the
          probabilities differently by design) and in fp32 (1e-3); step and
          gather ms, the bytes a rank holds.  The phase's seconds.
  kernels one summary line per kernel (launches on each serving and training
          path, as that phase's run counted them, null for a phase that did
          not run; error, times, the least time the card could take; for the
          conv corner, the per-layer times weighted by the launches by layer
          that train_chained counted, and each kernel's device ms in that
          step's profile).
Each phase's seconds are printed after it.
Then the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises and exits non-zero
without that line; without a CUDA device, or without the package beside
this script, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/fused_engine.cu"
REPLACES = "src/repro/kernels/engine.py:817"  # fused_engine's epilogue pallas_call
SOURCE_BWD = "src/repro_torch/kernels/csrc/fused_engine_bwd.cu"
REPLACES_BWD_X = "src/repro/kernels/engine.py:1291"  # fused_engine_bwd_x's pallas_call
REPLACES_BWD_W = "src/repro/kernels/engine.py:1427"  # fused_engine_bwd_w's pallas_call
SOURCE_CONV = "src/repro_torch/kernels/csrc/conv_engine.cu"  # the three at the conv corner
SOURCE_DOM = "src/repro_torch/kernels/csrc/domain_engine.cu"  # kernels 1, 4, 5
REPLACES_DOM = "src/repro/kernels/engine.py:381"  # domain_engine's pallas_call
REPLACES_DOM_X = "src/repro/kernels/engine.py:995"  # domain_engine_bwd_x's pallas_call
REPLACES_DOM_W = "src/repro/kernels/engine.py:1085"  # domain_engine_bwd_w's pallas_call
REPLACES_SCRATCH = "src/repro/kernels/engine.py:739"  # fused_engine's scratch pallas_call (in SOURCE)
SOURCE_1D = "src/repro_torch/kernels/csrc/engine1d.cu"  # kernels 8 and 9
REPLACES_1D_NLC = "src/repro/kernels/engine.py:1724"  # winograd_conv1d_fused_engine's nlc pallas_call
REPLACES_1D_SCRATCH = "src/repro/kernels/engine.py:1690"  # its scratch pallas_call
PHASES = ("kernel", "kernel_bwd", "kernel_conv", "kernel_domain", "serve", "train", "train_chained",
          "serve_per_layer", "train_per_layer", "kernel_1d", "audio", "serve_faults", "train_gan", "autotune",
          "train_mesh", "lm_serve", "lm_archs", "lm_mesh")
TRAIN_BATCH = 128  # the DCGAN paper's mini-batch
# K5S2 at batch 7, 11x11 input, 100 -> 36 channels: name, (kernel, stride, padding, output_padding), B, H, N, M
RAGGED_SHAPE = ("ragged", (5, 2, 2, 1), 7, 11, 100, 36)
# the conv corner's: K4S2 at batch 7, 11x11 input, 100 -> 36 channels (T = 63 tiles): name, K, S, B, H, W,
# N, M, emit_cells, activation, affine
CONV_RAGGED_SHAPE = ("k4s2_ragged", 4, 2, 7, 11, 11, 100, 36, True, "relu", True)
# the relu shapes of each epilogue source (fused_engine.cu on the CUDA cores and the tensor cores, conv_engine.cu,
# engine1d.cu) that also run with NaN weights (poison, nan_case)
NAN_CASES = ("dcgan.deconv0", "ragged.fwd", "k3s2", "epilogue.relu")
AUDIO_BATCH, AUDIO_FRAMES, AUDIO_WIDTH = 16, 4096, 64  # the audio decoder's cell: 16 clips of 4096 latent frames
# each row of the kernels line -> (its wrapper in repro_torch.kernels.engine,
# the attribute that counts its launches)
COUNTERS = {
    "fused_engine_epi": ("fused_engine", "launches"),
    "fused_engine_bwd_x": ("fused_engine_bwd_x", "launches"),
    "fused_engine_bwd_w": ("fused_engine_bwd_w", "launches"),
    "conv_engine_fwd": ("conv_fused_engine", "launches"),
    "conv_engine_bwd_x": ("conv_fused_engine_bwd_x", "launches"),
    "conv_engine_bwd_w": ("conv_fused_engine_bwd_w", "launches"),
    "domain_engine": ("domain_engine", "launches"),
    "domain_engine_bwd_x": ("domain_engine_bwd_x", "launches"),
    "domain_engine_bwd_w": ("domain_engine_bwd_w", "launches"),
    "fused_engine_scratch": ("fused_engine", "scratch_launches"),
    "engine1d_nlc": ("winograd_conv1d_fused_engine", "launches"),
    "engine1d_scratch": ("winograd_conv1d_fused_engine", "scratch_launches"),
    "domain_engine_bwd_x_rank1": ("domain_engine_bwd_x", "rank1_launches"),
    "domain_engine_bwd_w_rank1": ("domain_engine_bwd_w", "rank1_launches"),
}

# (fp32 FLOP/s outside the tensor cores, HBM bytes/s, fp32-accurate products
# on the tensor cores: dense TF32 / 3, as 3xTF32 issues three TF32 products
# for each) from NVIDIA's data sheets
PEAKS = {
    "PCIe": (51.2e12, 2.0e12, 378e12 / 3),
    "NVL": (60.0e12, 3.9e12, 417.5e12 / 3),
    "SXM": (66.9e12, 3.35e12, 495e12 / 3),
}
# the kernels redesigned for the tensor cores, and each one's fp32 CUDA-core
# instantiation for few or ragged channels, as the profiler names them
# (kernel_named tells them apart)
BWD_X_KERNELS = ("bwd_x_kernel", "bwd_x_mma_kernel")
DOMAIN_BWD_X_KERNELS = ("domain_bwd_x_kernel", "domain_bwd_x_mma_kernel")
CONV_BWD_X_KERNELS = ("conv_bwd_x_kernel", "conv_bwd_x_mma_kernel")
BWD_W_KERNELS = ("bwd_w_kernel", "bwd_w_mma_kernel")
DOMAIN_BWD_W_KERNELS = ("domain_bwd_w_kernel", "domain_bwd_w_mma_kernel")
CONV_BWD_W_KERNELS = ("conv_bwd_w_kernel", "conv_bwd_w_mma_kernel")
ENGINE1D_KERNELS = ("engine1d_kernel", "engine1d_mma_kernel")
FWD_KERNELS = ("fused_epi_kernel", "fused_epi_mma_kernel")  # TPU kernels 2 and 3 at the deconv corner
# TPU kernel 1 (domain_engine.cu's forward): the CUDA-core kernel, the tensor-core kernel and the weight pack
# that feeds it, the few-channel kernel
DOMAIN_FWD_MMA = ("domain_fwd_mma_kernel", "domain_fwd_pack_kernel")
DOMAIN_FWD_KERNELS = ("domain_fwd_kernel", *DOMAIN_FWD_MMA, "domain_fwd_few_kernel")
CONV_FWD_KERNELS = ("conv_fwd_kernel", "conv_fwd_mma_kernel")
CONV_KERNELS = {"fwd": CONV_FWD_KERNELS, "bwd_x": CONV_BWD_X_KERNELS, "bwd_w": CONV_BWD_W_KERNELS}
# every 2D engine kernel a train step can launch
STEP_KERNELS = (*FWD_KERNELS, *BWD_X_KERNELS, *BWD_W_KERNELS, *CONV_FWD_KERNELS, *CONV_BWD_X_KERNELS,
                *CONV_BWD_W_KERNELS, *DOMAIN_FWD_KERNELS, *DOMAIN_BWD_X_KERNELS, *DOMAIN_BWD_W_KERNELS)


def kernel_named(key: str, names) -> bool:
    """Whether the profiler's kernel name ``key`` is one of ``names`` (a
    name or a tuple of names): that kernel, a template instantiation of it
    or not, and never another kernel whose name merely contains it (the
    conv corner's ``conv_bwd_x_kernel`` is not the deconv corner's
    ``bwd_x_kernel``).  The port's kernels sit in an anonymous namespace:
    ``void (anonymous namespace)::bwd_x_mma_kernel<...>(...)``."""
    names = (names,) if isinstance(names, str) else names
    return any(f"::{n}<" in key or f"::{n}(" in key for n in names)


def zero_counts() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels import engine

    for fn, attr in COUNTERS.values():
        setattr(getattr(engine, fn), attr, 0)


def read_counts() -> dict:
    """Every kernel's launch count, by its row in the kernels line."""
    from repro_torch.kernels import engine

    return {row: getattr(getattr(engine, fn), attr) for row, (fn, attr) in COUNTERS.items()}


def check_counts(where: str, got: dict, want: dict) -> None:
    """Fail unless the kernels in ``want`` launched as often as it says and
    every other kernel not at all."""
    if got != {row: want.get(row, 0) for row in COUNTERS}:
        fail(f"{where}: launches {got}, want {want} and 0 of every other kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def fold_adds(inv, groups, backward: bool = False) -> int:
    """Least adds per tile and output channel that the inverse transform
    needs, F(2,3): ``inv`` (C, 4) holds 0 or +-1, so each term is one add.
    Forward, per group of packed positions that share an output tile (a
    sub-filter; at the conv corner all C): the smaller of the direct sum
    through ``inv`` and A^T Y A on the 4x4 sum (24 adds; positions that
    share a Winograd position sum in the contraction's own chain).
    Backward, gw from g: the smaller of the direct rows and A g A^T (12
    adds, then fanned out)."""
    import numpy as np

    nz = np.asarray(inv) != 0
    total = 0
    for lo, hi in groups:
        terms = nz[lo:hi].sum(axis=1 if backward else 0)
        total += min(int(np.maximum(terms - 1, 0).sum()), 12 if backward else 24)
    return total


def overlap_adds(B: int, phases: int, N: int, ty: int, tx: int) -> int:
    """Adds of bwd_x's overlap sum: a cell's m x m values of each phase and
    channel gather one piece from each of the (up to 2 x 2) tiles whose
    4 x 4 windows cover it; ty*tx tiles give 4*ty*tx pieces to
    (ty+1)*(tx+1) cells."""
    return B * phases * 4 * N * max(0, 4 * ty * tx - (ty + 1) * (tx + 1))


def transform_ops_1d(mat) -> int:
    """Least operations of applying ``mat`` (rows of a 1D transform) to one
    vector: per row, an add for each nonzero after the first and a multiply
    for each nonzero that is not +-1."""
    import numpy as np

    mat = np.asarray(mat, dtype=np.float64)
    nz = mat != 0
    return int(np.maximum(nz.sum(axis=1) - 1, 0).sum() + (nz & (np.abs(mat) != 1)).sum())


def fold_ops_1d(inv, groups, backward: bool = False) -> int:
    """Least operations of the rank-1 inverse transform per tile and output
    channel: forward, each sub-filter's m outputs from its packed products
    (``transform_ops_1d`` of inv[lo:hi]^T); backward, gw of every packed
    position from its sub-filter's m cotangents (of inv's rows)."""
    import numpy as np

    inv = np.asarray(inv, dtype=np.float64)
    return sum(transform_ops_1d(inv[lo:hi] if backward else inv[lo:hi].T) for lo, hi in groups if hi > lo)


def mma_bound(n_bytes: int, n_ops: int, products: int, instantiation, peaks, tensor_cores=None) -> dict:
    """The bound of a redesigned bwd_x row.  Where the instantiation that ran
    is the tensor-core one (``*_mma_kernel``), its products run in 3xTF32:
    the bound is the largest of the bytes' time, the products' at the 3xTF32
    rate and the other operations' (folds, transforms, sums) at the fp32
    rate; it can only be tighter than the fp32 CUDA-core bound, kept as
    ``bound_fp32_ms``.  Elsewhere (few or ragged channels on the CUDA cores)
    the fp32 bound stands.  ``tensor_cores=True`` takes the 3xTF32 bound
    whatever ran: for a shape that has a tensor-core instantiation, where
    the plan's choice of the CUDA cores must not lower the card's peak.
    ``bound_ops_ms`` is the operations' side."""
    flops_peak, bytes_peak, tc_peak = peaks
    t_bytes, t_fp32 = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
    t_ops = t_fp32
    if tensor_cores or (tensor_cores is None and any("_mma_kernel" in k for k in instantiation)):
        t_ops = max(1e3 * products / tc_peak, 1e3 * (n_ops - products) / flops_peak)
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_ops_ms=t_ops, bound_fp32_ms=max(t_bytes, t_fp32), instantiation=list(instantiation))


def bitwise_repeat(what: str, run, got) -> None:
    """Fail unless a second launch on the same inputs gives ``got`` bit for bit."""
    import torch

    again = run()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        fail(f"{what}: two launches on the same inputs differ (max |diff| {(again - got).abs().max().item():.3e})")


def poison(ww, n: int = 3, m: int = 1):
    """A copy of the packed weights ``ww`` (C, N, M) with input channel n of
    output channel m NaN at every packed position, so every output of
    channel m is NaN before the epilogue's activation in the kernel and in
    its plain version alike (the serve drill's poisoned weight, at every
    position).  NaN in the input activations instead would not do: the
    kernels' input transforms add only the terms their B^T entries keep,
    where the plain versions' einsum also multiplies the zeros (0 * NaN =
    NaN), so a NaN there reaches more outputs of the plain version."""
    ww = ww.clone()
    ww[:, n, m] = float("nan")
    return ww


def nan_case(what: str, run, plain) -> dict:
    """Fail unless the kernel's output on an input holding NaN has NaN
    exactly where the plain version's has (the epilogue's relu keeps NaN,
    as ``torch.clamp_min`` does) and agrees with it elsewhere within the
    forward tolerance."""
    import torch

    got = run()
    torch.cuda.synchronize()
    want = plain()
    nan_k, nan_p = torch.isnan(got), torch.isnan(want)
    if not bool(nan_p.any()):
        fail(f"{what}: the NaN input reaches no output of the plain version")
    if not torch.equal(nan_k, nan_p):
        fail(f"{what}: NaN at {int(nan_k.sum())} outputs of the kernel, {int(nan_p.sum())} of the plain version "
             f"({int((nan_k & nan_p).sum())} shared)")
    fin = ~nan_p
    err = (got[fin] - want[fin]).abs().max().item()
    tol = 1e-4 * want[fin].abs().max().item() + 1e-5
    if not err <= tol:
        fail(f"{what}: max|err| {err:.3e} > {tol:.3e} off the NaN outputs")
    return dict(name=what, nan_outputs=int(nan_p.sum()), outputs=want.numel(), max_abs_err=err, tol=tol)


def bwd_w_plan(tile, splits: int, C: int, S2: int, M: int) -> dict:
    """A bwd_w row's plan: its T split and block tile (BN x BM channels, BT
    tiles a chunk, from the library's plan) and how often the kernel forms
    each value of xw that it reads: the tensor-core kernel forms only its
    own packed position's Winograd position, once per M tile, so C/16 *
    M tiles; the CUDA-core kernel forms all 16 positions once per
    (sub-filter, M tile), S^2 * M tiles.  (Kernel 5 reads xw from memory: the
    same factor counts its reads.)"""
    BN, BM, BT, mma = tile
    m_tiles = -(-M // BM)
    return dict(splits=splits, BN=BN, BM=BM, BT=BT, tensor_cores=bool(mma),
                xw_per_value=C * m_tiles / 16 if mma else S2 * m_tiles)


def misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (``buf[1:]`` of a fresh buffer), as a caller's offset view
    would."""
    import torch

    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[1 : 1 + t.numel()].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0 or not view.is_contiguous():
        fail("could not build a misaligned contiguous view")
    return view


def refuses_misaligned(what: str, run_misaligned, run) -> dict:
    """Fail unless the wrapper call ``run_misaligned`` (one operand a
    misaligned contiguous view) raises ValueError before any launch, and
    the aligned call ``run`` after it still launches and finishes: a
    misaligned 16-byte copy would have left a sticky CUDA error."""
    import torch

    before = read_counts()
    try:
        run_misaligned()
    except ValueError as e:
        refusal = str(e)
    else:
        torch.cuda.synchronize()
        fail(f"{what}: a misaligned operand was not refused")
    if read_counts() != before:
        fail(f"{what}: the refused call counted a launch")
    out = run()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail(f"{what}: the launch after the refusal gave non-finite values")
    return dict(wrapper=what, refusal=refusal)


def bwd_x_block_use(B: int, gy: int, gx: int, ty: int, tx: int, R: int, W: int, TC: int, BT: int) -> dict:
    """How a bwd_x kernel's cell blocks spend their tile slots (the kernels'
    own geometry, bwd_x_core.cuh::CellBlock): the share of the computed
    tiles that a block above also computes (the recomputed halo row), and the
    share of all slots that hold no needed tile (halo and empty slots)."""
    nrb, ncb = -(-(B * gy) // R), -(-gx // W)
    computed = 0
    for rb in range(nrb):
        rho0, rho1 = rb * R, min(rb * R + R, B * gy)
        taus = [b * ty + j for rho in range(rho0, rho1) for b, r in [divmod(rho, gy)]
                for j in range(max(r - 1, 0), min(r, ty - 1) + 1)]
        rows = max(taus) - min(taus) + 1 if taus else 0
        for cb in range(ncb):
            c0, c1 = cb * W, min(cb * W + W, gx)
            computed += rows * max(0, min(c1 - 1, tx - 1) - max(c0 - 1, 0) + 1)
    T = B * ty * tx
    return dict(blocks=nrb * ncb, recomputed_share=1 - T / computed, idle_slot_share=1 - T / (nrb * ncb * BT))


def wall_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """CUDA-event time of ``reps`` back-to-back calls, per call (ms): what a
    caller waits, host overhead included where the host is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def event_median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median over ``reps`` single calls of the CUDA-event time around one
    call (ms), after a warm-up: one isolated call, host overhead included."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profiled_ms(fn, reps: int = 10, warmup: int = 3, name="", what: str = ""):
    """One profiled run of ``reps`` back-to-back calls: (wall ms per call from
    CUDA events around the run, device ms per call from the profiler, device
    ms per call of the kernels whose name contains ``name`` (or one of a
    tuple of names), device ms per call of each kernel by name).  The device time is taken inside the wall
    time it is compared with.  A session that records no device time (or
    none for ``name``) is run again after a pause, up to five sessions in
    all, and then fails: the tracer has been seen to drop a whole session's
    events, once those of three sessions of one call in a row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(0.2 * attempt)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        total = sum(e.device_time_total for e in evs)
        named = sum(e.device_time_total for e in evs if name and kernel_named(e.key, name))
        if total > 0 and (named > 0 or not name):
            break
        emit({"note": f"profiler session {attempt + 1} recorded no device time",
              "for": what or name or "(all kernels)"})
    else:
        fail(f"the profiler recorded no device time for {what or name or 'any kernel'} in 5 sessions")
    by_kernel = {e.key: e.device_time_total / reps / 1e3 for e in evs if e.device_time_total > 0}
    return a.elapsed_time(b) / reps, total / reps / 1e3, named / reps / 1e3, by_kernel


def host_ops_ms(fn, reps: int = 10, top: int = 8) -> dict:
    """Host milliseconds per call of the ``top`` PyTorch ops by self CPU time
    in one profiled run of ``reps`` calls (no device activity recorded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(reps):
            fn()
    evs = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return {e.key: e.self_cpu_time_total / reps / 1e3 for e in evs}


def ran_on(what: str, instantiation, tensor_cores: bool) -> None:
    """Fail unless the profiled ``instantiation`` is the tensor-core kernel
    (``*_mma_kernel``) exactly where ``tensor_cores``: the plans' choices the
    smoke holds (the grids that fill the card; few channels and the serving
    batches on the CUDA cores)."""
    if any("_mma_kernel" in k for k in instantiation) != tensor_cores or not instantiation:
        fail(f"{what} ran {list(instantiation)}, want the {'tensor-core' if tensor_cores else 'CUDA-core'} kernel")


def kernel_phase(torch, peaks):
    """TPU kernels 3 (nhwc / cells) at the deconv corner, fused_engine.cu,
    against the plain version and conv_transpose2d plus the epilogue: at
    DCGAN's four layers as one generate serves them (batch 8, the CUDA-core
    kernel) and as a train step runs them (batch 128: deconv0-2 emit raw
    cells, on the tensor cores; deconv3's three channels on the CUDA
    cores), at a K4S2, a K3S1 and a K2S3 shape, and at a ragged K5S2 shape
    on the tensor cores (N, M not multiples of the tiles, T not of the
    block).  Each row: two launches bitwise equal, the instantiation that ran,
    its bound (mma_bound), TFLOP/s and error share."""
    import torch.nn.functional as F

    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref
    from repro_torch.models.gan import _cells_to_image

    K5, K4, K3, K2S3 = DeconvDims(5, 2, 2, 1), DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    # name, dims, B, H, N, M, gy (None: the layer's own cells), emit_cells, activation, affine, tensor cores
    shapes = [
        ("dcgan.deconv0", K5, 8, 4, 1024, 512, None, True, "relu", True, False),
        ("dcgan.deconv1", K5, 8, 8, 512, 256, None, True, "relu", True, False),
        ("dcgan.deconv2", K5, 8, 16, 256, 128, None, True, "relu", True, False),
        ("dcgan.deconv3", K5, 8, 32, 128, 3, None, False, "tanh", False, False),
        *[(name + ".train", dims, B, H, N, M, gy, emit, act, False, M >= 16)
          for name, dims, B, H, N, M, gy, emit, act in _dcgan_train_shapes()],
        ("k4s2", K4, 8, 8, 256, 128, None, True, "leaky_relu", True, False),
        ("k3s1", K3, 8, 32, 64, 3, None, False, "tanh", False, False),
        ("k2s3", K2S3, 2, 8, 32, 16, None, False, "relu", True, False),
        # the tensor-core kernel's edges: T = 4572 tiles (not a multiple of 64), N = 100 (a ragged k-step), M = 36
        ("ragged.fwd", DeconvDims(*RAGGED_SHAPE[1]), 127, *RAGGED_SHAPE[3:], None, True, "relu", True, True),
    ]
    dev = torch.cuda.current_device()
    rows = []
    for i, (name, dims, B, H, N, M, gy, emit_cells, act, affine, tc) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        scale = (1.0 + 0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        bias = (0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        packed = ops.prepack(w, dims)
        cells = ops.cells_from_image(x, dims)
        if gy is not None and cells.shape[1] < gy:  # the pass-through cells of a chained layer are larger
            cells = F.pad(cells, (0, 0, 0, 0, 0, gy - cells.shape[2], 0, gy - cells.shape[1])).contiguous()
        kw = dict(epilogue=act, scale=scale, bias=bias, emit_cells=emit_cells)
        run = lambda backend: ops.winograd_deconv2d_cells(cells, packed, dims, (H, H), backend=backend, **kw)  # noqa: E731
        got = run("cuda")
        torch.cuda.synchronize()
        want = run("ref")
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")
        bitwise_repeat(f"forward at {name}", lambda: run("cuda"), got)
        if name in NAN_CASES:  # NaN weights, through the relu epilogue of each instantiation
            packed_nan = packed._replace(ww=poison(packed.ww))
            nan_run = lambda backend: ops.winograd_deconv2d_cells(  # noqa: E731
                cells, packed_nan, dims, (H, H), backend=backend, **kw)
            emit({"phase": "kernel", "nan_case": nan_case(f"fused_engine at {name}", lambda: nan_run("cuda"),
                                                          lambda: nan_run("ref"))})
        if i == 0:  # the wrapper refuses a misaligned operand, and launches again after it
            emit({"phase": "kernel", "misaligned_refusals": [refuses_misaligned(
                "fused_engine", lambda: ops.winograd_deconv2d_cells(misaligned(cells), packed, dims, (H, H), **kw),
                lambda: run("cuda"))]})

        HO = dims.out_size(H)
        wt = w.permute(2, 3, 0, 1).contiguous()
        xc = x.permute(0, 3, 1, 2).contiguous()

        def library():
            y = F.conv_transpose2d(xc, wt, stride=dims.stride, padding=dims.padding,
                                   output_padding=dims.output_padding)
            return epilogue_apply_ref(y.permute(0, 2, 3, 1), scale, bias, act)

        lib_img = library()
        got_img = _cells_to_image(got, (HO, HO), dims.padding) if emit_cells else got
        lib_err = (got_img - lib_img).abs().max().item()
        lib_tol = 1e-4 * lib_img.abs().max().item() + 1e-5
        if not lib_err <= lib_tol:
            fail(f"kernel vs conv_transpose2d at {name}: max|err| {lib_err:.3e} > {lib_tol:.3e}")

        _, _, ms, by_kernel = profiled_ms(lambda: run("cuda"), reps=20, name=FWD_KERNELS)
        plain_ms = profiled_ms(lambda: run("ref"), reps=5 if B > 8 else 20, warmup=1)[1]
        _, library_ms, _, library_kernels = profiled_ms(library, reps=20)
        walls = dict(ms_wall=event_median_ms(lambda: run("cuda")),
                     plain_ms_wall=event_median_ms(lambda: run("ref"), reps=5 if B > 8 else 20),
                     library_ms_wall=event_median_ms(library, reps=20))

        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        ty = -(-dims.j_extent(H) // 2)
        splits, _, _, (BT, BM, _, conf) = engine._plan(B, ty, ty, N, M, dims.stride, dev)
        T = B * ty * ty
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel()
                       + (2 * M if affine else 0))
        # com-PE products, the pre-PE adder network (32 adds per tile and
        # channel), the post-PE inverse transform (fold_adds) and the
        # epilogue (affine + activation per output value)
        products = 2 * T * C * N * M
        n_ops = products + 32 * T * N + T * M * fold_adds(packed.inv.cpu(), sub_slices) + 3 * got.numel()
        instantiation = sorted(k for k in by_kernel if kernel_named(k, FWD_KERNELS))
        ran_on(f"the forward at {name}", instantiation, tc)
        row = dict(kernel="fused_engine_epi", name=name, B=B, H_in=H, N=N, M=M, C=C, T=T,
                   plan=dict(BT=BT, BM=BM, tensor_cores=conf > 0, n_splits=splits),
                   out_mode="cells" if emit_cells else "nhwc", activation=act,
                   max_abs_err=err, tol=tol, err_share=err / tol, library_max_abs_err=lib_err,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_kernels=library_kernels, **walls,
                   bytes=n_bytes, ops=n_ops, achieved_tflops=n_ops / (ms * 1e-3) / 1e12,
                   **mma_bound(n_bytes, n_ops, products, instantiation, peaks))
        emit({"phase": "kernel", **row})
        rows.append(row)
        del x, w, packed, cells, got, want
        torch.cuda.empty_cache()
    return rows


def _serve_params(torch):
    """DCGAN generator params from a seed, with non-trivial eval-mode
    batchnorm and stem bias, so a resident's folded affine is held to more
    than an identity."""
    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G

    params = G.generator_init(DCGAN, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    params["stem"]["b"] = 0.1 * torch.randn(params["stem"]["b"].shape, generator=g, device="cuda")
    for k, bn in params.items():
        if k.endswith("_bn"):
            c = bn["mean"].shape[0]
            bn["mean"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
            bn["var"] = 0.5 + torch.rand((c,), generator=g, device="cuda")
            bn["scale"] = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
            bn["bias"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
    return params


def serve_rates(torch, eng, plain_cfg, kname):
    """Batch-1 and batch-8 generate times of ``eng`` (after its counted
    run): images/s, device ms and idle share from one profiled run, the
    kernel ``kname``'s device ms, the plain generator's time, and the
    submit-to-result latency (p50 and max of 20)."""
    from repro_torch.models import gan as G

    z1 = torch.randn((1, 100), generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    out = {}
    for b in (1, 8):
        z = z1.repeat(b, 1)
        gen_ms = wall_ms(lambda: eng.generate(z))
        prof_ms, dev_ms, kern_ms, _ = profiled_ms(lambda: eng.generate(z), name=kname)
        idle = 1.0 - dev_ms / prof_ms
        if idle < 0.0:
            fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
        plain_ms = wall_ms(lambda: G.generator_apply(eng.params, plain_cfg, z), reps=10)
        lat = []
        for _ in range(20):
            t = time.perf_counter()
            eng.submit(z).result()
            torch.cuda.synchronize()
            lat.append(1e3 * (time.perf_counter() - t))
        out[b] = dict(generate_ms=gen_ms, images_per_s=1e3 * b / gen_ms, device_ms=dev_ms,
                      kernel_ms=kern_ms, profiled_generate_ms=prof_ms, device_idle_share=idle,
                      plain_generate_ms=plain_ms, request_latency_ms_p50=statistics.median(lat),
                      request_latency_ms_max=max(lat))
    return out


def serve_phase(torch, card):
    import dataclasses

    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    t0 = time.perf_counter()
    eng = GanServeEngine(_serve_params(torch), DCGAN, batch=8, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = eng.archs[DCGAN.arch_id]
    g = torch.Generator(device="cuda").manual_seed(1)
    sizes_submit, sizes_run = (1, 3, 8), (2, 5, 8, 1, 4)
    zs = [torch.randn((b, DCGAN.z_dim), generator=g, device="cuda") for b in sizes_submit + sizes_run]

    # --- the main path: counts at 0 just before, read just after
    zero_counts()
    gen0 = res.generates
    futs = [eng.submit(z) for z in zs[: len(sizes_submit)]]
    outs = [f.result() for f in futs]
    outs += eng.run(zs[len(sizes_submit):])
    torch.cuda.synchronize()
    launches = read_counts()
    generates = res.generates - gen0
    if generates == 0:
        fail("no generate ran")
    check_counts("serve", launches, {"fused_engine_epi": 4 * generates})

    ref_cfg = dataclasses.replace(eng.cfg, deconv_impl="chained_ref")
    worst, worst_tol = 0.0, 0.0
    with torch.inference_mode():
        for z, o in zip(zs, outs):
            if tuple(o.shape) != (z.shape[0], 64, 64, 3):
                fail(f"served shape {tuple(o.shape)} for a request of {z.shape[0]}")
            if not torch.isfinite(o).all() or o.abs().max().item() > 1.0:
                fail("served images not finite or outside [-1, 1]")
            want, _ = G.generator_apply(eng.params, ref_cfg, z)
            err = (o - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"served image vs plain generator: max|err| {err:.3e} > {tol:.3e}")
            worst, worst_tol = max(worst, err), max(worst_tol, tol)
    emit({"phase": "serve", "arch": "dcgan", "requests": len(zs), "images": sum(z.shape[0] for z in zs),
          "dispatch_log": eng.dispatch_log, "bucket_counts": eng.bucket_counts,
          "generates": generates, "launches": launches["fused_engine_epi"], "max_abs_err_vs_plain": worst,
          "tol": worst_tol, "out_std": float(torch.cat([o.flatten() for o in outs]).std()),
          "setup_s": setup_s, "card": card})

    # --- throughput and latency (after the counted run)
    for b, rate in serve_rates(torch, eng, ref_cfg, FWD_KERNELS).items():
        emit({"phase": "serve_rate", "batch": b, **rate, "card": card})
    return launches


def serve_per_layer_phase(torch, card):
    """DCGAN at its published widths through GanServeEngine(chained=False),
    once per per-layer engine: "pallas_prepacked" serves on kernel 1
    (cuda_prepacked, the unfused engine), "pallas_fused_pre_prepacked" on
    kernel 2 (cuda_fused_pre_prepacked, the fused pre-PE engine in scratch
    mode).  The same requests as ``serve``; images against the per-layer
    plain generator (prepacked_ref); exactly 4 launches of the variant's
    kernel per generate and none of kernel 3; images/s and latency.
    Returns every kernel's launches in the counted runs."""
    import dataclasses

    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    params = _serve_params(torch)
    launches = dict.fromkeys(COUNTERS, 0)
    rates = {}
    for impl, served, key, kname in (
            ("pallas_prepacked", "cuda_prepacked", "domain_engine", DOMAIN_FWD_KERNELS),
            ("pallas_fused_pre_prepacked", "cuda_fused_pre_prepacked", "fused_engine_scratch", FWD_KERNELS)):
        t0 = time.perf_counter()
        eng = GanServeEngine(params, dataclasses.replace(DCGAN, deconv_impl=impl), batch=8, device="cuda",
                             chained=False)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if eng.cfg.deconv_impl != served:
            fail(f"chained=False serves {impl} as {eng.cfg.deconv_impl}, want {served}")
        res = eng.archs[DCGAN.arch_id]
        g = torch.Generator(device="cuda").manual_seed(1)
        sizes_submit, sizes_run = (1, 3, 8), (2, 5, 8, 1, 4)
        zs = [torch.randn((b, DCGAN.z_dim), generator=g, device="cuda") for b in sizes_submit + sizes_run]

        # --- the main path: counts at 0 just before, read just after
        zero_counts()
        gen0 = res.generates
        futs = [eng.submit(z) for z in zs[: len(sizes_submit)]]
        outs = [f.result() for f in futs]
        outs += eng.run(zs[len(sizes_submit):])
        torch.cuda.synchronize()
        got = read_counts()
        generates = res.generates - gen0
        if generates == 0:
            fail(f"{impl}: no generate ran")
        check_counts(f"serve_per_layer {impl}", got, {key: 4 * generates})
        launches = {row: n + got[row] for row, n in launches.items()}

        plain_cfg = dataclasses.replace(eng.cfg, deconv_impl="prepacked_ref")
        worst, worst_tol = 0.0, 0.0
        with torch.inference_mode():
            for z, o in zip(zs, outs):
                if tuple(o.shape) != (z.shape[0], 64, 64, 3):
                    fail(f"{impl}: served shape {tuple(o.shape)} for a request of {z.shape[0]}")
                if not torch.isfinite(o).all() or o.abs().max().item() > 1.0:
                    fail(f"{impl}: served images not finite or outside [-1, 1]")
                want_img, _ = G.generator_apply(eng.params, plain_cfg, z)
                err = (o - want_img).abs().max().item()
                tol = 1e-4 * want_img.abs().max().item() + 1e-5
                if not err <= tol:
                    fail(f"{impl}: served image vs per-layer plain generator: max|err| {err:.3e} > {tol:.3e}")
                worst, worst_tol = max(worst, err), max(worst_tol, tol)
        emit({"phase": "serve_per_layer", "arch": "dcgan", "impl": impl, "served_as": served,
              "requests": len(zs), "images": sum(z.shape[0] for z in zs), "dispatch_log": eng.dispatch_log,
              "bucket_counts": eng.bucket_counts, "generates": generates,
              "launches": got, "max_abs_err_vs_plain": worst,
              "tol": worst_tol, "setup_s": setup_s, "card": card})
        rates[key] = serve_rates(torch, eng, plain_cfg, kname)
        for b, rate in rates[key].items():
            emit({"phase": "serve_per_layer_rate", "impl": impl, "batch": b, **rate, "card": card})
        del eng, res, outs
        torch.cuda.empty_cache()
    return dict(launches=launches, kernel_ms={k: r[8]["kernel_ms"] for k, r in rates.items()})


# serve_faults: the reference chaos harness's engine settings (benchmarks/fig8_throughput.py:313-319) and its
# traffic: open loop, sizes 1-8, a 100 ms deadline, a mix of injected faults at rate 0.1
FAULT_ENGINE = dict(batch=8, chained=True, nan_guard=True, max_retries=2, breaker_threshold=3,
                    breaker_cooldown_ms=150.0)
FAULT_RPS, FAULT_SECONDS, FAULT_DEADLINE_MS, FAULT_SEED = 200.0, 1.0, 100.0, 0
# the kinds a failure may carry under FaultPlan(kind="mix", persistent=False): a raise or a NaN batch on a
# first attempt is retried, so a request fails only when its retry would pass its deadline (or the
# retries run out, which a first-attempt plan does not cause)
MIX_FAILURE_KINDS = {"deadline", "exception", "nan"}


def _reference_images(torch, eng, reqs):
    """The plain chained generator (chained_ref) on the latents of the
    delivered requests, batched by 64: {rid: image batch}."""
    import dataclasses

    from repro_torch.models import gan as G

    ref_cfg = dataclasses.replace(eng.cfg, deconv_impl="chained_ref")
    done = [r for r in reqs if r.done]
    out = {}
    with torch.inference_mode():
        for i in range(0, len(done), 64):
            chunk = done[i : i + 64]
            imgs, _ = G.generator_apply(eng.params, ref_cfg, torch.cat([r.z for r in chunk]))
            row = 0
            for r in chunk:
                out[r.rid] = imgs[row : row + r.size]
                row += r.size
    return out


def _check_delivered(torch, where, eng, reqs) -> dict:
    """Every delivered image against the plain chained generator on its
    latents (``1e-4·max|ref| + 1e-5``), after the server stopped."""
    want = _reference_images(torch, eng, reqs)
    worst, worst_share = 0.0, 0.0
    for r in reqs:
        if not r.done:
            continue
        w = want[r.rid]
        if tuple(r.out.shape) != (r.size, 64, 64, 3) or not torch.isfinite(r.out).all():
            fail(f"{where}: request {r.rid} delivered shape {tuple(r.out.shape)} or non-finite images")
        err = (r.out - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"{where}: request {r.rid} vs plain generator: max|err| {err:.3e} > {tol:.3e}")
        worst, worst_share = max(worst, err), max(worst_share, err / tol)
    return dict(max_abs_err_vs_plain=worst, err_share=worst_share)


def _fault_traffic(torch, seed):
    """(arrival seconds, latents on the card) of the load: Poisson arrivals at
    FAULT_RPS for FAULT_SECONDS, sizes 1-8, from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / FAULT_RPS, size=int(4 * FAULT_RPS * FAULT_SECONDS))
    times = np.cumsum(gaps)
    times = times[times < FAULT_SECONDS]
    sizes = rng.integers(1, 9, size=len(times))
    zs = [torch.from_numpy(rng.standard_normal((int(b), 100)).astype(np.float32)).to("cuda") for b in sizes]
    torch.cuda.synchronize()
    return [float(t) for t in times], zs


def _load_run(torch, eng, plan, times, zs, where) -> dict:
    """One open-loop run through AsyncGanServer(max_queue=64): every request
    submitted at its arrival time, every future waited for with a timeout,
    the server stopped (draining); counts zeroed just before, read just
    after.  Fails unless no future hung, the accounting reconciles, every
    failure is a GanServeError of a kind the plan explains, the NaN guard
    tripped once per injected NaN, and kernel 3 launched 4 times per
    generate; then every delivered image against the plain generator."""
    from repro_torch.serve import AsyncGanServer, GanServeError, GanServeRejected
    from repro_torch.serve import metrics as SM

    res = eng.archs["dcgan"]
    eng.fault_plan = plan
    trips0, gen0, disp0, h0 = res.nan_trips, res.generates, len(eng.dispatch_log), eng.health()["dcgan"]
    futs, hung = [], 0
    zero_counts()
    try:
        with AsyncGanServer(eng, max_queue=64) as srv:
            t0 = time.monotonic()
            for t_s, z in zip(times, zs):
                dt = t0 + t_s - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
                futs.append(srv.submit(z, arch="dcgan", deadline_ms=FAULT_DEADLINE_MS))
            wall_s = time.monotonic() - t0
            for f in futs:
                try:
                    f.result(timeout=60)
                except (GanServeError, GanServeRejected):
                    pass
                except TimeoutError:
                    hung += 1
    finally:
        eng.fault_plan = None
    torch.cuda.synchronize()
    launches = read_counts()
    generates = res.generates - gen0
    reqs = [f.request for f in futs]
    acct = dict(submitted=len(reqs), delivered=sum(r.done for r in reqs),
                failed=sum(r.failed and not r.done for r in reqs),
                rejected=sum(r.rejected and not (r.done or r.failed) for r in reqs),
                hung=hung + sum(not r.resolved for r in reqs))
    if acct["hung"]:
        fail(f"{where}: {acct['hung']} futures did not resolve")
    if acct["submitted"] != acct["delivered"] + acct["failed"] + acct["rejected"]:
        fail(f"{where}: accounting does not reconcile: {acct}")
    kinds: dict = {}
    for r in reqs:
        if r.failed:
            if not isinstance(r.error, GanServeError):
                fail(f"{where}: request {r.rid} failed with {type(r.error).__name__}, not GanServeError")
            kinds[r.error.kind] = kinds.get(r.error.kind, 0) + 1
    explained = MIX_FAILURE_KINDS if plan is not None else set()
    if not set(kinds) <= explained:
        fail(f"{where}: failure kinds {kinds} not explained by the plan (allowed: {sorted(explained)})")
    reasons = sorted({r.reject_reason.split(" (")[0] for r in reqs if r.rejected})
    nan_fired = 0 if plan is None else plan.fired_by_kind.get("nan", 0)
    if res.nan_trips - trips0 != nan_fired:
        fail(f"{where}: NaN guard tripped {res.nan_trips - trips0} times, the plan injected {nan_fired} NaN batches")
    if generates == 0:
        fail(f"{where}: no generate ran")
    check_counts(where, launches, {"fused_engine_epi": 4 * generates})
    summ = SM.summarize(reqs)["_all"]
    h1 = eng.health()["dcgan"]
    row = dict(accounting=acct, failure_kinds=kinds, reject_reasons=reasons, generates=generates,
               dispatches=len(eng.dispatch_log) - disp0, launches=launches["fused_engine_epi"], nan_trips=res.nan_trips - trips0,
               faults_fired=None if plan is None else plan.fired,
               faults_by_kind=None if plan is None else dict(plan.fired_by_kind), submit_wall_s=wall_s,
               **{k: summ.get(k) for k in ("p50_ms", "p95_ms", "p99_ms", "mean_queue_wait_ms", "mean_batch_wait_ms",
                                           "mean_compute_ms", "images_per_s", "throughput_rps", "span_s")},
               **{k: h1[k] - h0[k] for k in ("retries", "failures", "breaker_trips", "breaker_recoveries")},
               **_check_delivered(torch, where, eng, reqs))
    return row, launches


def _dispatch_costs(torch, res, rounds: int = 7, reps: int = 40) -> dict:
    """Host ms per batch-8 generate, in turns: enqueued back to back with one
    synchronize at the end (the launches alone, pipelined), with the stream
    synchronized after each (as a dispatch stamps t_done), and with the NaN
    guard's read after that; medians over ``rounds``.  The synchronize costs
    the difference of the first two, the guard that of the last two."""
    z = torch.randn((8, 100), generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    stream = torch.cuda.current_stream()

    def pipelined():
        for _ in range(reps):
            res.generate(z)
        stream.synchronize()

    def synced():
        for _ in range(reps):
            res.generate(z)
            stream.synchronize()

    def guarded():
        for _ in range(reps):
            imgs = res.generate(z)
            stream.synchronize()
            bool(torch.isfinite(imgs).all())

    fns = {"pipelined_ms": pipelined, "synced_ms": synced, "guarded_ms": guarded}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(rounds):
        for k, fn in fns.items():
            t = time.perf_counter()
            fn()
            times[k].append(1e3 * (time.perf_counter() - t) / reps)
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update(stream_sync_cost_ms=out["synced_ms"] - out["pipelined_ms"],
               nan_guard_cost_ms=out["guarded_ms"] - out["synced_ms"], rounds=rounds, reps=reps)
    return out


def serve_faults_phase(torch, card):
    """The serve stack's failure semantics on the card (the reference's chaos
    drill, benchmarks/fig8_throughput.py:300-345), DCGAN at its published
    widths, registered in the generator registry and made resident by name.
    A: open-loop load under an injected fault mix, then the same traffic
    without faults; B: the quarantine drill with a poisoned-weights probe;
    C: the watchdog drill; D: the NaN guard's and the stream sync's cost.
    Returns every kernel's launches over the phase's counted runs."""
    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import AsyncGanServer, FaultPlan, GanServeEngine, GanServeError, GanServeRejected

    t0 = time.perf_counter()
    G.clear_prepacked_generators()
    entry = G.register_prepacked_generator("dcgan", _serve_params(torch), DCGAN, device="cuda")
    eng = GanServeEngine(models={"dcgan": "dcgan"}, device="cuda", **FAULT_ENGINE)
    if eng.cfg.deconv_impl != "cuda_chained" or entry.cfg.deconv_impl != "cuda_chained":
        fail(f"the registered DCGAN serves as {eng.cfg.deconv_impl}, want cuda_chained")
    res = eng.archs["dcgan"]
    for b in eng.buckets:  # warm every bucket before any timed or counted run
        eng.generate(torch.zeros((b, 100), device="cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches = dict.fromkeys(COUNTERS, 0)

    def add(got):
        for row, n in got.items():
            launches[row] += n

    # --- A: the load, with the fault mix and without
    times, zs = _fault_traffic(torch, FAULT_SEED)
    runs = {}
    for name, plan, guard in (("faults", FaultPlan(kind="mix", rate=0.1, delay_ms=10.0, seed=FAULT_SEED), True),
                              ("no_faults", None, True), ("no_faults_guard_off", None, False)):
        eng.nan_guard = guard
        runs[name], got = _load_run(torch, eng, plan, times, zs, f"serve_faults {name}")
        add(got)
        emit({"phase": "serve_faults_load", "run": name, "nan_guard": guard, "rps": FAULT_RPS,
              "seconds": FAULT_SECONDS, "deadline_ms": FAULT_DEADLINE_MS, **runs[name], "card": card})
    eng.nan_guard = True
    if runs["faults"]["faults_fired"] == 0:
        fail("serve_faults: the fault plan fired no fault")
    if runs["no_faults"]["accounting"]["failed"] or runs["no_faults_guard_off"]["accounting"]["failed"]:
        fail("serve_faults: a request failed without any injected fault")

    # --- B: quarantine drill (synchronous: the futures drive the engine)
    z1 = zs[0][:1]
    br = res.breaker
    drill = {}
    zero_counts()
    gen0 = res.generates
    eng.fault_plan = FaultPlan(kind="raise", arch="dcgan", persistent=True)
    failed = 0
    for _ in range(br.threshold):
        try:
            eng.submit(z1).result(timeout=30)
        except GanServeError as e:
            failed += e.kind == "exception" and e.attempts == 1 + eng.max_retries
    drill["tripped"] = br.state == "open" and failed == br.threshold
    try:
        eng.submit(z1)
        drill["fast_rejected"] = False
    except GanServeRejected as e:
        drill["fast_rejected"] = "quarantined" in str(e)
    eng.fault_plan = None
    ww = res.params["deconv1"]["ww"]
    saved = ww[3, 2, 1].clone()
    clean_finite = G.params_finite(res.params)
    ww[3, 2, 1] = float("inf")
    inf_finite = G.params_finite(res.params)
    ww[3, 2, 1] = float("nan")
    nan_finite = G.params_finite(res.params)
    drill["params_finite_clean_inf_nan"] = [clean_finite, inf_finite, nan_finite]
    time.sleep(br.cooldown_ms / 1e3 + 0.05)
    try:
        eng.submit(z1).result(timeout=30)
        drill["poisoned_probe_kind"] = None
    except GanServeError as e:
        drill["poisoned_probe_kind"] = e.kind
    drill["reopened"] = br.state == "open" and br.trips == 2
    with torch.inference_mode():
        drill["poisoned_batch_finite"] = bool(torch.isfinite(res.generate(z1)).all())
    ww[3, 2, 1] = saved
    time.sleep(br.cooldown_ms / 1e3 + 0.05)
    probe = eng.submit(z1)
    probe.result(timeout=30)
    drill["recovered"] = br.state == "closed" and br.recoveries == 1
    torch.cuda.synchronize()
    got = read_counts()
    check_counts("serve_faults drill", got, {"fused_engine_epi": 4 * (res.generates - gen0)})
    add(got)
    drill.update(_check_delivered(torch, "serve_faults drill", eng, [probe.request]))
    emit({"phase": "serve_faults_drill", **drill, "breaker": br.counters(), "card": card})
    if not (drill["tripped"] and drill["fast_rejected"] and drill["reopened"] and drill["recovered"]
            and drill["poisoned_probe_kind"] == "nan" and not drill["poisoned_batch_finite"]
            and drill["params_finite_clean_inf_nan"] == [True, False, False]):
        fail(f"serve_faults: quarantine drill {drill}")

    # --- C: watchdog drill: the generate loop raises once outside the isolation boundary
    calls = {"n": 0}
    orig = eng._dispatch

    def boom(now=None):
        if calls["n"] == 0:
            calls["n"] += 1
            raise RuntimeError("raised outside the isolation boundary (watchdog drill)")
        return orig(now)

    eng._dispatch = boom
    zero_counts()
    gen0 = res.generates
    srv = AsyncGanServer(eng, watchdog=True, watchdog_interval_ms=5.0, poll_interval_ms=0.5).start()
    try:
        first = srv.submit(zs[1])
        try:
            first.result(timeout=30)
            first_kind = None
        except GanServeError as e:
            first_kind = e.kind
        after = [srv.submit(z) for z in zs[2:6]]
        for f in after:
            f.result(timeout=30)
    finally:
        srv.stop(timeout=60)
        del eng._dispatch
    torch.cuda.synchronize()
    got = read_counts()
    check_counts("serve_faults watchdog", got, {"fused_engine_epi": 4 * (res.generates - gen0)})
    add(got)
    wd = dict(restart_count=srv.restart_count, first_kind=first_kind, served_after=sum(f.request.done for f in after),
              **_check_delivered(torch, "serve_faults watchdog", eng,
                                                          [f.request for f in after]))
    emit({"phase": "serve_faults_watchdog", **wd, "card": card})
    if not (wd["restart_count"] == 1 and first_kind == "loop_dead" and wd["served_after"] == len(after)):
        fail(f"serve_faults: watchdog drill {wd}")

    # --- D: what the NaN guard and the stream sync cost a batch-8 dispatch, and a dispatch's compute stamp
    # (t_done - t_dispatch) at batch 8, one request at a time, driven on this thread and by the server
    costs = _dispatch_costs(torch, res)
    z8 = torch.cat(zs)[:8]
    for how in ("caller", "server"):
        stamps = []
        with contextlib.ExitStack() as stack:
            srv = stack.enter_context(AsyncGanServer(eng, poll_interval_ms=0.5)) if how == "server" else None
            for _ in range(43):
                f = (srv or eng).submit(z8)
                f.result(timeout=30)
                stamps.append(f.request.timing["compute_ms"])
        costs[f"compute_ms_one_at_a_time_{how}"] = statistics.median(stamps[3:])
    emit({"phase": "serve_faults_costs", **costs,
          "mean_compute_ms_guard_on": runs["no_faults"]["mean_compute_ms"],
          "mean_compute_ms_guard_off": runs["no_faults_guard_off"]["mean_compute_ms"], "card": card})
    emit({"phase": "serve_faults", "arch": "dcgan", "engine": FAULT_ENGINE, "setup_s": setup_s,
          "hung": sum(r["accounting"]["hung"] for r in runs.values()), "accounting_reconciled": True,
          "drill_passed": True, "watchdog_passed": True, "launches": launches["fused_engine_epi"],
          "launches_per_generate": 4, "max_err_share_vs_plain": max(
              [r["err_share"] for r in runs.values()] + [drill["err_share"], wd["err_share"]]), "card": card})
    G.clear_prepacked_generators()
    return launches


# train_gan's chaos drill (run B): each (kind, step) one non-persistent TrainFaultPlan firing once
TRAIN_GAN_PLAN = (("raise", 5), ("nan_grad", 9), ("corrupt_ckpt", 10), ("raise", 11), ("preempt", 14))
TRAIN_GAN_STEPS, TRAIN_GAN_CKPT_EVERY = 16, 4
# What the reference's train_gan returns for TRAIN_GAN_PLAN over TRAIN_GAN_STEPS steps, a checkpoint every
# TRAIN_GAN_CKPT_EVERY and the default FaultPolicy (rollback, no backoff): the chaos run, then the run that resumes
# its directory.  The raise at 5 restores step 4; the NaN batch at 9 trips the sentinel and rolls back to 8; the
# corruption at 10 truncates step 8, so the raise at 11 falls back past it to 4; the preempt at 14 checkpoints
# step 15 and returns.  tests/test_torch_train_resilience.py holds both packages to these on the CPU.
TRAIN_GAN_EXPECTED = {
    "chaos": {
        "counters": {"restores": 2, "rollbacks": 1, "skips": 0, "sentinel_trips": 1, "ckpt_fallbacks": 1,
                     "injected_handled": {"raise": 2, "nan_grad": 1}},
        "fault_log": [
            {"step": 5, "attempt": 1, "injected": True, "kind": "exception", "verdict": None, "action": "restore",
             "error": "InjectedTrainFault: injected raise at step 5"},
            {"step": 9, "attempt": 1, "injected": True, "kind": "divergence", "verdict": "nonfinite:g_loss",
             "action": "rollback", "error": None},
            {"step": 11, "attempt": 1, "injected": True, "kind": "exception", "verdict": None, "action": "restore",
             "error": "InjectedTrainFault: injected raise at step 11"}],
        "faults_injected": {"raise": 2, "nan_grad": 1, "corrupt_ckpt": 1, "preempt": 1},
        "final_step": 15,
        "preempted": True,
    },
    "resume": {
        "counters": {"restores": 0, "rollbacks": 0, "skips": 0, "sentinel_trips": 0, "ckpt_fallbacks": 0,
                     "injected_handled": {}},
        "fault_log": [], "faults_injected": {}, "final_step": 16, "preempted": False,
    },
}
# the port's step calls in each run (an injected raise fires before the step runs): clean, chaos, resume
TRAIN_GAN_STEP_CALLS = {"clean": 16, "chaos": 25, "resume": 1}
TRAIN_GAN_LAUNCHES = {"fused_engine_epi": 4, "fused_engine_bwd_x": 4, "fused_engine_bwd_w": 4,
                      "conv_engine_fwd": 8, "conv_engine_bwd_x": 11, "conv_engine_bwd_w": 12}  # per step call


def train_gan_plans(resilience) -> list:
    """TRAIN_GAN_PLAN as fresh TrainFaultPlans of ``resilience`` (either
    package's module: the plans are mutable, each fires once)."""
    return [resilience.TrainFaultPlan(kind=kind, at_step=step, max_faults=1) for kind, step in TRAIN_GAN_PLAN]


def accounting(out: dict) -> dict:
    """The keys of a train_gan result that TRAIN_GAN_EXPECTED holds."""
    return {k: out[k] for k in ("counters", "fault_log", "faults_injected", "final_step", "preempted")}


def train_gan_phase(torch, card):
    """The port's train_gan loop on the card, DCGAN at its published widths,
    batch 128, both nets cuda_chained (the reference's main training path),
    AdamW lr 2e-4, b1 0.5.  A: a clean run of TRAIN_GAN_STEPS steps (and A',
    the same again: the step's determinism); B: a chaos run in a fresh
    checkpoint directory under TRAIN_GAN_PLAN; C: a run resuming B's
    directory.  Fails unless B's and C's accounting is TRAIN_GAN_EXPECTED,
    C's metrics history and final params are A's bit for bit, the NaN
    batch's metrics are non-finite, and kernels 3/6/7 launch 4/4/4 and the
    conv corner's 8/11/12 per step call and no other kernel launches.
    Readings: loop ms per step with the sentinel on and off against a bare
    make_gan_step loop (medians of three rounds in turns), checkpoint bytes, save ms (device-to-host, sha256,
    write and fsync), restore ms (the fallback walk included), verify ms,
    peak device memory.  Returns every kernel's launches over A, B and C."""
    import dataclasses
    import math
    import os
    import tempfile
    import warnings

    from repro_torch import data as D
    from repro_torch.configs import DCGAN
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, train_gan
    from repro_torch.train import checkpoint as C
    from repro_torch.train import resilience as R
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(DCGAN, deconv_impl="cuda_chained", conv_impl="cuda_chained")
    B, steps = TRAIN_BATCH, TRAIN_GAN_STEPS
    kw = dict(batch=B, seed=0, handle_signals=False, device="cuda", settings=StepSettings(lr=2e-4, b1=0.5))
    run_kw = dict(kw, steps=steps, log_every=1)

    # counted step calls, timed checkpoint pieces, and what the sentinel saw
    calls = [0]
    spent = {"save": [], "d2h": 0.0, "sha": 0.0, "restore": []}
    seen = []
    real = dict(make=T.make_gan_step, host=C._host_array, sha=C._leaf_sha, save=C.save_checkpoint,
                restore=C.restore_latest_valid, observe=R.DivergenceDetector.observe)

    def make_counting(*a, **k):
        step = real["make"](*a, **k)

        def counted(*sa):
            calls[0] += 1
            return step(*sa)
        return counted

    def timed(key, fn):
        def wrapper(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            spent[key] += time.perf_counter() - t
            return out
        return wrapper

    def timed_call(key, fn, note):
        def wrapper(*a, **k):
            d2h, sha, t = spent["d2h"], spent["sha"], time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key].append(dict(ms=1e3 * (time.perf_counter() - t), **note(out, spent["d2h"] - d2h,
                                                                                 spent["sha"] - sha)))
            return out
        return wrapper

    def observe(self, step, metrics):
        verdict = real["observe"](self, step, metrics)
        if verdict is not None:
            seen.append(dict(step=step, verdict=verdict, metrics=metrics))
        return verdict

    T.make_gan_step = make_counting
    C._host_array, C._leaf_sha = timed("d2h", real["host"]), timed("sha", real["sha"])
    C.save_checkpoint = timed_call("save", real["save"], lambda out, d2h, sha: dict(
        path=os.path.basename(out), d2h_ms=1e3 * d2h, sha256_ms=1e3 * sha))
    C.restore_latest_valid = timed_call("restore", real["restore"], lambda out, d2h, sha: dict(step=out[0]))
    R.DivergenceDetector.observe = observe
    runs, step_calls = {}, {}
    try:
        # --- the main path: A, B, C with the counts at 0 just before and read just after
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        totals = dict.fromkeys(COUNTERS, 0)
        with tempfile.TemporaryDirectory(prefix="train_gan_") as ckpt:
            for name, extra in (("clean", {}), ("chaos", dict(ckpt_dir=ckpt, ckpt_every=TRAIN_GAN_CKPT_EVERY,
                                                                 fault_plan=train_gan_plans(R))),
                                ("resume", dict(ckpt_dir=ckpt, ckpt_every=TRAIN_GAN_CKPT_EVERY))):
                calls[0] = 0
                before = read_counts()
                t = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)  # the fallback past the corrupt step 8
                    runs[name] = train_gan(cfg, **run_kw, **extra)
                torch.cuda.synchronize()
                runs[name]["seconds"] = time.perf_counter() - t
                got = {row: n - before[row] for row, n in read_counts().items()}
                step_calls[name] = calls[0]
                check_counts(f"train_gan {name}", got, {row: n * calls[0] for row, n in TRAIN_GAN_LAUNCHES.items()})
                for row, n in got.items():
                    totals[row] += n
            peak = torch.cuda.max_memory_allocated()
            launches = read_counts()
            if launches != totals:
                fail(f"train_gan: launches {launches} over the runs, {totals} by run")
            last = C.latest_step(ckpt)
            step_dir = os.path.join(ckpt, f"step_{last:012d}")
            ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
            t = time.perf_counter()
            C.verify_checkpoint(ckpt, last)
            verify_ms = 1e3 * (time.perf_counter() - t)
            kept = C.available_steps(ckpt)
        # A': the clean run again (is the step deterministic?)
        zero_counts()
        again = train_gan(cfg, **run_kw)
    finally:
        T.make_gan_step = real["make"]
        C._host_array, C._leaf_sha = real["host"], real["sha"]
        C.save_checkpoint, C.restore_latest_valid = real["save"], real["restore"]
        R.DivergenceDetector.observe = real["observe"]

    for name in ("chaos", "resume"):
        if accounting(runs[name]) != TRAIN_GAN_EXPECTED[name]:
            fail(f"train_gan {name}: {accounting(runs[name])}, the reference gives {TRAIN_GAN_EXPECTED[name]}")
    if step_calls != TRAIN_GAN_STEP_CALLS:
        fail(f"train_gan: step calls {step_calls}, want {TRAIN_GAN_STEP_CALLS}")
    bad = [e for e in seen if e["step"] == 9]
    if len(seen) != 1 or not bad or any(math.isfinite(bad[0]["metrics"][k]) for k in ("g_loss", "d_loss")) \
            or bad[0]["metrics"]["nonfinite"] != 1.0:
        fail(f"train_gan chaos: the sentinel's verdicts {seen}, want one, non-finite metrics at step 9")

    def same(a, b) -> dict:
        leaves = [(x, y) for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"]))]
        return dict(metrics=a["metrics"] == b["metrics"], params=all(torch.equal(x, y) for x, y in leaves),
                    max_abs_diff_params=max((x - y).abs().max().item() for x, y in leaves))

    clean, resumed = runs["clean"], runs["resume"]
    deterministic = same(clean, again)
    resumed_vs_clean = same(clean, resumed)
    if not (deterministic["metrics"] and deterministic["params"]):
        # a library op of the step is not deterministic: hold C to A within the train phases' 3-step tolerances
        worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(resumed["metrics"], clean["metrics"])
                    for k in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"))
        if not (worst <= 1e-3 and resumed_vs_clean["max_abs_diff_params"] <= 6 * 2e-4):
            fail(f"train_gan: the resumed run against the clean one: metrics {worst:.3e} relative, params "
                 f"{resumed_vs_clean['max_abs_diff_params']:.3e} (A against A': {deterministic})")
    elif not (resumed_vs_clean["metrics"] and resumed_vs_clean["params"]):
        fail(f"train_gan: the resumed run is not the clean run bit for bit: {resumed_vs_clean}")
    if not all(math.isfinite(v) for e in clean["metrics"] for v in e.values()):
        fail("train_gan: non-finite metrics in the clean run")

    # --- readings: loop ms per step (two run lengths, so init and the first step cancel), sentinel on and off,
    # against a bare make_gan_step loop on the same batches; three rounds in turns (host time spreads)
    def loop_ms(policy) -> float:
        walls = []
        for n in (4, 4 + steps):
            t = time.perf_counter()
            train_gan(cfg, steps=n, log_every=n, policy=policy, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return 1e3 * (walls[1] - walls[0]) / steps

    step = T.make_gan_step(cfg, settings=kw["settings"])
    gp, dp = clean["params"]["gp"], clean["params"]["dp"]

    def bare_ms() -> float:
        state = [gp, dp, adamw_init(gp), adamw_init(dp)]
        for s in range(steps + 2):
            if s == 2:
                torch.cuda.synchronize()
                t = time.perf_counter()
            z, real_b = D.latent_batch(0, s, B, cfg.z_dim, device="cuda"), D.gan_batch(0, s, B, cfg.img_hw,
                                                                                      device="cuda")
            state[:] = step(*state, z, real_b)[:4]
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / steps

    loop = {"sentinel_on": [], "sentinel_off": [], "bare_step": []}
    for _ in range(3):
        loop["sentinel_on"].append(loop_ms(R.FaultPolicy()))
        loop["sentinel_off"].append(loop_ms(R.FaultPolicy(sentinel=False)))
        loop["bare_step"].append(bare_ms())
    saves = spent["save"]
    emit({"phase": "train_gan", "arch": "dcgan", "batch": B, "steps": steps, "impls": "cuda_chained both nets",
          "plan": TRAIN_GAN_PLAN, "accounting": {k: accounting(runs[k]) for k in ("chaos", "resume")},
          "matches_reference": True, "step_calls": step_calls, "launches_per_step_call": TRAIN_GAN_LAUNCHES,
          "launches": launches, "nan_step": {"step": bad[0]["step"], "verdict": bad[0]["verdict"], "metrics": {
              k: v if math.isfinite(v) else repr(v) for k, v in bad[0]["metrics"].items()}},
          "deterministic_a_vs_a2": deterministic, "resumed_vs_clean": resumed_vs_clean,
          "run_seconds": {k: r["seconds"] for k, r in runs.items()}, "card": card})
    emit({"phase": "train_gan_rate", **{f"loop_ms_per_step_{k}": statistics.median(v) for k, v in loop.items()},
          "loop_ms_per_step_rounds": loop,
          "checkpoint_bytes": ckpt_bytes, "kept_steps": kept, "saves": saves,
          "save_ms_mean": statistics.mean(x["ms"] for x in saves),
          "save_d2h_ms_mean": statistics.mean(x["d2h_ms"] for x in saves),
          "save_sha256_ms_mean": statistics.mean(x["sha256_ms"] for x in saves),
          "save_write_fsync_ms_mean": statistics.mean(x["ms"] - x["d2h_ms"] - x["sha256_ms"] for x in saves),
          "restores": spent["restore"], "verify_ms": verify_ms, "max_memory_allocated": peak, "card": card})
    return launches


def _dcgan_train_shapes():
    """(name, dims, B, H, N, M, gy, emit_cells, act) of DCGAN's four deconv
    layers in a training step at batch 128; gy is the height of the cells
    the layer reads (the stem image's cells, then the previous layer's
    emitted cells, passed through)."""
    from repro_torch.core.tdc import DeconvDims

    K5 = DeconvDims(5, 2, 2, 1)
    B, rows, gy = TRAIN_BATCH, [], None
    for i, (H, N, M) in enumerate([(4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)]):
        ty = -(-K5.j_extent(H) // 2)
        gy = ty + 1 if gy is None else gy
        last = i == 3
        rows.append((f"dcgan.deconv{i}", K5, B, H, N, M, gy, not last, "tanh" if last else "none"))
        gy = 2 * ty  # this layer's emitted cells: (B, ty*S, tx*S, 4, M)
    return rows


def kernel_bwd_phase(torch, peaks):
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.kernels import engine, ops

    K4, K3, K2S3 = DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    shapes = _dcgan_train_shapes() + [
        ("k4s2", K4, 8, 8, 256, 128, None, True, "leaky_relu"),
        ("k3s1", K3, 8, 32, 64, 3, None, False, "tanh"),
        ("k2s3", K2S3, 2, 8, 32, 16, None, False, "relu"),
        # the tensor-core routes' edges: N, M multiples of 4 but not of the block tile, T = 252 tiles (not a
        # multiple of the 8- or 16-tile chunk), and a T split
        (RAGGED_SHAPE[0], DeconvDims(*RAGGED_SHAPE[1]), *RAGGED_SHAPE[2:], None, True, "relu"),
    ]
    flops_peak, bytes_peak, _ = peaks
    dev = torch.cuda.current_device()
    rows, refusals = [], []
    for i, (name, dims, B, H, N, M, gy, emit_cells, act) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(200 + i)
        S, P = dims.stride, dims.padding
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        ty = -(-dims.j_extent(H) // 2)
        gy = gy if gy is not None else ty + 1
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        packed = ops.prepack(w, dims)
        cells = ops.cells_from_image(x, dims)
        if cells.shape[1] < gy:  # the pass-through cells of a chained layer are larger
            cells = torch.nn.functional.pad(cells, (0, 0, 0, 0, 0, gy - cells.shape[2], 0, gy - cells.shape[1]))
        cells = cells.contiguous()
        gs = torch.randn((B, ty, ty, S * S * 4, M), generator=g, device="cuda")
        geo = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=ty, stride=S)
        run_x = lambda: engine.fused_engine_bwd_x(gs, packed.ww, packed.inv, gy=gy, gx=gy, **geo)  # noqa: E731
        run_w = lambda: engine.fused_engine_bwd_w(cells, gs, packed.inv, **geo)  # noqa: E731
        plain_x = lambda: engine.fused_engine_bwd_x_plain(gs, packed.ww, packed.inv, gy=gy, gx=gy, **geo)  # noqa: E731
        plain_w = lambda: engine.fused_engine_bwd_w_plain(cells, gs, packed.inv, **geo)  # noqa: E731
        errs = {}
        for key, run, plain in (("x", run_x, plain_x), ("w", run_w, plain_w)):
            got = run()
            torch.cuda.synchronize()
            want = plain()
            if tuple(got.shape) != tuple(want.shape):
                fail(f"bwd_{key} at {name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"bwd_{key} kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")
            errs[key] = (err, tol)
            bitwise_repeat(f"bwd_{key} at {name}", run, got)
        if i == 0:  # each wrapper refuses a misaligned operand, and launches again after it
            fwd = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=ty, stride=S, padding=P,
                       out_h=dims.out_size(H), out_w=dims.out_size(H), out_mode="scratch")
            refusals += [
                refuses_misaligned("fused_engine_bwd_x", lambda: engine.fused_engine_bwd_x(
                    misaligned(gs), packed.ww, packed.inv, gy=gy, gx=gy, **geo), run_x),
                refuses_misaligned("fused_engine_bwd_w", lambda: engine.fused_engine_bwd_w(
                    cells, misaligned(gs), packed.inv, **geo), run_w),
                refuses_misaligned("fused_engine", lambda: engine.fused_engine(
                    misaligned(cells), packed.ww, packed.inv, **fwd),
                    lambda: engine.fused_engine(cells, packed.ww, packed.inv, **fwd))]
            emit({"phase": "kernel_bwd", "misaligned_refusals": refusals})

        # the yardstick: aten's backward of this layer's conv_transpose2d
        HO = dims.out_size(H)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wt = w.permute(2, 3, 0, 1).contiguous()
        go = torch.randn((B, M, HO, HO), generator=g, device="cuda")
        conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xc, wt, None, [S, S], [P, P], [1, 1], True, [dims.output_padding] * 2, 1, mask)

        T = B * ty * ty
        # products, gw from g (fold_adds), the B-transform or its transpose
        # (32 adds per tile and channel), and for bwd_x the overlap sum
        products = 2 * T * C * N * M
        common_ops = products + T * M * fold_adds(packed.inv.cpu(), sub_slices, True) + 32 * T * N
        dcells_n = B * gy * gy * 4 * N
        work = {
            "x": (4 * (gs.numel() + packed.ww.numel() + packed.inv.numel() + dcells_n),
                  common_ops + overlap_adds(B, 1, N, ty, ty)),
            "w": (4 * (cells.numel() + gs.numel() + packed.inv.numel() + C * N * M), common_ops),
        }
        for key, run, plain, kname, mask in (
                ("x", run_x, plain_x, BWD_X_KERNELS, [True, False, False]),
                ("w", run_w, plain_w, BWD_W_KERNELS, [False, True, False])):
            n_bytes, n_ops = work[key]
            t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
            _, _, ms, by_kernel = profiled_ms(run, reps=20, name=kname)
            plain_ms = profiled_ms(plain, reps=5, warmup=1, what=f"plain bwd_{key} at {name}")[1]
            library_ms = profiled_ms(lambda: conv_bwd(mask), reps=20, what=f"convolution_backward at {name}")[1]
            row = dict(kernel=f"fused_engine_bwd_{key}", name=name, B=B, H_in=H, N=N, M=M, C=C, T=T, gy=gy,
                       max_abs_err=errs[key][0], tol=errs[key][1], ms=ms,
                       ms_wall=event_median_ms(run, reps=20), plain_ms=plain_ms,
                       plain_ms_wall=event_median_ms(plain, reps=5, warmup=1),
                       library_ms=library_ms, library_ms_wall=event_median_ms(lambda: conv_bwd(mask), reps=20),
                       library_note=("aten convolution_backward, input grad" if key == "x" else
                                     "aten convolution_backward, raw-weight grad (not the packed one)"),
                       bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=n_bytes, ops=n_ops, achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
            # the redesigned kernels: the instantiation that ran and its bound (the products at the
            # 3xTF32 rate where it ran on the tensor cores), and their plan: bwd_x's tile slots,
            # bwd_w's split, block tile and how often it forms each value of xw
            row.update(mma_bound(n_bytes, n_ops, products,
                                 sorted(k for k in by_kernel if kernel_named(k, kname)), peaks))
            if key == "x":
                R, W, TC, BT, _ = engine._bwd_x_plan(B, gy, gy, ty, ty, M, dev)
                row["plan"] = dict(R=R, W=W, TC=TC, BT=BT, **bwd_x_block_use(B, gy, gy, ty, ty, R, W, TC, BT))
            else:
                splits, _, _, tile = engine._bwd_w_plan(B, ty, ty, N, M, S, C, dev)
                row["plan"] = bwd_w_plan(tile, splits, C, S * S, M)
                if name == RAGGED_SHAPE[0] and splits < 2:
                    fail(f"kernel 7 at the ragged shape ran unsplit (plan {row['plan']})")
            emit({"phase": "kernel_bwd", **row})
            rows.append(row)

        del x, w, packed, cells, gs, go, xc
        torch.cuda.empty_cache()
    return rows


FWD_CONF_KERNELS = {0: ("domain_fwd_kernel",), 1: DOMAIN_FWD_MMA, 2: ("domain_fwd_few_kernel",)}


def domain_fwd_plan(torch, engine, name, B, xw, packed, kw, dev, held, err):
    """Kernel 1's plan at one shape and what it is held to: the
    instantiation (conf 1, the tensor cores, at DCGAN's deconv0-2 at the
    training batch; conf 2, few channels, at its RGB layer there; the
    CUDA-core kernel at every other shape of the phase, the serving batch
    among them), its launch, and each instantiation the shape allows against
    the plain version with its device ms: the plan's must not be slower than
    the CUDA-core kernel's (10% for noise)."""
    T, _, N = xw.shape
    M, C, S2 = packed.ww.shape[2], packed.ww.shape[0], len(kw["sub_slices"])
    splits, _, _, (BT, BM, conf, _) = engine._domain_plan("fwd", T, N, M, S2, dev, C=C)
    dcgan_train = name.startswith("dcgan.") and B == TRAIN_BATCH
    want = 1 if dcgan_train and M >= 16 else 2 if dcgan_train else 0
    if conf != want:
        fail(f"kernel 1's plan at {name} batch {B} chose instantiation {conf}, want {want}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the grid: (T tile, M tile) blocks, times S^2 sub-filters (tensor and CUDA cores) and the N split (CUDA cores)
    blocks = -(-T // BT) * -(-M // BM) * (1 if conf == 2 else S2) * (splits if conf == 0 else 1)
    plan = dict(instantiation={0: "cuda_cores", 1: "tensor_cores", 2: "few_channels"}[conf], BT=BT, BM=BM,
                blocks=blocks, sms=sms, n_splits=splits)
    allowed = [0, 2] + ([1] if M % 4 == 0 and M >= 16 else [])
    confs = {}
    for c in sorted(allowed):
        inst = engine.INSTANTIATIONS["domain_engine"][c]
        run = lambda: engine.domain_engine(xw, packed.ww, packed.inv, conf=inst, **kw)  # noqa: E731
        e, tol = held(f"domain_engine fwd instantiation {c} at {name}", run(),
                      engine.domain_engine_plain(xw, packed.ww, packed.inv, **kw))
        confs[c] = dict(ms=profiled_ms(run, reps=10, name=FWD_CONF_KERNELS[c])[2], err_share=e / tol)
    if confs[conf]["ms"] > 1.1 * confs[0]["ms"]:
        fail(f"kernel 1's plan at {name} batch {B} chose instantiation {conf} ({confs[conf]['ms']:.4f} ms), "
             f"slower than the CUDA-core kernel ({confs[0]['ms']:.4f} ms)")
    return dict(plan=plan, instantiations_ms={k: v["ms"] for k, v in confs.items()},
                want_kernels=FWD_CONF_KERNELS[conf], tensor_cores=conf == 1)


def kernel_domain_phase(torch, peaks):
    """Kernels 1, 4 and 5 (domain_engine.cu) against their plain versions at
    DCGAN's four generator layers at the training batch 128 and at a K4S2, a
    K3S1 and a K2S3 shape, kernel 1 also at the four layers at the serving
    batch 8; kernel 2 (fused_engine.cu, scratch mode) at the
    four layers at batch 8 and 128; one FusedPreFn and one EngineFn gradient
    against autograd of the plain versions.  Device, one-call and plain ms,
    the bound, and as yardsticks the layer's conv_transpose2d (kernels 1, 2)
    and aten's convolution_backward (input grad for 4, raw-weight grad for 5)."""
    import torch.nn.functional as F

    from repro_torch.core.tdc import DeconvDims
    from repro_torch.core.winograd_deconv import pad_input_for_tiles, transform_input_tiles
    from repro_torch.kernels import engine, ops

    K5, K4, K3, K2S3 = DeconvDims(5, 2, 2, 1), DeconvDims(4, 2, 1, 0), DeconvDims(3, 1, 1, 0), DeconvDims(2, 3, 0, 0)
    layers = [(f"dcgan.deconv{i}", K5, H, N, M)
              for i, (H, N, M) in enumerate([(4, 1024, 512), (8, 512, 256), (16, 256, 128), (32, 128, 3)])]
    all3 = ("fwd", "bwd_x", "bwd_w")
    shapes = [(n, d, TRAIN_BATCH, H, N, M, all3) for n, d, H, N, M in layers] + [
        (f"{n}.b8", d, 8, H, N, M, ("fwd",)) for n, d, H, N, M in layers] + [  # kernel 1 serves at batch 8
        ("k4s2", K4, 8, 8, 256, 128, all3), ("k3s1", K3, 8, 32, 64, 3, all3), ("k2s3", K2S3, 2, 8, 32, 16, all3),
        # the tensor-core routes' edges (kernel_bwd's ragged shape)
        (RAGGED_SHAPE[0], DeconvDims(*RAGGED_SHAPE[1]), *RAGGED_SHAPE[2:], all3)]
    scratch_shapes = [(n, d, B, H, N, M) for B in (8, TRAIN_BATCH) for n, d, H, N, M in layers]
    flops_peak, bytes_peak, _ = peaks
    dev = torch.cuda.current_device()
    rows, refusals = [], []

    def held(what, got, want):
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{what}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"{what} kernel vs plain: max|err| {err:.3e} > {tol:.3e}")
        return err, tol

    def layer_inputs(seed, dims, B, H, N, M):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn((B, H, H, N), generator=g, device="cuda")
        w = 0.02 * torch.randn((dims.kernel, dims.kernel, N, M), generator=g, device="cuda")
        return g, x, w, ops.prepack(w, dims)

    def library_calls(g, x, w, dims, B, H, M):
        S, P = dims.stride, dims.padding
        HO = dims.out_size(H)
        xc = x.permute(0, 3, 1, 2).contiguous()
        wt = w.permute(2, 3, 0, 1).contiguous()
        go = torch.randn((B, M, HO, HO), generator=g, device="cuda")
        fwd = lambda: F.conv_transpose2d(xc, wt, stride=S, padding=P, output_padding=dims.output_padding)  # noqa: E731
        bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xc, wt, None, [S, S], [P, P], [1, 1], True, [dims.output_padding] * 2, 1, mask)
        return fwd, bwd

    def measure(kernel, name, B, H, N, M, C, T, run, plain, kname, lib, lib_note, n_bytes, n_ops, err,
                products=None, tensor_cores=None, **extra):
        t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
        _, _, ms, by_kernel = profiled_ms(run, reps=20, name=kname)
        if products is not None:  # a redesigned kernel: the instantiation that ran, and its bound
            extra.update(mma_bound(n_bytes, n_ops, products,
                                   sorted(k for k in by_kernel if kernel_named(k, kname)), peaks))
        if tensor_cores is not None:
            ran_on(f"{kernel} at {name}", extra["instantiation"], tensor_cores)
        if "want_kernels" in extra:  # kernel 1: exactly the instantiation its plan names for this shape
            want = extra.pop("want_kernels")
            if sorted({k for n in want for k in extra["instantiation"] if kernel_named(k, n)}) != \
                    sorted(extra["instantiation"]) or not all(
                    any(kernel_named(k, n) for k in extra["instantiation"]) for n in want):
                fail(f"{kernel} at {name} ran {extra['instantiation']}, want {list(want)}")
        row = dict(kernel=kernel, name=name, B=B, H_in=H, N=N, M=M, C=C, T=T, max_abs_err=err[0], tol=err[1],
                   err_share=err[0] / err[1],
                   ms=ms, ms_wall=event_median_ms(run, reps=20),
                   plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain {kernel} at {name}")[1],
                   library_ms=profiled_ms(lib, reps=20, what=f"library {kernel} at {name}")[1],
                   library_note=lib_note, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, ops=n_ops,
                   achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
        row.update(extra)  # a redesigned kernel's bound replaces the fp32 one
        emit({"phase": "kernel_domain", **row})
        rows.append(row)

    # --- kernels 1, 4, 5 on the transformed tiles
    for i, (name, dims, B, H, N, M, keys) in enumerate(shapes):
        g, x, w, packed = layer_inputs(400 + i, dims, B, H, N, M)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C, S2 = len(pos_idx), dims.stride ** 2
        x_pad, (ty, tx) = pad_input_for_tiles(x, dims)
        T = B * ty * tx
        xw = transform_input_tiles(x_pad, (ty, tx)).reshape(T, 16, N).contiguous()
        gs = torch.randn((T, S2 * 4, M), generator=g, device="cuda")
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=4)
        runs = {k: v for k, v in {
            "fwd": (lambda: engine.domain_engine(xw, packed.ww, packed.inv, **kw),
                    lambda: engine.domain_engine_plain(xw, packed.ww, packed.inv, **kw)),
            "bwd_x": (lambda: engine.domain_engine_bwd_x(gs, packed.ww, packed.inv, n2=16, **kw),
                      lambda: engine.domain_engine_bwd_x_plain(gs, packed.ww, packed.inv, n2=16, **kw)),
            "bwd_w": (lambda: engine.domain_engine_bwd_w(xw, gs, packed.inv, **kw),
                      lambda: engine.domain_engine_bwd_w_plain(xw, gs, packed.inv, **kw)),
        }.items() if k in keys}
        errs = {}
        for key, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs[key] = held(f"domain_engine {key} at {name}", got, plain())
            bitwise_repeat(f"domain_engine {key} at {name}", run, got)
        if i == 0:  # each wrapper refuses a misaligned operand, and launches again after it
            refusals += [
                refuses_misaligned("domain_engine", lambda: engine.domain_engine(
                    misaligned(xw), packed.ww, packed.inv, **kw), runs["fwd"][0]),
                refuses_misaligned("domain_engine_bwd_x", lambda: engine.domain_engine_bwd_x(
                    misaligned(gs), packed.ww, packed.inv, n2=16, **kw), runs["bwd_x"][0]),
                refuses_misaligned("domain_engine_bwd_w", lambda: engine.domain_engine_bwd_w(
                    xw, misaligned(gs), packed.inv, **kw), runs["bwd_w"][0])]
        lib_fwd, lib_bwd = library_calls(g, x, w, dims, B, H, M)
        inv_np = packed.inv.cpu()
        prod = 2 * T * C * N * M
        fold, gw = T * M * fold_adds(inv_np, sub_slices), T * M * fold_adds(inv_np, sub_slices, True)
        io = {"fwd": xw.numel() + packed.ww.numel() + T * S2 * 4 * M,
              "bwd_x": gs.numel() + packed.ww.numel() + xw.numel(),
              "bwd_w": xw.numel() + gs.numel() + packed.ww.numel()}
        libs = {"fwd": (lib_fwd, "conv_transpose2d (cuDNN), the whole layer"),
                "bwd_x": (lambda: lib_bwd([True, False, False]), "aten convolution_backward, input grad"),
                "bwd_w": (lambda: lib_bwd([False, True, False]),
                          "aten convolution_backward, raw-weight grad (not the packed one)")}
        knames = {"fwd": DOMAIN_FWD_KERNELS, "bwd_x": DOMAIN_BWD_X_KERNELS, "bwd_w": DOMAIN_BWD_W_KERNELS}
        for key, (run, plain) in runs.items():
            extra = {"products": prod}
            if key == "fwd":
                extra.update(domain_fwd_plan(torch, engine, name, B, xw, packed, kw, dev, held, errs["fwd"]))
            if key == "bwd_w":
                splits, _, _, tile = engine._domain_plan("bwd_w", T, N, M, S2, dev, 4, C)
                extra["plan"] = bwd_w_plan(tile, splits, C, S2, M)
                if name == RAGGED_SHAPE[0] and splits < 2:
                    fail(f"kernel 5 at the ragged shape ran unsplit (plan {extra['plan']})")
            measure(f"domain_engine{'' if key == 'fwd' else '_' + key}", name, B, H, N, M, C, T, run, plain,
                    knames[key], *libs[key], 4 * (io[key] + packed.inv.numel()),
                    prod + (fold if key == "fwd" else gw), errs[key], **extra)
        del x, w, packed, xw, gs, x_pad
        torch.cuda.empty_cache()

    # --- kernel 2: the fused pre-PE engine in scratch mode
    for i, (name, dims, B, H, N, M) in enumerate(scratch_shapes):
        g, x, w, packed = layer_inputs(500 + i, dims, B, H, N, M)
        pos_idx, sub_slices, _, _ = ops.packed_layout(dims)
        C = len(pos_idx)
        cells = ops.cells_from_image(x, dims)
        ty = tx = -(-dims.j_extent(H) // 2)
        T = B * ty * tx
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=4, ty=ty, tx=tx, stride=dims.stride,
                  padding=dims.padding, out_h=dims.out_size(H), out_w=dims.out_size(H), out_mode="scratch")
        run = lambda: engine.fused_engine(cells, packed.ww, packed.inv, **kw)  # noqa: E731
        plain = lambda: engine.fused_engine_plain(cells, packed.ww, packed.inv, **kw)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        err = held(f"fused_engine scratch at {name} batch {B}", got, plain())
        bitwise_repeat(f"fused_engine scratch at {name} batch {B}", run, got)
        if i == 0:
            refusals.append(refuses_misaligned("fused_engine", lambda: engine.fused_engine(
                misaligned(cells), packed.ww, packed.inv, **kw), run))
            emit({"phase": "kernel_domain", "misaligned_refusals": refusals})
        lib_fwd, _ = library_calls(g, x, w, dims, B, H, M)
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel())
        n_ops = 2 * T * C * N * M + 32 * T * N + T * M * fold_adds(packed.inv.cpu(), sub_slices)
        # the tensor cores where the grid fills the card: DCGAN's deconv0-2 at batch 128
        splits, _, _, (BT, BM, _, conf) = engine._plan(B, ty, tx, N, M, dims.stride, dev)
        measure("fused_engine_scratch", f"{name}.b{B}", B, H, N, M, C, T, run, plain, FWD_KERNELS, lib_fwd,
                "conv_transpose2d (cuDNN), the whole layer", n_bytes, n_ops, err, products=2 * T * C * N * M,
                tensor_cores=B == TRAIN_BATCH and M >= 16,
                plan=dict(BT=BT, BM=BM, tensor_cores=conf > 0, n_splits=splits))
        del x, w, packed, cells, got
        torch.cuda.empty_cache()

    # --- the two autograd Functions at a DCGAN training shape (deconv2,
    # batch 128) against autograd of the plain versions
    name, dims, H, N, M = layers[2]
    g, x0, w, packed = layer_inputs(600, dims, TRAIN_BATCH, H, N, M)
    go = torch.randn((TRAIN_BATCH, dims.out_size(H), dims.out_size(H), M), generator=g, device="cuda")
    for fuse_pre, fn in ((True, "FusedPreFn"), (False, "EngineFn")):
        grads = {}
        for backend in ("cuda", "ref"):
            x = x0.clone().requires_grad_(True)
            ww = packed.ww.clone().requires_grad_(True)
            y = ops.winograd_deconv2d_packed(x, ops.PackedDeconv(ww, packed.inv), dims, fuse_pre=fuse_pre,
                                             backend=backend)
            grads[backend] = torch.autograd.grad((y * go).sum(), (x, ww))
        torch.cuda.synchronize()
        ex = held(f"{fn} dx at {name}", grads["cuda"][0], grads["ref"][0])
        ew = held(f"{fn} dww at {name}", grads["cuda"][1], grads["ref"][1])
        emit({"phase": "kernel_domain", "grad_check": fn, "name": name, "B": TRAIN_BATCH,
              "dx_max_abs_err": ex[0], "dx_tol": ex[1], "dww_max_abs_err": ew[0], "dww_tol": ew[1]})
    del x0, w, packed, go, grads
    torch.cuda.empty_cache()
    return rows


def kernel_1d_phase(torch, peaks):
    """TPU kernels 8 and 9 (engine1d.cu) against their plain versions at the
    audio decoder's three layers at full width (nlc, as the decoder runs
    them, and scratch), the reference benchmark's conv1d and deconv1d, a
    K3S2 OP1 and a K6S3 deconv, a phases=2 scratch shape and the nlc
    epilogue with each activation; rank-1 kernels 4 and 5 at the decoder's
    three layers.  Device, one-call and plain ms, the bound, and the
    library yardsticks (conv_transpose1d / conv1d plus the epilogue; aten
    convolution_backward, input grad for 4, raw-weight grad for 5)."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import audio_decoder
    from repro_torch.core.tdc import DeconvDims
    from repro_torch.core.winograd import get_transform
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref, xw_from_cells_1d

    K4S2 = DeconvDims(4, 2, 1, 0)
    specs = audio_decoder(AUDIO_WIDTH)
    decoder = [(f"audio.deconv{i}", "deconv", sp.dims, AUDIO_BATCH, AUDIO_FRAMES * 2**i, sp.c_in, sp.c_out)
               for i, sp in enumerate(specs)]
    # name, kind, geometry, B, L, N, M, out_mode, activation, affine
    # the decoder's layers at batch 1 too (one caller's decode: kernel 9 on the CUDA cores), under their own prefix
    decoder_b1 = [(f"audio_b1.deconv{i}", "deconv", sp.dims, 1, AUDIO_FRAMES * 2**i, sp.c_in, sp.c_out)
                  for i, sp in enumerate(specs)]
    shapes = [(*d, "nlc", "none", False) for d in decoder + decoder_b1] + [
        (*d, "scratch", "none", False) for d in decoder] + [
        ("bench.conv1d_k4_causal", "conv", 4, 8, 2048, 256, 256, "nlc", "none", False),
        ("bench.deconv1d_k4s2", "deconv", K4S2, 8, 1024, 128, 64, "nlc", "none", False),
        ("k3s2_op1", "deconv", DeconvDims(3, 2, 1, 1), 4, 512, 64, 48, "nlc", "relu", True),
        ("k6s3", "deconv", DeconvDims(6, 3, 2, 0), 4, 512, 64, 48, "nlc", "leaky_relu", True),
        ("phases2", "phases", 2, 4, 1024, 64, 64, "scratch", "none", False),
    ] + [(f"epilogue.{act}", "deconv", K4S2, 4, 512, 64, 64, "nlc", act, True)
         for act in ("none", "relu", "leaky_relu", "tanh")]
    flops_peak, bytes_peak, _ = peaks
    rows, refusals = [], []

    def held(what, got, want):
        if tuple(got.shape) != tuple(want.shape):
            fail(f"{what}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item() + 1e-5
        if not err <= tol:
            fail(f"{what} kernel vs plain: max|err| {err:.3e} > {tol:.3e}")
        return err, tol

    def measure(kernel, name, run, plain, kname, lib, lib_note, n_bytes, n_ops, err, products=None, **extra):
        t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
        _, _, ms, by_kernel = profiled_ms(run, reps=20, name=kname)
        if products is not None:  # a redesigned kernel: the instantiation that ran, and its bound
            extra.update(mma_bound(n_bytes, n_ops, products,
                                   sorted(k for k in by_kernel if kernel_named(k, kname)), peaks))
        row = dict(kernel=kernel, name=name, max_abs_err=err[0], tol=err[1], ms=ms,
                   ms_wall=event_median_ms(run, reps=20),
                   plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain {kernel} at {name}")[1],
                   library_ms=None if lib is None else profiled_ms(lib, reps=20, what=f"library {kernel} at {name}")[1],
                   library_note=lib_note, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, ops=n_ops,
                   achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
        row.update(extra)  # a redesigned kernel's bound replaces the fp32 one
        emit({"phase": "kernel_1d", **row})
        rows.append(row)

    bt23 = tuple(tuple(float(v) for v in row) for row in get_transform(2, 3).BT)
    for i, (name, kind, geo, B, L, N, M, out_mode, act, affine) in enumerate(shapes):
        g = torch.Generator(device="cuda").manual_seed(700 + i)
        x = w = None
        if kind == "deconv":
            x = torch.randn((B, L, N), generator=g, device="cuda")
            w = 0.05 * torch.randn((geo.kernel, N, M), generator=g, device="cuda")
            packed = ops.prepack_deconv1d(w, geo)
            cells, ty = ops.deconv1d_cells_from_seq(x, geo)
            pos_idx, sub_slices, _, _ = ops.packed_deconv1d_layout(geo)
            bt, n, S = bt23, 4, geo.stride
        elif kind == "conv":
            x = torch.randn((B, L, N), generator=g, device="cuda")
            w = 0.05 * torch.randn((geo, N, M), generator=g, device="cuda")
            packed = ops.prepack_conv1d(w, geo)
            cells, ty, _ = ops.conv1d_cells_from_seq(x, geo, padding="causal")
            pos_idx, sub_slices, _, bt, n = ops.conv1d_layout(geo)
            S = 1
        else:  # one sub-filter over `geo` phases of F(2,3) positions, as a strided conv lays them out
            ty, n, S, bt = L, 4, 1, bt23
            cells = torch.randn((B, ty + 1, 2 * geo, N), generator=g, device="cuda")
            pos_idx, sub_slices = tuple(range(4 * geo)), ((0, 4 * geo),)
            inv = torch.as_tensor(np.tile(ops.conv1d_layout(3)[2], (geo, 1)), device="cuda")
            packed = ops.PackedConv1d(0.05 * torch.randn((4 * geo, N, M), generator=g, device="cuda"), inv)
        phases = geo if kind == "phases" else 1
        scale = (1.0 + 0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        bias = (0.1 * torch.randn((M,), generator=g, device="cuda")) if affine else None
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=n, ty=ty, phases=phases, out_mode=out_mode)
        if out_mode == "nlc":
            kw.update(activation=act, scale=scale, bias=bias, stride=S)
        run = lambda: engine.winograd_conv1d_fused_engine(cells, packed.ww, packed.inv, bt, **kw)  # noqa: E731
        plain = lambda: engine.winograd_conv1d_fused_engine_plain(cells, packed.ww, packed.inv, bt, **kw)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        err = held(f"engine1d {out_mode} at {name}", got, plain())
        bitwise_repeat(f"engine1d {out_mode} at {name}", run, got)
        if name in NAN_CASES:  # NaN weights, through the nlc epilogue's relu
            ww_nan = poison(packed.ww)
            emit({"phase": "kernel_1d", "nan_case": nan_case(
                f"winograd_conv1d_fused_engine at {name}",
                lambda: engine.winograd_conv1d_fused_engine(cells, ww_nan, packed.inv, bt, **kw),
                lambda: engine.winograd_conv1d_fused_engine_plain(cells, ww_nan, packed.inv, bt, **kw))})
        if i == 0:  # the 1D wrapper refuses a misaligned operand, and launches again after it
            e1 = engine.winograd_conv1d_fused_engine
            refusals += [
                refuses_misaligned("winograd_conv1d_fused_engine",
                                   lambda: e1(misaligned(cells), packed.ww, packed.inv, bt, **kw), run),
                refuses_misaligned("winograd_conv1d_fused_engine",
                                   lambda: e1(cells, misaligned(packed.ww), packed.inv, bt, **kw), run)]

        lib, lib_note, lib_err = None, None, None
        if kind != "phases":
            P = geo.padding if kind == "deconv" else 0
            LO = geo.out_size(L) if kind == "deconv" else L
            xc = x.permute(0, 2, 1).contiguous()
            if kind == "deconv":
                wt = w.permute(1, 2, 0).contiguous()
                lib_y = lambda: F.conv_transpose1d(xc, wt, stride=geo.stride, padding=geo.padding,  # noqa: E731
                                                   output_padding=geo.output_padding)
                lib_note = "conv_transpose1d (cuDNN)"
            else:
                wt, xp = w.permute(2, 1, 0).contiguous(), F.pad(xc, (geo - 1, 0))
                lib_y = lambda: F.conv1d(xp, wt)  # noqa: E731
                lib_note = "conv1d (cuDNN) on the causally padded input"
            if out_mode == "nlc":
                lib = lambda: epilogue_apply_ref(lib_y().permute(0, 2, 1), scale, bias, act)  # noqa: E731
                lib_note += " + the epilogue" if affine or act != "none" else ""
                mine = got[:, P : P + LO]
            else:
                lib = lambda: lib_y().permute(0, 2, 1)  # noqa: E731
                Bb, _, s2m, Mm = got.shape
                mine = got.reshape(Bb, ty, S, 2, Mm).permute(0, 1, 3, 2, 4).reshape(Bb, ty * 2 * S, Mm)[:, P : P + LO]
            want_lib = lib()
            lib_err = (mine - want_lib).abs().max().item()
            if not lib_err <= 1e-4 * want_lib.abs().max().item() + 1e-5:
                fail(f"engine1d at {name} vs {lib_note}: max|err| {lib_err:.3e}")
        T, C = cells.shape[0] * ty, len(pos_idx)
        inv_np = packed.inv.cpu().numpy()
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel()
                       + (2 * M if affine else 0))
        epi = got.numel() * ((2 if affine else 0) + (act != "none")) if out_mode == "nlc" else 0
        n_ops = (2 * T * C * N * M + T * phases * N * transform_ops_1d(bt) + T * M * fold_ops_1d(inv_np, sub_slices)
                 + epi)
        measure(f"engine1d_{out_mode}", name, run, plain, ENGINE1D_KERNELS, lib, lib_note, n_bytes, n_ops, err,
                products=2 * T * C * N * M, B=B, L=L, N=N, M=M, C=C, T=T, phases=phases, activation=act,
                affine=affine, library_max_abs_err=lib_err)
        # the tensor cores run the decoder's layers of M >= 64 (deconv0-1; the mono deconv2 stays on the CUDA cores)
        if name.startswith("audio.") and M >= 16 and not any("_mma_kernel" in k for k in rows[-1]["instantiation"]):
            fail(f"engine1d at {name} ran {rows[-1]['instantiation']}, not the tensor-core kernel")
        del cells, packed, got
        torch.cuda.empty_cache()

    # --- rank-1 kernels 4 and 5 at the decoder's layers (batch 16)
    for i, (name, _, dims, B, L, N, M) in enumerate(decoder):
        g = torch.Generator(device="cuda").manual_seed(800 + i)
        x = torch.randn((B, L, N), generator=g, device="cuda")
        w = 0.05 * torch.randn((dims.kernel, N, M), generator=g, device="cuda")
        packed = ops.prepack_deconv1d(w, dims)
        cells, ty = ops.deconv1d_cells_from_seq(x, dims)
        pos_idx, sub_slices, _, _ = ops.packed_deconv1d_layout(dims)
        T, C, S2 = B * ty, len(pos_idx), len(sub_slices)
        xw = xw_from_cells_1d(cells, bt23, m=2, n=4, ty=ty).contiguous()
        gs = torch.randn((T, S2 * 2, M), generator=g, device="cuda")
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=2)
        runs = {"bwd_x": (lambda: engine.domain_engine_bwd_x(gs, packed.ww, packed.inv, n2=4, **kw),
                          lambda: engine.domain_engine_bwd_x_plain(gs, packed.ww, packed.inv, n2=4, **kw)),
                "bwd_w": (lambda: engine.domain_engine_bwd_w(xw, gs, packed.inv, **kw),
                          lambda: engine.domain_engine_bwd_w_plain(xw, gs, packed.inv, **kw))}
        errs = {}
        for key, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            errs[key] = held(f"rank-1 domain_engine {key} at {name}", got, plain())
            bitwise_repeat(f"rank-1 domain_engine {key} at {name}", run, got)
        if i == 0:  # the rank-1 wrappers refuse a misaligned operand, and launch again after it
            refusals += [
                refuses_misaligned("domain_engine_bwd_x (rank 1)", lambda: engine.domain_engine_bwd_x(
                    misaligned(gs), packed.ww, packed.inv, n2=4, **kw), runs["bwd_x"][0]),
                refuses_misaligned("domain_engine_bwd_w (rank 1)", lambda: engine.domain_engine_bwd_w(
                    xw, misaligned(gs), packed.inv, **kw), runs["bwd_w"][0])]
            emit({"phase": "kernel_1d", "misaligned_refusals": refusals})
        xc, wt = x.permute(0, 2, 1).contiguous(), w.permute(1, 2, 0).contiguous()
        go = torch.randn((B, M, dims.out_size(L)), generator=g, device="cuda")
        conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xc, wt, None, [dims.stride], [dims.padding], [1], True, [dims.output_padding], 1, mask)
        inv_np = packed.inv.cpu().numpy()
        products = 2 * T * C * N * M
        prod = products + T * M * fold_ops_1d(inv_np, sub_slices, backward=True)
        io = {"bwd_x": gs.numel() + packed.ww.numel() + xw.numel(), "bwd_w": xw.numel() + gs.numel() + packed.ww.numel()}
        libs = {"bwd_x": (lambda: conv_bwd([True, False, False]), "aten convolution_backward, input grad"),
                "bwd_w": (lambda: conv_bwd([False, True, False]),
                          "aten convolution_backward, raw-weight grad (not the packed one)")}
        for key, (run, plain) in runs.items():
            extra = {"products": products}
            if key == "bwd_w":
                splits, _, _, tile = engine._domain_plan("bwd_w", T, N, M, S2, torch.cuda.current_device(), 2, C)
                extra["plan"] = bwd_w_plan(tile, splits, C, S2, M)
            measure(f"domain_engine_{key}_rank1", name, run, plain,
                    DOMAIN_BWD_X_KERNELS if key == "bwd_x" else DOMAIN_BWD_W_KERNELS, *libs[key],
                    4 * (io[key] + packed.inv.numel()), prod, errs[key], B=B, L=L, N=N, M=M, C=C, T=T, **extra)
        del x, w, packed, cells, xw, gs, go, xc
        torch.cuda.empty_cache()

    # --- rank-1 kernel 4 at the benchmark's conv1d (K4 causal, F(2,4): n2 = 5 positions in one
    # sub-filter, the tensor-core instantiation for more than 4), as winograd_conv1d's gradient runs it
    name, _, K, B, L, N, M = next(sh for sh in shapes if sh[0] == "bench.conv1d_k4_causal")[:7]
    g = torch.Generator(device="cuda").manual_seed(850)
    w = 0.05 * torch.randn((K, N, M), generator=g, device="cuda")
    packed = ops.prepack_conv1d(w, K)
    pos_idx, sub_slices, _, _, n = ops.conv1d_layout(K)
    ty = -(-L // 2)
    T, C = B * ty, len(pos_idx)
    gs = torch.randn((T, 2, M), generator=g, device="cuda")
    kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m2=2, n2=n)
    run = lambda: engine.domain_engine_bwd_x(gs, packed.ww, packed.inv, **kw)  # noqa: E731
    plain = lambda: engine.domain_engine_bwd_x_plain(gs, packed.ww, packed.inv, **kw)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    err = held(f"rank-1 domain_engine bwd_x at {name}", got, plain())
    bitwise_repeat(f"rank-1 domain_engine bwd_x at {name}", run, got)
    xp = F.pad(torch.randn((B, N, L), generator=g, device="cuda"), (K - 1, 0))
    wt, go = w.permute(2, 1, 0).contiguous(), torch.randn((B, M, L), generator=g, device="cuda")
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        go, xp, wt, None, [1], [0], [1], False, [0], 1, [True, False, False])
    products = 2 * T * C * N * M
    measure("domain_engine_bwd_x_rank1", name, run, plain, DOMAIN_BWD_X_KERNELS, lib,
            "aten convolution_backward, input grad (of the causally padded input)",
            4 * (gs.numel() + packed.ww.numel() + got.numel() + packed.inv.numel()),
            products + T * M * fold_ops_1d(packed.inv.cpu().numpy(), sub_slices, backward=True), err,
            products=products, B=B, L=L, N=N, M=M, C=C, T=T)
    del w, packed, gs, got, xp, go
    torch.cuda.empty_cache()
    return rows


def audio_phase(torch, card):
    """The audio decoder at full width through audio_decoder_apply on the
    kernels, batch 16 and 1: launches, no plain-version call, the waveform
    against the plain and lax decoders, the gradient of sum(y^2) against the
    plain decoder's with its launches; then forward and gradient times, idle
    share, samples/s, peak memory.  Returns the counted runs' launches."""
    from repro_torch.configs import audio_decoder
    from repro_torch.kernels import engine
    from repro_torch.models import gan as G

    specs = audio_decoder(AUDIO_WIDTH)
    t0 = time.perf_counter()
    params = G.audio_decoder_init(specs, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    for leaf in params.values():  # non-zero biases, so the check holds them too
        leaf["b"] = 0.1 * torch.randn(leaf["b"].shape, generator=g, device="cuda")
    xs = {b: torch.randn((b, AUDIO_FRAMES, specs[0].c_in), generator=g, device="cuda") for b in (AUDIO_BATCH, 1)}
    samples = AUDIO_FRAMES * 2 ** len(specs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    plains = ("winograd_conv1d_fused_engine_plain", "domain_engine_bwd_x_plain", "domain_engine_bwd_w_plain")
    plain_calls = [0]

    def counted(fn):
        """Run ``fn`` with every kernel count at 0 just before and read just
        after, and the wrappers' plain versions counting their calls."""
        real = {nm: getattr(engine, nm) for nm in plains}

        def counting(f):
            def call(*a, **k):
                plain_calls[0] += 1
                return f(*a, **k)
            return call

        zero_counts()
        for nm in plains:
            setattr(engine, nm, counting(real[nm]))
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for nm, f in real.items():
                setattr(engine, nm, f)
        return out, read_counts()

    # --- the main path, forward: 3 launches of the 1D engine per decode
    with torch.no_grad():
        outs, launches = counted(lambda: {b: G.audio_decoder_apply(params, specs, x, impl="cuda")
                                          for b, x in xs.items()})
    check_counts("audio forward", launches, {"engine1d_nlc": 3 * len(xs)})
    if plain_calls[0]:
        fail(f"the audio decoder on CUDA tensors called a plain version {plain_calls[0]} times")
    errs = {}
    with torch.no_grad():
        for b, y in outs.items():
            if tuple(y.shape) != (b, samples, specs[-1].c_out):
                fail(f"waveform shape {tuple(y.shape)} for batch {b}")
            if not torch.isfinite(y).all() or y.abs().max().item() > 1.0:
                fail("waveform not finite or outside [-1, 1]")
            for impl in ("ref", "lax"):
                want = G.audio_decoder_apply(params, specs, xs[b], impl=impl)
                err = (y - want).abs().max().item()
                tol = 1e-4 * want.abs().max().item() + 1e-5
                if not err <= tol:
                    fail(f"waveform (batch {b}) vs impl {impl!r}: max|err| {err:.3e} > {tol:.3e}")
                errs[f"b{b}_vs_{impl}"] = (err, tol)

    # --- the main path, gradient of sum(y^2) in every weight and bias
    x = xs[AUDIO_BATCH]

    def grads(impl):
        p = {k: {kk: v.detach().clone().requires_grad_(True) for kk, v in leaf.items()} for k, leaf in params.items()}
        y = G.audio_decoder_apply(p, specs, x, impl=impl)
        keys = [(k, kk) for k, leaf in p.items() for kk in leaf]
        return dict(zip(keys, torch.autograd.grad((y**2).sum(), [p[k][kk] for k, kk in keys])))

    plain_calls[0] = 0
    k_kinks = []
    with kink_sides(k_kinks):
        g_k, grad_launches = counted(lambda: grads("cuda"))
    # layer 0's input is the latent (no gradient wanted): rank-1 kernel 4 on layers 1 and 2
    check_counts("audio gradient", grad_launches,
                 {"engine1d_nlc": 3, "domain_engine_bwd_x_rank1": 2, "domain_engine_bwd_w_rank1": 3})
    if plain_calls[0]:
        fail(f"the audio decoder's gradient on CUDA tensors called a plain version {plain_calls[0]} times")
    # the plain gradient on the kernel run's side of each relu kink, the
    # flips bounded; then on its own sides, a reading
    p_kinks = []
    with kink_sides(p_kinks, follow=k_kinks):
        g_r = grads("ref")
    kinks = compare_kinks(k_kinks, p_kinks)
    grad_share = 0.0
    for key, want in g_r.items():
        err = (g_k[key] - want).abs().max().item()
        tol = 1e-3 * want.abs().max().item()
        if not err <= tol:
            fail(f"gradient of {key[0]}.{key[1]}: kernels vs plain {err:.3e} > {tol:.3e}")
        grad_share = max(grad_share, err / tol if tol > 0 else 0.0)
    g_u = grads("ref")
    unmasked_share = 0.0
    for key, want in g_u.items():
        tol = 1e-3 * want.abs().max().item()
        unmasked_share = max(unmasked_share, (g_k[key] - want).abs().max().item() / tol if tol > 0 else 0.0)
    del k_kinks, p_kinks, g_u
    emit({"phase": "audio", "width": AUDIO_WIDTH, "frames": AUDIO_FRAMES, "samples": samples,
          "batches": list(xs), "launches": launches, "grad_launches": grad_launches,
          "max_abs_err": {k: v[0] for k, v in errs.items()}, "tol": {k: v[1] for k, v in errs.items()},
          "grad_err_share_of_tol": grad_share, "grad_err_share_of_tol_unmasked": unmasked_share, **kinks,
          "out_std": float(outs[AUDIO_BATCH].std()), "setup_s": setup_s,
          "card": card})
    del outs, g_k, g_r

    # --- speed (after the counted runs)
    fwd_kernel_ms = {}
    for b, xb in xs.items():
        def fwd(impl="cuda", xb=xb):
            with torch.no_grad():
                return G.audio_decoder_apply(params, specs, xb, impl=impl)
        fwd_ms = wall_ms(fwd, reps=10)
        prof_ms, dev_ms, kern_ms, by_kernel = profiled_ms(fwd, reps=10, name=ENGINE1D_KERNELS)
        idle = 1.0 - dev_ms / prof_ms
        if idle < 0.0:
            fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
        fwd_kernel_ms[b] = kern_ms
        # the tensor cores' 64-tile blocks fill the card at batch 16; at batch 1 they would leave most SMs idle,
        # so the plan keeps the CUDA-core kernel there
        on_tc = {k for k in by_kernel if kernel_named(k, "engine1d_mma_kernel")}
        if bool(on_tc) != (b == AUDIO_BATCH):
            fail(f"the decoder at batch {b} ran {sorted(k for k in by_kernel if kernel_named(k, ENGINE1D_KERNELS))}")
        emit({"phase": "audio_rate", "batch": b, "forward_ms": fwd_ms, "samples_per_s": 1e3 * b * samples / fwd_ms,
              "profiled_forward_ms": prof_ms, "device_ms": dev_ms, "device_idle_share": idle,
              "engine1d_kernel_ms": kern_ms,
              "top_kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]),
              "host_ms_by_op": host_ops_ms(fwd),
              "plain_forward_ms": wall_ms(lambda: fwd("ref"), reps=5, warmup=1),
              "lax_forward_ms": wall_ms(lambda: fwd("lax"), reps=10), "card": card})
    torch.cuda.reset_peak_memory_stats()
    grad_ms = wall_ms(lambda: grads("cuda"), reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    prof_ms, dev_ms, _, by_kernel = profiled_ms(lambda: grads("cuda"), reps=5, warmup=1)
    emit({"phase": "audio_grad_rate", "batch": AUDIO_BATCH, "grad_ms": grad_ms, "profiled_grad_ms": prof_ms,
          "device_ms": dev_ms, "device_idle_share": 1.0 - dev_ms / prof_ms,
          "top_kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]),
          "plain_grad_ms": wall_ms(lambda: grads("ref"), reps=3, warmup=1),
          "lax_grad_ms": wall_ms(lambda: grads("lax"), reps=5, warmup=1),
          "max_memory_allocated": peak, "card": card})
    return dict(launches=launches, grad_launches=grad_launches, fwd_kernel_ms=fwd_kernel_ms, grad_kernels=by_kernel)


def _dcgan_disc_shapes():
    """(name, K, S, B, H, W, N, M, emit_cells, act, affine) of DCGAN's four
    discriminator layers in a training step at batch 128 (conv0: bias and
    leaky_relu fused; conv1-3: bias fused, BN on the emitted cells)."""
    rows, H = [], 64
    for i, (N, M) in enumerate([(3, 64), (64, 128), (128, 256), (256, 512)]):
        rows.append((f"dcgan.conv{i}", 4, 2, TRAIN_BATCH, H, H, N, M, True,
                     "leaky_relu" if i == 0 else "none", False))
        H //= 2
    return rows


def _library_convs(names) -> list:
    """The names among ``names`` of cuDNN or aten convolution kernels."""
    pats = ("cudnn", "conv2d", "convolution", "implicit_gemm", "implicit_convolve", "dgrad", "wgrad", "fprop")
    return [k for k in names if any(p in k.lower() for p in pats)]


def kernel_conv_phase(torch, peaks):
    """The three conv-corner kernels against their plain versions at the
    DCGAN discriminator's training shapes and at an odd-extent K4S2, a K3S2
    and a K3S1 shape; device, one-call and plain ms, the bound, and the
    library yardsticks (conv2d plus the epilogue; aten convolution_backward
    for the input and for the raw weights)."""
    import torch.nn.functional as F

    from repro_torch.core import conv_same_dims
    from repro_torch.kernels import engine, ops
    from repro_torch.kernels.ref import epilogue_apply_ref

    shapes = _dcgan_disc_shapes() + [
        ("k4s2_odd", 4, 2, 8, 15, 13, 32, 48, False, "tanh", True),
        ("k3s2", 3, 2, 8, 16, 16, 36, 20, True, "relu", True),
        ("k3s1", 3, 1, 4, 16, 16, 3, 3, False, "leaky_relu", False),
        # the tensor-core routes' edges: N, M multiples of 4 but not of the block tiles, T = 63 tiles (not
        # a multiple of the 8-tile chunk)
        CONV_RAGGED_SHAPE,
    ]
    flops_peak, bytes_peak, _ = peaks
    dev = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for i, (name, K, S, B, H, W, N, M, emit_cells, act, affine) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        cd = conv_same_dims(K, S, H)
        if conv_same_dims(K, S, W) != cd:
            fail(f"{name}: one ConvDims must serve both extents")
        x = torch.randn((B, H, W, N), generator=gen, device="cuda")
        w = (0.5 / (K * N**0.5)) * torch.randn((K, K, N, M), generator=gen, device="cuda")
        b = 0.1 * torch.randn((M,), generator=gen, device="cuda")
        scale = (1.0 + 0.1 * torch.randn((M,), generator=gen, device="cuda")) if affine else None
        packed = ops.prepack_conv(w, cd)
        cells = ops.conv_cells_from_image(x, cd)
        pos_idx = ops.conv_packed_layout(cd)[0]
        C = len(pos_idx)
        HO, WO = cd.out_size(H), cd.out_size(W)
        ty, tx = -(-HO // 2), -(-WO // 2)
        gy, gx = cells.shape[1], cells.shape[2]
        geo = dict(pos_idx=pos_idx, m=2, n=4, ty=ty, tx=tx, s2=S * S)
        fkw = dict(epilogue=act, scale=scale, bias=b, emit_cells=emit_cells)
        gs = torch.randn((B, ty, tx, 4, M), generator=gen, device="cuda")
        runs = {
            "fwd": (lambda: ops.winograd_conv2d_cells(cells, packed, cd, (H, W), **fkw),
                    lambda: ops.winograd_conv2d_cells(cells, packed, cd, (H, W), backend="ref", **fkw)),
            "bwd_x": (lambda: engine.conv_fused_engine_bwd_x(gs, packed.ww, packed.inv, gy=gy, gx=gx, **geo),
                      lambda: engine.conv_fused_engine_bwd_x_plain(gs, packed.ww, packed.inv, gy=gy, gx=gx, **geo)),
            "bwd_w": (lambda: engine.conv_fused_engine_bwd_w(cells, gs, packed.inv, **geo),
                      lambda: engine.conv_fused_engine_bwd_w_plain(cells, gs, packed.inv, **geo)),
        }
        errs = {}
        for key, (run, plain) in runs.items():
            got = run()
            torch.cuda.synchronize()
            want = plain()
            if tuple(got.shape) != tuple(want.shape):
                fail(f"conv {key} at {name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
            err = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"conv {key} kernel vs plain at {name}: max|err| {err:.3e} > {tol:.3e}")
            errs[key] = (err, tol, got.numel())
            bitwise_repeat(f"conv {key} at {name}", run, got)
        if name in NAN_CASES:  # NaN weights, through the forward's relu epilogue
            packed_nan = packed._replace(ww=poison(packed.ww))
            emit({"phase": "kernel_conv", "nan_case": nan_case(
                f"conv_fused_engine at {name}",
                lambda: ops.winograd_conv2d_cells(cells, packed_nan, cd, (H, W), **fkw),
                lambda: ops.winograd_conv2d_cells(cells, packed_nan, cd, (H, W), backend="ref", **fkw))})
        if i == 1:  # conv1 (64 -> 128): each wrapper refuses a misaligned operand, and launches again after it
            fwd = dict(out_mode="nhwc", out_h=HO, out_w=WO, **geo)
            emit({"phase": "kernel_conv", "misaligned_refusals": [
                refuses_misaligned("conv_fused_engine", lambda: engine.conv_fused_engine(
                    misaligned(cells), packed.ww, packed.inv, **fwd),
                    lambda: engine.conv_fused_engine(cells, packed.ww, packed.inv, **fwd)),
                refuses_misaligned("conv_fused_engine_bwd_x", lambda: engine.conv_fused_engine_bwd_x(
                    misaligned(gs), packed.ww, packed.inv, gy=gy, gx=gx, **geo), runs["bwd_x"][0]),
                refuses_misaligned("conv_fused_engine_bwd_x", lambda: engine.conv_fused_engine_bwd_x(
                    gs, misaligned(packed.ww), packed.inv, gy=gy, gx=gx, **geo), runs["bwd_x"][0]),
                refuses_misaligned("conv_fused_engine_bwd_w", lambda: engine.conv_fused_engine_bwd_w(
                    cells, misaligned(gs), packed.inv, **geo), runs["bwd_w"][0])]})

        # the yardsticks, which the port never calls: cuDNN through F.conv2d
        # on the SAME-padded NCHW image, aten's convolution_backward
        xc = x.permute(0, 3, 1, 2).contiguous()
        pads = (cd.padding, cd.pad_hi, cd.padding, cd.pad_hi)
        xp = F.pad(xc, pads)
        wt = w.permute(3, 2, 0, 1).contiguous()
        go = torch.randn((B, M, HO, WO), generator=gen, device="cuda")

        def lib_fwd():
            y = F.conv2d(xp, wt, stride=S).permute(0, 2, 3, 1)
            return epilogue_apply_ref(y, scale, b, act)

        got_img = runs["fwd"][0]()
        if emit_cells:
            got_img = got_img.reshape(B, ty, tx, 2, 2, M).permute(0, 1, 3, 2, 4, 5).reshape(
                B, 2 * ty, 2 * tx, M)[:, :HO, :WO]
        lib_img = lib_fwd()
        lib_err = (got_img - lib_img).abs().max().item()
        if not lib_err <= 1e-4 * lib_img.abs().max().item() + 1e-5:
            fail(f"conv kernel vs F.conv2d at {name}: max|err| {lib_err:.3e}")
        conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
            go, xp, wt, None, [S, S], [0, 0], [1, 1], False, [0, 0], 1, mask)
        libs = {"fwd": (lib_fwd, "F.conv2d (cuDNN) + epilogue"),
                "bwd_x": (lambda: conv_bwd([True, False, False]), "aten convolution_backward, input grad"),
                "bwd_w": (lambda: conv_bwd([False, True, False]),
                          "aten convolution_backward, raw-weight grad (not the packed one)")}

        T = B * ty * tx
        # products, the B-transforms or their transposes (32 adds per tile,
        # phase and channel), the inverse transform or gw (fold_adds over
        # one group of all C positions), the epilogue (3 per output) or the
        # overlap sum
        products = 2 * T * C * N * M
        prod = products + 32 * T * S * S * N
        inv_np = packed.inv.cpu()
        fold, gw = T * M * fold_adds(inv_np, [(0, C)]), T * M * fold_adds(inv_np, [(0, C)], True)
        dcells_n = B * gy * gx * S * S * 4 * N
        work = {
            "fwd": (4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + errs["fwd"][2]
                         + M * (2 if affine else 1)), prod + fold + 3 * errs["fwd"][2]),
            "bwd_x": (4 * (gs.numel() + packed.ww.numel() + packed.inv.numel() + dcells_n),
                      prod + gw + overlap_adds(B, S * S, N, ty, tx)),
            "bwd_w": (4 * (cells.numel() + gs.numel() + packed.inv.numel() + C * N * M), prod + gw),
        }
        for key, (run, plain) in runs.items():
            n_bytes, n_ops = work[key]
            t_bytes, t_ops = 1e3 * n_bytes / bytes_peak, 1e3 * n_ops / flops_peak
            lib, lib_note = libs[key]
            _, _, ms, by_kernel = profiled_ms(run, reps=20, name=CONV_KERNELS[key])
            row = dict(kernel=f"conv_engine_{key}", name=name, B=B, H_in=H, W_in=W, N=N, M=M, C=C, T=T,
                       out_mode="cells" if emit_cells else "nhwc", activation=act,
                       max_abs_err=errs[key][0], tol=errs[key][1], err_share=errs[key][0] / errs[key][1], ms=ms,
                       ms_wall=event_median_ms(run, reps=20),
                       plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain conv {key} at {name}")[1],
                       library_ms=profiled_ms(lib, reps=20, what=f"library conv {key} at {name}")[1],
                       library_note=lib_note, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=n_bytes, ops=n_ops,
                       achieved_tflops=n_ops / (ms * 1e-3) / 1e12)
            if key == "fwd":
                row["library_max_abs_err"] = lib_err
            # the instantiation that ran, its bound and (backward) its plan
            row.update(mma_bound(n_bytes, n_ops, products,
                                 sorted(k for k in by_kernel if kernel_named(k, CONV_KERNELS[key])), peaks))
            if key == "bwd_x":  # the cell blocks' tile slots, and the blocks launched against the SMs
                R, Wc, TC, (BT, BN, mma) = engine._conv_bwd_x_plan(B, gy, gx, ty, tx, N, M, dev)
                use = bwd_x_block_use(B, gy, gx, ty, tx, R, Wc, TC, BT)
                blocks = use.pop("blocks") * -(-N // BN) * (S * S if mma else 1)
                row["plan"] = dict(R=R, W=Wc, TC=TC, BT=BT, BN=BN, tensor_cores=bool(mma), blocks=blocks,
                                   blocks_per_sm=blocks / sms, **use)
            elif key == "bwd_w":
                splits, _, _, tile = engine._conv_bwd_w_plan(B, ty, tx, N, M, S * S, C, dev)
                row["plan"] = bwd_w_plan(tile, splits, C, S * S, M)
                if name == CONV_RAGGED_SHAPE[0] and splits < 2:
                    fail(f"conv kernel 7 at the ragged shape ran unsplit (plan {row['plan']})")
            elif key == "fwd":  # the pass split over blocks
                sp, _, _, (_, npass, nslot, npos), _ = engine._conv_fwd_plan(B, ty, tx, N, M, tuple(pos_idx), S * S,
                                                                              dev)
                BT, BM, _, mma = engine._conv_fwd_conf(N, M, S * S)
                row["plan"] = dict(BT=BT, BM=BM, tensor_cores=bool(mma), splits=sp, passes=npass, slots=nslot,
                                   positions=npos, blocks=-(-T // BT) * -(-M // BM) * sp, sms=sms)
                if name == CONV_RAGGED_SHAPE[0] and sp < 2:
                    fail(f"conv kernel 3 at the ragged shape ran unsplit (plan {row['plan']})")
            # the tensor cores run the DCGAN layers of M >= 64: bwd_x at every layer, bwd_w and the forward
            # where N % 4 == 0 (conv1-3; conv0's RGB input on the CUDA cores)
            if name.startswith("dcgan."):
                ran_on(f"conv {key} at {name}", row["instantiation"], key == "bwd_x" or N % 4 == 0)
            emit({"phase": "kernel_conv", **row})
            rows.append(row)
        del x, w, packed, cells, gs, go, xc, xp
        torch.cuda.empty_cache()
    return rows


def _train_params(torch, cfg, seed):
    """Generator and discriminator params from ``seed`` with non-trivial
    batchnorm statistics and affines."""
    from repro_torch.models import gan as G

    gp = G.generator_init(cfg, seed=seed, device="cuda")
    dp = G.discriminator_init(cfg, seed=seed + 1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    for tree in (gp, dp):
        for k, bn in tree.items():
            if k.endswith("_bn"):
                c = bn["mean"].shape[0]
                bn["mean"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
                bn["var"] = 0.5 + torch.rand((c,), generator=g, device="cuda")
                bn["scale"] = 1.0 + 0.2 * torch.randn((c,), generator=g, device="cuda")
                bn["bias"] = 0.1 * torch.randn((c,), generator=g, device="cuda")
    return gp, dp


def first_moment_errs(first_k, first_r):
    """(leaf, max|err|, tol) of every step-1 gradient of both nets, as each
    run's AdamW took them (the first moment after one step from zero is (1 -
    b1) * g): per leaf 1e-3 of the leaf's largest value, a bias right before
    a batch-statistics BN (exact gradient zero, fp32 noise in both) 1e-5 of
    the net's largest."""
    for net, mk, mr in zip(("G", "D"), first_k, first_r):
        top = max(float(v.abs().max()) for leaf in mr.values() for v in leaf.values())
        for k, leaf in mr.items():
            for kk, want in leaf.items():
                exact_zero = kk == "b" and f"{k}_bn" in mr
                tol = 1e-5 * top if exact_zero else 1e-3 * float(want.abs().max())
                yield f"{net}.{k}.{kk}", float((mk[k][kk] - want).abs().max()), tol


def check_first_moments(first_k, first_r) -> float:
    """Fail unless every step-1 first moment is within its tolerance
    (``first_moment_errs``); returns the worst error as a share of its
    tolerance."""
    worst = 0.0
    for leaf, err, tol in first_moment_errs(first_k, first_r):
        if not err <= tol:
            fail(f"step-1 AdamW first moment of {leaf}: kernels vs plain {err:.3e} > {tol:.3e}")
        worst = max(worst, err / tol if tol > 0 else 0.0)
    return worst


# The activations with a kink, and their slope on the negative side
KINKS = {"relu": 0.0, "leaky_relu": 0.2}  # the leaky slope: models.layers / kernels.ref LEAKY_SLOPE
# A flip (an activation input on one side of its kink in the kernels' run and
# on the other in the plain run's) must lie within the forward tolerance of
# zero in both runs, |x| <= KINK_RTOL * max|x of its call| + KINK_ATOL; at
# most KINK_SHARE of a call's inputs may flip
KINK_RTOL, KINK_ATOL, KINK_SHARE = 1e-4, 1e-5, 1e-5


class Tap:
    """Stands in for a kernel wrapper ``fn`` of ``engine`` during a counted
    run: calls it, then ``hook(out, args, kwargs, launches it counted)``.
    Its launch counters are the wrapper's own (the wrapper counts through
    its module-level name)."""

    def __init__(self, fn, hook):
        self.__dict__.update(fn=fn, hook=hook)

    def __getattr__(self, name):
        return getattr(self.fn, name)

    def __setattr__(self, name, value):
        setattr(self.fn, name, value)

    def __call__(self, *a, **k):
        before = self.fn.launches
        out = self.fn(*a, **k)
        self.hook(out, a, k, self.fn.launches - before)
        return out


def _side(x, act):
    """Which side of ``act``'s kink each element of ``x`` takes: True where
    the identity (x >= 0 for leaky_relu, as models.layers.leaky_relu; x > 0
    for relu)."""
    return x >= 0 if act == "leaky_relu" else x > 0


def _epilogue_image(name: str, out, kw):
    """A kernel's epilogue output as the plain version's epilogue sees its
    input (kernels/ref.py): the uncropped image of the deconv corner
    (B, 2S ty, 2S tx, M) and the conv corner (B, 2 ty, 2 tx, M), the 1D
    engine's padded interleave as it is; and the mask of the pixels the
    output holds (None: all)."""
    import torch

    if name == "winograd_conv1d_fused_engine":
        return out, None
    S, P = (kw["stride"], kw["padding"]) if name == "fused_engine" else (1, 0)
    B, M, H, W = out.shape[0], out.shape[-1], 2 * S * kw["ty"], 2 * S * kw["tx"]
    if kw["out_mode"] == "cells":
        img = out.reshape(B, H // 2, W // 2, 2, 2, M).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, M)
    else:
        img = out.new_zeros((B, H, W, M))
        img[:, P : P + kw["out_h"], P : P + kw["out_w"]] = out
    valid = torch.zeros((1, H, W, 1), dtype=torch.bool, device=out.device)
    valid[:, P : P + kw["out_h"], P : P + kw["out_w"]] = True
    return img, valid


@contextlib.contextmanager
def kink_sides(calls: list, follow: list | None = None):
    """Within it, every call of an activation with a kink (relu, leaky_relu)
    appends (act, x, side, valid) to ``calls``: the sites the models run
    (models.layers' ``leaky_relu`` and ``ACTIVATIONS``, models.gan's
    ``_AUDIO_ACTS``), the plain versions' epilogues (kernels/ref.py's
    ``epilogue_apply_ref``, as engine.py and ops.py import it too) and the
    kernels' epilogues (the three forward wrappers of ``engine``, whose
    output's sign gives the side: the input is the output, or for
    leaky_relu's negative side the output over the slope; a relu output of 0
    leaves it unknown, NaN).  With ``follow`` (the calls of a run made
    under this context) the i-th call takes follow[i]'s side wherever that
    run's output held the element, so that its output and derivative are
    those of the other run's side; a call past the end of ``follow``, of
    another activation or shape fails.  Calls are matched by order."""
    import torch

    from repro_torch.kernels import engine, ops, ref
    from repro_torch.models import gan, layers

    def activation(x, act, real):
        side = _side(x, act)
        if follow is None:
            calls.append((act, x.detach().clone(), side, None))
            return real(x)
        i = len(calls)
        if i >= len(follow) or follow[i][0] != act or follow[i][1].shape != x.shape:
            fail(f"kink call {i} ({act}, {tuple(x.shape)}) does not match the kernel run's "
                 f"{'(none)' if i >= len(follow) else (follow[i][0], tuple(follow[i][1].shape))}")
        _, _, theirs, valid = follow[i]
        calls.append((act, x.detach().clone(), side, valid))
        taken = theirs if valid is None else torch.where(valid, theirs, side)
        return torch.where(taken, x, KINKS[act] * x)

    real_epi = ref.epilogue_apply_ref

    def epilogue(y, scale, bias, act):
        if act not in KINKS:
            return real_epi(y, scale, bias, act)
        return activation(real_epi(y, scale, bias, "none"), act, lambda x: real_epi(x, None, None, act))

    def kernel_epilogue(name):
        def hook(out, a, kw, launched):  # (a CPU tensor took the plain version, whose epilogue recorded itself)
            act = kw.get("activation", "none")
            if act in KINKS and out.is_cuda:
                img, valid = _epilogue_image(name, out.detach(), kw)
                x = torch.where(img >= 0, img, img / KINKS[act]) if act == "leaky_relu" else \
                    torch.where(img > 0, img, float("nan"))
                calls.append((act, x, _side(img, act), valid))
        return hook

    real_leaky = layers.leaky_relu
    patches = [(d, k, functools.partial(activation, act=k, real=d[k])) for d in (layers.ACTIVATIONS, gan._AUDIO_ACTS)
               for k in KINKS]
    patches += [(m, "epilogue_apply_ref", epilogue) for m in (ref, engine, ops)]
    patches.append((layers, "leaky_relu",
                    lambda x, slope=0.2: activation(x, "leaky_relu", lambda v: real_leaky(v, slope))))
    if follow is None:
        patches += [(engine, n, Tap(getattr(engine, n), kernel_epilogue(n)))
                    for n in ("fused_engine", "conv_fused_engine", "winograd_conv1d_fused_engine")]

    def put(d, k, v):
        if isinstance(d, dict):
            d[k] = v
        else:
            setattr(d, k, v)

    saved = [(d, k, d[k] if isinstance(d, dict) else getattr(d, k)) for d, k, _ in patches]
    try:
        for d, k, v in patches:
            put(d, k, v)
        yield calls
    finally:
        for d, k, v in saved:
            put(d, k, v)


def compare_kinks(kernel_calls: list, plain_calls: list) -> dict:
    """Hold the flips between a kernel run's activation calls and the plain
    run's made under ``kink_sides(plain_calls, follow=kernel_calls)``: the
    same calls in the same order, each flip within the forward tolerance of
    zero in both runs (KINK_RTOL, KINK_ATOL; a kernel input that its relu
    epilogue left unknown is held on the plain side alone), at most
    KINK_SHARE of a call's inputs flipped.  Returns the readings: the calls,
    the flips (in all and by call), the largest flipped |x| over its call's
    standard deviation and as a share of its bound."""
    import torch

    if len(kernel_calls) != len(plain_calls):
        fail(f"the kernel run made {len(kernel_calls)} kink calls, the plain run {len(plain_calls)}")
    flips, by_call, over_std, share = 0, [], 0.0, 0.0
    for i, ((act, xk, sk, valid), (act_p, xp, sp, _)) in enumerate(zip(kernel_calls, plain_calls)):
        if act != act_p or xk.shape != xp.shape:
            fail(f"kink call {i}: {act} {tuple(xk.shape)} in the kernel run, {act_p} {tuple(xp.shape)} in the plain run")
        held = torch.ones_like(sp) if valid is None else valid.expand_as(sp)
        flip = (sk != sp) & held
        n, of = int(flip.sum()), int(held.sum())
        if not n:
            continue
        if n > KINK_SHARE * of:
            fail(f"kink call {i} ({act}): {n} of {of} inputs on the other side (at most {KINK_SHARE:g} of them)")
        std = float(xp[held].std())
        for run, x in (("kernels", xk), ("plain", xp)):
            ax = torch.where(held, x.abs(), 0.0).nan_to_num(0.0)
            bound = KINK_RTOL * float(ax.max()) + KINK_ATOL
            at = x.abs()[flip]
            at = at[~torch.isnan(at)]
            if not at.numel():
                continue
            top = float(at.max())
            if not top <= bound:
                fail(f"kink call {i} ({act}): an input on the other side at |x| {top:.3e} in the {run} run "
                     f"> {bound:.3e} (the forward tolerance of zero)")
            share, over_std = max(share, top / bound), max(over_std, top / std)
        flips += n
        by_call.append(dict(call=i, act=act, flips=n, of=of))
    return dict(kink_calls=len(kernel_calls), kink_flips=flips, kink_flips_by_call=by_call,
                max_flip_abs_over_std=over_std, max_flip_share_of_bound=share)


def train_phase(torch, card, conv_impl="lax", deconv_impl="cuda_chained", tag=None, fwd_named=None):
    """3 DCGAN train steps at batch 128 with the generator on the kernels
    (``deconv_impl`` "cuda_chained": kernels 3, 6, 7; "cuda_prepacked", per
    layer: kernels 1, 4, 5) and the discriminator on ``conv_impl`` ("lax":
    cuDNN; "cuda_chained" or per-layer "cuda_prepacked": the conv kernels)
    against the same 3 on the plain versions; launch counts per step and
    per gradient pull; then step time, idle share, peak memory and a check
    on the convolution kernels the step runs.  ``tag`` names its lines
    (by default from the impls); ``fwd_named``, the forward kernels its
    profile must show (by default the plans' choices at batch 128)."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch import data as D
    from repro_torch.configs import DCGAN
    from repro_torch.kernels import engine
    from repro_torch.models import gan as G
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, make_gan_step
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_leaves

    chained = conv_impl != "lax"  # the discriminator on the conv kernels
    per_layer_g = deconv_impl != "cuda_chained"
    tag = tag or ("train_per_layer" if per_layer_g else "train_chained" if chained else "train")
    names = ["fused_engine_epi", "fused_engine_bwd_x", "fused_engine_bwd_w"]  # rows of the kernels line
    want_step, want_g, want_d = (4, 4, 4), (0, 4, 4), (0, 0, 0)
    if per_layer_g:  # kernels 1, 4, 5 instead, and none of 3, 6, 7 at the deconv corner
        names = ["domain_engine", "domain_engine_bwd_x", "domain_engine_bwd_w"] + names
        want_step, want_g, want_d = (4, 4, 4, 0, 0, 0), (0, 4, 4, 0, 0, 0), (0,) * 6
    cfg = dataclasses.replace(DCGAN, deconv_impl=deconv_impl, conv_impl=conv_impl)
    # the conv wrappers' launches by discriminator layer, told apart by the
    # channels of their first argument (cells: N; bwd_x's g: M)
    conv_wrappers = {}
    if chained:
        names += ["conv_engine_fwd", "conv_engine_bwd_x", "conv_engine_bwd_w"]
        want_step += (8, 11, 12)
        want_g, want_d = want_g + (0, 4, 4), want_d + (0, 7, 8)
        chans_in, chans_out = (cfg.img_ch, *G.disc_channels(cfg)[:-1]), G.disc_channels(cfg)
        conv_wrappers = {"conv_fused_engine": ("fwd", chans_in), "conv_fused_engine_bwd_x": ("bwd_x", chans_out),
                         "conv_fused_engine_bwd_w": ("bwd_w", chans_in)}
    per_layer = {key: [0] * len(chans) for key, chans in conv_wrappers.values()}
    counts = lambda: tuple(read_counts()[n] for n in names)  # noqa: E731

    def by_layer(key, chans):
        """A Tap hook counting a conv wrapper's launches by layer."""
        def hook(out, a, kw, launched):
            per_layer[key][chans.index(a[0].shape[-1])] += launched
        return hook

    ref_of = {"cuda_chained": "chained_ref", "cuda_prepacked": "prepacked_ref", "lax": "lax"}
    plain = dict(deconv_impl=ref_of[deconv_impl], conv_impl=ref_of[conv_impl])
    settings = StepSettings()
    B, steps = TRAIN_BATCH, 3
    t0 = time.perf_counter()
    gp0, dp0 = _train_params(torch, cfg, seed=0)
    batches = [(D.latent_batch(0, s, B, cfg.z_dim, device="cuda"), D.gan_batch(0, s, B, cfg.img_hw, device="cuda"))
               for s in range(steps)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # record the kernels' launches around each gradient pull of the step,
    # and every F.conv2d call
    pulls, conv2d_calls = [], [0]
    real_grads, real_conv2d = T._grads, F.conv2d

    def recording_grads(loss, tree, *, retain_graph):
        before = counts()
        out = real_grads(loss, tree, retain_graph=retain_graph)
        torch.cuda.synchronize()
        pulls.append(tuple(a - b for a, b in zip(counts(), before)))
        return out

    def counting_conv2d(*a, **k):
        conv2d_calls[0] += 1
        return real_conv2d(*a, **k)

    def run(sides=contextlib.nullcontext, **impls):
        """The 3 steps; the first (whose gradients are held leaf by leaf)
        inside the context ``sides()``."""
        step = make_gan_step(cfg, settings=dataclasses.replace(settings, **impls))
        gp, dp = gp0, dp0
        g_opt, d_opt = adamw_init(gp), adamw_init(dp)
        per_step, metrics, first = [], [], None
        for s, (z, real) in enumerate(batches):
            before = counts()
            with sides() if s == 0 else contextlib.nullcontext():
                gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
            torch.cuda.synchronize()
            per_step.append(tuple(a - b for a, b in zip(counts(), before)))
            metrics.append({k: float(v) for k, v in m.items()})
            first = first or (g_opt.m, d_opt.m)
        return gp, dp, per_step, metrics, first

    # --- the main path: counts at 0 just before, read just after; in step 1
    # the side of every activation kink recorded (kink_sides)
    zero_counts()
    real_conv = {name: getattr(engine, name) for name in conv_wrappers}
    T._grads, F.conv2d = recording_grads, counting_conv2d
    for name, (key, chans) in conv_wrappers.items():
        setattr(engine, name, Tap(real_conv[name], by_layer(key, chans)))
    k_kinks = []
    try:
        gp_k, dp_k, per_step, m_k, first_k = run(lambda: kink_sides(k_kinks), deconv_impl=deconv_impl,
                                                 conv_impl=conv_impl)
    finally:
        T._grads, F.conv2d = real_grads, real_conv2d
        for name, fn in real_conv.items():
            setattr(engine, name, fn)
    launches = read_counts()
    check_counts(tag, launches, {n: steps * w for n, w in zip(names, want_step)})
    for key, n in per_layer.items():
        if sum(n) != launches["conv_engine_" + key]:
            fail(f"conv {key} launches by layer {n} do not add up to {launches}")
    if any(ps != want_step for ps in per_step):
        fail(f"kernel launches per train step ({', '.join(names)}) {per_step}, want {want_step} each")
    g_pulls, d_pulls = pulls[0::2], pulls[1::2]
    if any(p != want_g for p in g_pulls) or any(p != want_d for p in d_pulls):
        fail(f"launches per gradient pull: G {g_pulls}, D {d_pulls}; want {want_g} and {want_d}")
    if chained and conv2d_calls[0]:
        fail(f"the {conv_impl} discriminator called F.conv2d {conv2d_calls[0]} times")
    if not chained and conv2d_calls[0] != 8 * steps:
        fail(f"the lax step called F.conv2d {conv2d_calls[0]} times, want 8 per step")
    # the plain run's step 1 on the kernel run's side of each kink, the flips
    # bounded (steps 2-3 take their own sides: after one AdamW step the two
    # runs' parameters differ by up to a few lr, which the metrics' and the
    # parameters' tolerances hold); then on its own sides, a reading of what
    # the step-1 check would see unmasked
    p_kinks = []
    gp_r, dp_r, _, m_r, first_r = run(lambda: kink_sides(p_kinks, follow=k_kinks), **plain)
    kinks = compare_kinks(k_kinks, p_kinks)
    moment_share = check_first_moments(first_k, first_r)
    first_u = run(**plain)[4]
    unmasked_share = max(err / tol if tol > 0 else 0.0 for _, err, tol in first_moment_errs(first_k, first_u))
    del first_k, first_r, first_u, k_kinks, p_kinks  # not held into the peak-memory reading below

    worst = {}
    for s, (a, b) in enumerate(zip(m_k, m_r)):
        if a["nonfinite"] or b["nonfinite"]:
            fail(f"step {s}: non-finite metrics {a} / {b}")
        for key in ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm"):
            rel = abs(a[key] - b[key]) / max(abs(b[key]), 1e-12)
            worst[key] = max(worst.get(key, 0.0), rel)
            if not rel <= 1e-3:
                fail(f"step {s} {key}: kernels {a[key]!r} vs plain {b[key]!r} (rel {rel:.2e} > 1e-3)")
    bound = 6 * settings.lr
    leaves_k = tree_leaves(gp_k) + tree_leaves(dp_k)
    if not all(bool(torch.isfinite(x).all()) for x in leaves_k):
        fail("non-finite parameters after the kernel steps")
    param_err = max((x - y).abs().max().item() for x, y in zip(leaves_k, tree_leaves(gp_r) + tree_leaves(dp_r)))
    if not param_err <= bound:
        fail(f"parameters after {steps} steps differ by {param_err:.3e} > 6*lr = {bound:.1e}")
    emit({"phase": tag, "arch": "dcgan", "batch": B, "steps": steps, "deconv_impl": deconv_impl,
          "conv_impl": conv_impl, "kernels": names, "launches_per_step": per_step,
          "launches_per_pull": {"G": g_pulls, "D": d_pulls}, "f_conv2d_calls": conv2d_calls[0],
          "conv_launches_per_step_by_layer": {k: [v / steps for v in n] for k, n in per_layer.items()},
          "step1_first_moment_err_share_of_tol": moment_share,
          "step1_first_moment_err_share_of_tol_unmasked": unmasked_share, **kinks,
          "metrics": m_k, "metrics_plain": m_r, "plain_impls": plain, "max_rel_err_metrics": worst,
          "max_abs_err_params": param_err, "param_bound": bound, "setup_s": setup_s, "card": card})

    # --- speed (after the counted run)
    step = make_gan_step(cfg, settings=settings)
    state = [gp_k, dp_k, adamw_init(gp_k), adamw_init(dp_k)]
    z, real = batches[0]

    def one():
        state[:] = step(*state, z, real)[:4]

    torch.cuda.reset_peak_memory_stats()
    step_ms = wall_ms(one, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    prof_ms, dev_ms, _, by_kernel = profiled_ms(one, reps=5, warmup=1)
    idle = 1.0 - dev_ms / prof_ms
    if idle < 0.0:
        fail(f"device time {dev_ms:.4f} ms exceeds the wall time {prof_ms:.4f} ms it was taken in")
    library_convs = _library_convs(by_kernel)
    # the forward kernels by name: on the tensor cores where the plans put them (DCGAN's deconv0-2, conv1-3), the
    # CUDA-core kernel where they keep it (deconv3's and conv0's few channels)
    # (per layer: kernel 1's tensor-core kernel and its weight pack at deconv0-2, its few-channel kernel at deconv3)
    named = fwd_named or ([*FWD_KERNELS] if not per_layer_g else [*DOMAIN_FWD_MMA, "domain_fwd_few_kernel"]) \
        + ([*CONV_FWD_KERNELS] if chained else [])
    fwd_ms = {n: sum(v for k, v in by_kernel.items() if kernel_named(k, n)) for n in named}
    if not all(fwd_ms.values()):
        fail(f"the {tag} step's profile lacks forward kernels: {fwd_ms}")
    if chained and library_convs:
        fail(f"cuDNN or aten convolution kernels in the {tag} step's profile: {library_convs}")
    if not chained and not library_convs:  # the check's own control: the lax step does run cuDNN
        fail(f"no convolution kernel found in the lax step's profile: {sorted(by_kernel)[:20]}")
    ours = {k: v for k, v in by_kernel.items() if kernel_named(k, STEP_KERNELS)}
    plain_step = make_gan_step(cfg, settings=dataclasses.replace(settings, **plain))
    pstate = [gp_k, dp_k, adamw_init(gp_k), adamw_init(dp_k)]

    def one_plain():
        pstate[:] = plain_step(*pstate, z, real)[:4]

    plain_step_ms = wall_ms(one_plain, reps=3, warmup=1)
    emit({"phase": tag + "_rate", "batch": B, "step_ms": step_ms, "images_per_s": 1e3 * B / step_ms,
          "profiled_step_ms": prof_ms, "device_ms": dev_ms, "device_idle_share": idle,
          "engine_kernels_ms": sum(ours.values()), "engine_kernels": ours, "forward_kernels_ms": fwd_ms,
          "library_conv_kernels_ms": {k: by_kernel[k] for k in library_convs},
          "top_kernels": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
          "plain_step_ms": plain_step_ms, "max_memory_allocated": peak, "card": card})
    return dict(launches=launches, per_layer={k: [v / steps for v in n] for k, n in per_layer.items()},
                step_kernels=by_kernel)


# ------------------------------------------------------------------- autotune
# each CUDA wrapper's instantiation (engine.INSTANTIATIONS) -> the profiler's kernel names (kernel_named) and,
# where one template has several tensor-core instantiations, the template arguments that tell them apart
# (spaces dropped), as the source's with_*conf dispatch names them
_FWD_CORES = {"mma_64x128": "Core<2,8,2,2,9,4,1,1>", "mma_64x64": "Core<2,4,2,2,9,4,1,1>"}
INSTANTIATION_KERNELS = {
    "fused_engine": {"cuda_cores": (("fused_epi_kernel",), None),
                     **{n: (("fused_epi_mma_kernel",), c) for n, c in _FWD_CORES.items()}},
    "fused_engine_bwd_x": {"cuda_cores": (("bwd_x_kernel",), None), "mma_64x32": (("bwd_x_mma_kernel",), None)},
    "fused_engine_bwd_w": {"cuda_cores": (("bwd_w_kernel",), None), "mma_256x128": (("bwd_w_mma_kernel",), None)},
    "conv_fused_engine": {"cuda_cores": (("conv_fwd_kernel",), None),
                          **{n: (("conv_fwd_mma_kernel",), c) for n, c in _FWD_CORES.items()}},
    "conv_fused_engine_bwd_x": {"cuda_cores": (("conv_bwd_x_kernel",), None),
                                "mma_128x16": (("conv_bwd_x_mma_kernel",), "Core<16,4,1,4,8,2>"),
                                "mma_64x32": (("conv_bwd_x_mma_kernel",), "Core<16,4,2,2,8,2>")},
    "conv_fused_engine_bwd_w": {"cuda_cores": (("conv_bwd_w_kernel",), None),
                                "mma_128x128_t16": (("conv_bwd_w_mma_kernel",), "Core<2,4,4,4,16,4,4>"),
                                "mma_128x128_t8": (("conv_bwd_w_mma_kernel",), "Core<2,2,4,8,8,4,4>"),
                                "mma_64x128": (("conv_bwd_w_mma_kernel",), "Core<1,4,4,4,8,4,4>")},
    "domain_engine": {"cuda_cores": (("domain_fwd_kernel",), None), "mma_128x64": (DOMAIN_FWD_MMA, None),
                      "few_channels": (("domain_fwd_few_kernel",), None)},
    "domain_engine_bwd_x": {"cuda_cores": (("domain_bwd_x_kernel",), None),
                            "mma_64x32": (("domain_bwd_x_mma_kernel",), "Core<16,4,2,2,8,2>"),
                            "mma_rank1_128x64": (("domain_bwd_x_mma_kernel",), "Core<4,2,4,2,8"),
                            "mma_rank1_64x32": (("domain_bwd_x_mma_kernel",), "Core<16,2,2,1,8")},
    "domain_engine_bwd_w": {"cuda_cores": (("domain_bwd_w_kernel",), None),
                            "mma_256x128": (("domain_bwd_w_mma_kernel",), "Core<4,2,4,8,16,4,1>"),
                            "mma_rank1_256x128": (("domain_bwd_w_mma_kernel",), "Core<4,2,4,8,16,2,1>"),
                            "mma_rank1_128x64": (("domain_bwd_w_mma_kernel",), "Core<2,2,4,4,16,2,1>")},
    "winograd_conv1d_fused_engine": {"cuda_cores": (("engine1d_kernel",), None),
                                     "mma_64x128": (("engine1d_mma_kernel",), "Core<2,4,2,4,9,2,2,1>"),
                                     "mma_64x64": (("engine1d_mma_kernel",), "Core<2,4,2,2,9,2,2,2>")},
}
AUTOTUNE_REPEATS, AUTOTUNE_SEED = 5, 0


def shows_instantiation(by_kernel, kernel: str, conf: str) -> bool:
    """Whether a profile's kernel names hold ``kernel``'s instantiation
    ``conf``: its kernel (kernel_named) with its template arguments."""
    names, sig = INSTANTIATION_KERNELS[kernel][conf]
    return any(kernel_named(k, names) and (sig is None or sig in k.replace(" ", "")) for k in by_kernel)


@contextlib.contextmanager
def logged_launches(engine):
    """The engine's ``Launch`` records of the CUDA launches made inside the
    block: each wrapper's instantiation, split and plan at its shape."""
    engine.launch_log = log = []
    try:
        yield log
    finally:
        engine.launch_log = None


def table_agrees_with_plans(engine, launches) -> int:
    """At every logged (kernel, shape): each instantiation, and each split
    count (1, 2, 4, 8, 64 and past the grid's 65535), is accepted by the
    table (``engine.request``) exactly where the C plan at that shape
    accepts it (``Launch.plan``: ValueError where it refuses); fails
    otherwise.  Returns the requests compared."""
    n, seen = 0, set()
    for rec in launches:
        key = (rec.kernel, tuple(sorted(rec.shape.items())))
        if key in seen:
            continue
        seen.add(key)
        for k, conf in enumerate(engine.INSTANTIATIONS[rec.kernel]):
            for sp in (None, 1, 2, 4, 8, 64, 70000):
                try:
                    engine.request(rec.kernel, conf, sp, **rec.shape)
                    table = True
                except ValueError:
                    table = False
                try:
                    rec.plan(k, -1 if sp is None else sp)
                    c_plan = True
                except ValueError:
                    c_plan = False
                if table != c_plan:
                    fail(f"{rec.kernel} {conf} splits={sp} at {rec.shape}: the table "
                         f"{'takes' if table else 'refuses'} it, the C plan {'takes' if c_plan else 'refuses'} it")
                n += 1
    return n


def _plain_outputs(torch, fwd, leaf, set_leaf, x, mode):
    """The plain version's outputs of a timed function: the forward, or
    (sum(y^2), its gradients in ``leaf`` and in ``x``), as the timed
    function's grad mode gives them."""
    if mode == "fwd":
        with torch.no_grad():
            return (fwd(x, set_leaf(leaf)),)
    lf, xg = leaf.detach().requires_grad_(True), x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = fwd(xg, set_leaf(lf)).float().square().sum()
        g, dx = torch.autograd.grad(loss, (lf, xg))
    return loss.detach(), g, dx


def _held_outputs(what, got, want, mode) -> float:
    """Fail unless ``got`` (a candidate's timed outputs) agree with the
    plain version's: the forward within 1e-4 * max|ref| + 5e-5, the loss
    within 1e-4 relative, each gradient (the weights', the input's) within
    1e-4 * max|ref| + 1e-5.
    Returns the largest share of its tolerance an output used."""
    got = got if isinstance(got, tuple) else (got,)
    if len(got) != len(want):
        fail(f"{what}: {len(got)} outputs, the plain version {len(want)}")
    share = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or a.shape != b.shape:
            fail(f"{what}: output {i} {None if a is None else tuple(a.shape)} vs plain {tuple(b.shape)}")
        err = (a.float() - b.float()).abs().max().item()
        ref = b.float().abs().max().item()
        tol = (1e-4 * ref + 5e-5) if mode == "fwd" else (1e-4 * ref if i == 0 else 1e-4 * ref + 1e-5)
        if not err <= tol:
            fail(f"{what}: output {i} max|err| {err:.3e} > {tol:.3e} against the plain version")
        share = max(share, err / tol)
    return share


def _one_axis_candidates(engine, base, kernels, split_conf, bwd_w_conf, grad: bool, extra=()):
    """The sweep of one layer: the plan's own choice (``base``), ``extra``,
    each instantiation of the forward kernel, the split counts 1, 2, 4 on
    ``split_conf`` (the forward's instantiation that splits; None: no split
    axis), then in grad mode each backward instantiation and bwd_w's T
    splits on ``bwd_w_conf`` (the plan's own); one axis varied a candidate;
    the library baseline (None) last, so that its plain PyTorch calls come
    after every kernel's."""
    rep = dataclasses.replace
    cands = [base, *extra]
    cands += [rep(base, conf=c) for c in engine.INSTANTIATIONS[kernels[0]]]
    if split_conf is not None:
        cands += [rep(base, conf=split_conf, splits=k) for k in (1, 2, 4)]
    if grad:
        cands += [rep(base, bwd_x_conf=c) for c in engine.INSTANTIATIONS[kernels[1]]]
        cands += [rep(base, bwd_w_conf=c) for c in engine.INSTANTIATIONS[kernels[2]]]
        cands += [rep(base, bwd_w_conf=bwd_w_conf, bwd_w_splits=k) for k in (1, 2, 4)]
    return list(dict.fromkeys(cands + [None]))


def _same_as_plan(cfg, kernels, plan_confs) -> bool:
    """Whether ``cfg`` launches what the plans choose: every instantiation it
    names is its plan's, and it forces no split."""
    named = zip(kernels, (cfg.conf, cfg.bwd_x_conf, cfg.bwd_w_conf))
    return cfg.splits is None and cfg.bwd_w_splits is None and cfg.epilogue is None and not cfg.emit_cells and all(
        c is None or c == plan_confs.get(k) for k, c in named)


def _config_dict(cfg) -> dict:
    """An EngineConfig's fields that are set (None and False dropped)."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if v not in (None, False)}


def _sweep_row(torch, A, engine, *, family, layer, geom, shape, c_out, mode, base, kernels, plain_fwd, make_packed,
               extra=(), card):
    """One layer's sweep at one batch and mode: the plan's own choice run
    once with its launches logged (the table held against the C plans
    there, every instantiation and split), then every candidate: the C
    plan's verdict and, for those it takes, the outputs (in grad mode both
    gradients) held against the plain version, the wrappers' log held to
    the forced instantiations and the profile to every logged one and, where
    it forces a split, a second run bitwise equal to the first, before
    ``autotune_*`` times them all in two rounds.  Prints the layer's row:
    each candidate's ms (the faster round), the plan's choice and its ms
    (the fastest of the candidates that launch what the plans choose: the
    plan's own and those naming its instantiations), the fastest candidate
    that launches something else and its margin over the plan's (negative:
    the plan's is faster), the library baseline's ms, and two spreads: the
    rounds' (the median relative difference of a candidate's two rounds) and
    the plan's (max / min - 1 over the candidates that run the plan's
    launches: the same work timed apart)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    make_timed = {"deconv": A.make_timed_fn, "conv": A.make_timed_conv_fn, "conv1d": A.make_timed_conv1d_fn}[family]
    autotune = {"deconv": A.autotune_deconv, "conv": A.autotune_conv, "conv1d": A.autotune_conv1d}[family]
    rng = np.random.default_rng(AUTOTUNE_SEED)  # the autotuner's own draws, in its order
    wshape = (geom.kernel,) * (1 if family == "conv1d" else 2)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda")
    w = torch.as_tensor(rng.standard_normal((*wshape, shape[-1], c_out)), dtype=torch.float32, device="cuda")
    packed = make_packed(w)
    set_leaf = lambda leaf: type(packed)(leaf, packed.inv)  # noqa: E731

    # the plan's own choice: its launches, the table against the C plans there, the instantiations they ran
    fn, make_args = make_timed(base, geom, mode)
    with logged_launches(engine) as launched:
        fn(*make_args(x, w))
        torch.cuda.synchronize()
    compared = table_agrees_with_plans(engine, launched)
    plan_confs = {}
    for rec in launched:
        plan_confs.setdefault(rec.kernel, rec.conf)
    if any(k not in plan_confs for k in (kernels if mode == "grad" else kernels[:1])):
        fail(f"autotune {layer} {mode}: the plan's run launched {sorted(plan_confs)}, not each of {kernels}")
    fwd_conf = plan_confs[kernels[0]]
    split_conf = {"deconv": "cuda_cores", "conv": fwd_conf if fwd_conf != "cuda_cores" else None}.get(family)
    cands = _one_axis_candidates(engine, base, kernels, split_conf, plan_confs.get(kernels[-1]), mode == "grad",
                                 extra)

    # every candidate: the C plan's verdict, then its outputs and instantiations, before any timing
    plain, verdicts, resessions = {}, {}, 0
    for cfg in cands[:-1]:
        forced = [(kernels[0], cfg.conf)]
        if mode == "grad":
            forced += [(kernels[1], cfg.bwd_x_conf), (kernels[2], cfg.bwd_w_conf)]
        fn, make_args = make_timed(cfg, geom, mode)
        what = f"autotune {layer} b{shape[0]} {mode} {_config_dict(cfg)}"
        # each launch the wrappers logged must show in the profile (its instantiation's kernel); the tracer has
        # been seen to drop a session's events (profiled_ms): a session that lacks a logged launch is noted with
        # the log and run again, up to three sessions
        for attempt in range(3):
            try:
                with logged_launches(engine) as launched, profile(activities=[ProfilerActivity.CUDA]) as prof:
                    got = fn(*make_args(x, w))
                    torch.cuda.synchronize()
            except ValueError as e:  # the C plan refuses it (and the table does too: held above)
                verdicts[cfg] = dict(ok=False, error=str(e)[:200])
                break
            ran_confs = {(rec.kernel, rec.conf) for rec in launched}
            unlaunched = [(k, c) for k, c in forced if c is not None and (k, c) not in ran_confs]
            if unlaunched:
                fail(f"{what}: the wrappers launched {sorted(ran_confs)}, not {unlaunched}")
            ran = {e.key for e in prof.key_averages() if e.device_time_total > 0}
            missing = sorted({(k, c) for k, c in ran_confs if not shows_instantiation(ran, k, c)})
            if not missing:
                break
            emit({"note": f"profiler session {attempt + 1} lacks {missing}", "for": what,
                  "launched": sorted(ran_confs), "device_kernels": len(ran)})
            resessions += 1
            time.sleep(0.2 * (attempt + 1))
        else:
            fail(f"{what}: the profile lacks {missing} in 3 sessions, which the wrappers launched: {sorted(ran)}")
        if cfg in verdicts:
            continue
        key = (cfg.epilogue, cfg.emit_cells)
        if key not in plain:
            plain[key] = _plain_outputs(torch, lambda xx, pp, c=cfg: plain_fwd(xx, pp, c), packed.ww, set_leaf, x,
                                        mode)
        share = _held_outputs(what, got, plain[key], mode)
        repeated = cfg.splits is not None or cfg.bwd_w_splits is not None
        if repeated:  # a forced split: its own scratch, its counters back at 0, and what it sums (the forward, the
            again = fn(*make_args(x, w))  # loss, the weights' gradient) bitwise repeatable
            if not all(torch.equal(a, b) for a, b in zip((got if isinstance(got, tuple) else (got,))[:2],
                                                          (again if isinstance(again, tuple) else (again,))[:2])):
                fail(f"{what}: two runs of a forced split differ")
            del again
        verdicts[cfg] = dict(ok=True, err_share=share, repeated=repeated)
        del got

    # the timing: autotune_* in two rounds, each the best of AUTOTUNE_REPEATS calls; a candidate's ms the faster
    rounds = [autotune(geom, shape, c_out, candidates=cands, mode=mode, repeats=AUTOTUNE_REPEATS,
                       seed=AUTOTUNE_SEED, device="cuda") for _ in range(2)]
    ms = {}
    for r in rounds[0] + rounds[1]:
        ms.setdefault(r["config"], []).append(r["ms"] if r["ok"] else None)
    for r in rounds[0]:
        cfg = r["config"]
        if cfg is not None and r["ok"] != verdicts[cfg]["ok"]:
            fail(f"autotune {layer} {mode} {_config_dict(cfg)}: the sweep's row ok={r['ok']} ({r['error']}), "
                 f"the check's {verdicts[cfg]}")
    spreads = [abs(a - b) / min(a, b) for a, b in ms.values() if a is not None and b is not None]
    best = {cfg: None if None in v else min(v) for cfg, v in ms.items()}
    ran = [c for c in cands[:-1] if best[c] is not None]
    same = [c for c in ran if _same_as_plan(c, kernels, plan_confs)]
    other = [c for c in ran if c not in same and c.epilogue is None and not c.emit_cells]
    plan_ms = min(best[c] for c in same)
    winner = min(other, key=lambda c: best[c]) if other else None
    summary = dict(phase="autotune", family=family, layer=layer, batch=shape[0], mode=mode,
                   variant=("fused_pre" if base.fuse_pre else "unfused") if family == "deconv" else family,
                   plan_choice=plan_confs, plan_ms=plan_ms,
                   winner=None if winner is None else _config_dict(winner),
                   winner_ms=None if winner is None else best[winner],
                   margin=None if winner is None else plan_ms / best[winner] - 1.0, library_ms=best[None],
                   spread=statistics.median(spreads) if spreads else None,
                   plan_spread=max(best[c] for c in same) / plan_ms - 1.0, table_checks=compared,
                   profiler_resessions=resessions,
                   candidates=[dict(config=None if c is None else _config_dict(c), ms=best[c], rounds_ms=ms[c],
                                    same_as_plan=c is not None and c in same, **verdicts.get(c, {})) for c in cands],
                   card=card)
    emit(summary)
    return summary


def autotune_phase(torch, card):
    """kernels/autotune.py at DCGAN's published widths and the audio
    decoder's: every kernel's instantiations and splits as the sweeps run
    them (the table against the C plans, outputs against the plain
    versions, profiles against the named instantiations, then timed in two
    rounds), the block table installed for the per-layer train step
    (train_tuned: the per-layer phase's checks, no tolerance moved) and a
    batch-8 generate with the table tuned at batch 128 against the same
    generate without it.  Returns the train_tuned run's launches."""
    from repro_torch.configs import DCGAN
    from repro_torch.configs.musicgen_medium import audio_decoder
    from repro_torch.kernels import autotune as A
    from repro_torch.kernels import engine, ops
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine

    G.clear_deconv_blocks()
    rows = []
    # --- the generator's four layers: unfused (kernels 1, 4, 5) and fused pre-PE (kernels 2, 6, 7), at the
    # training batch with the gradient and at the serving batch forward
    variants = ((False, ("domain_engine", "domain_engine_bwd_x", "domain_engine_bwd_w")),
                (True, ("fused_engine", "fused_engine_bwd_x", "fused_engine_bwd_w")))
    h, g_layers = DCGAN.seed_hw, []
    for i, d in enumerate(DCGAN.deconvs):
        g_layers.append((f"dcgan.deconv{i}", d.dims, h, d.c_in, d.c_out))
        h = d.dims.out_size(h)
    for batch, mode in ((TRAIN_BATCH, "grad"), (8, "fwd")):
        for name, dims, H, N, M in g_layers:
            for fused, kernels in variants:
                rows.append(_sweep_row(
                    torch, A, engine, family="deconv", layer=name, geom=dims, shape=(batch, H, H, N), c_out=M,
                    mode=mode, base=A.EngineConfig(fused, prepack=True), kernels=kernels,
                    plain_fwd=lambda xx, pp, cfg, dims=dims: ops.winograd_deconv2d_packed(
                        xx, pp, dims, backend="ref", fuse_pre=cfg.fuse_pre),
                    make_packed=lambda w, dims=dims: ops.prepack(w, dims), card=card))
                torch.cuda.empty_cache()
    # --- the discriminator's four layers at the training batch, with the epilogue and emit-cells axes
    conv_winners, hw = [], DCGAN.img_hw
    chans = (DCGAN.img_ch, *G.disc_channels(DCGAN))
    for i, cd in enumerate(G.disc_conv_dims(DCGAN)):
        N, M = chans[i], chans[i + 1]
        extra = (A.EngineConfig(True, prepack=True, epilogue="leaky_relu"),
                 A.EngineConfig(True, prepack=True, epilogue="leaky_relu", emit_cells=True))
        summary = _sweep_row(
            torch, A, engine, family="conv", layer=f"dcgan.conv{i}", geom=cd, shape=(TRAIN_BATCH, hw, hw, N),
            c_out=M, mode="grad", base=A.EngineConfig(True, prepack=True),
            kernels=("conv_fused_engine", "conv_fused_engine_bwd_x", "conv_fused_engine_bwd_w"),
            plain_fwd=lambda xx, pp, cfg, cd=cd: ops.winograd_conv2d_packed(
                xx, pp, cd, backend="ref", epilogue=cfg.epilogue, emit_cells=cfg.emit_cells),
            make_packed=lambda w, cd=cd: ops.prepack_conv(w, cd), extra=extra, card=card)
        rows.append(summary)
        # the per-layer discriminator's conv runs nhwc with its bias: its winner among the candidates without
        # an epilogue axis
        plain_out = [c for c in summary["candidates"] if c["config"] is not None and c["ms"] is not None
                     and "epilogue" not in c["config"]]
        best = min(plain_out, key=lambda c: c["ms"])["config"]
        conv_winners.append((cd, N, M, {k: v for k, v in best.items() if k in G._BLOCK_KEYS}))
        hw = cd.out_size(hw)
        torch.cuda.empty_cache()
    # --- the audio decoder's three layers at batch 16 and 1 (kernel 9)
    for batch in (AUDIO_BATCH, 1):
        L = AUDIO_FRAMES
        for i, spec in enumerate(audio_decoder(width=AUDIO_WIDTH)):
            rows.append(_sweep_row(
                torch, A, engine, family="conv1d", layer=f"audio.deconv{i}", geom=spec.dims,
                shape=(batch, L, spec.c_in), c_out=spec.c_out, mode="fwd", base=A.EngineConfig(True, prepack=True),
                kernels=("winograd_conv1d_fused_engine",),
                plain_fwd=lambda xx, pp, cfg, dims=spec.dims: ops.winograd_deconv1d_packed(xx, pp, dims, backend="ref"),
                make_packed=lambda w, dims=spec.dims: ops.prepack_deconv1d(w, dims), card=card))
            L = spec.dims.out_size(L)
        torch.cuda.empty_cache()

    # the tally of the checks above: candidates held (in grad mode with both gradients), refused, forced splits
    # run twice, the table-vs-plan requests, profiler sessions run again
    cands = [c for r in rows for c in r["candidates"] if c["config"] is not None]
    held = [c for c in cands if c.get("ok")]
    emit({"phase": "autotune_checks", "rows": len(rows), "candidates": len(cands), "held": len(held),
          "held_with_input_gradient": sum(c.get("ok", False) for r in rows if r["mode"] == "grad"
                                          for c in r["candidates"] if c["config"] is not None),
          "refused": sum(c.get("ok") is False for c in cands), "split_repeats": sum(c["repeated"] for c in held),
          "max_err_share": max(c["err_share"] for c in held), "table_checks": sum(r["table_checks"] for r in rows),
          "profiler_resessions": sum(r["profiler_resessions"] for r in rows), "card": card})
    # --- the block table: install_tuned_blocks for cuda_prepacked at batch 128 (grad; its default grid, every
    # candidate of which the sweep above held), the discriminator's winners by hand
    cfg = dataclasses.replace(DCGAN, deconv_impl="cuda_prepacked", conv_impl="cuda_prepacked")
    t0 = time.perf_counter()
    installed = G.install_tuned_blocks(cfg, mode="grad", batch=TRAIN_BATCH, repeats=AUTOTUNE_REPEATS, device="cuda")
    if any("config" not in r for r in installed):
        fail(f"install_tuned_blocks installed no winner at some layer: {installed}")
    for cd, N, M, blocks in conv_winners:
        G.set_deconv_blocks("cuda_prepacked", cd, N, M, **blocks)
    emit({"phase": "autotune_install", "seconds": time.perf_counter() - t0,
          "installed": [{**r, "config": _config_dict(r["config"])} for r in installed],
          "table": [dict(impl=k[0], dims=f"{type(k[1]).__name__}{dataclasses.astuple(k[1])}", N=k[2], M=k[3],
                         blocks=v) for k, v in G.DECONV_BLOCKS.items()], "card": card})
    tuned = {}
    try:
        # the forward kernels the tuned step's profile must show: each layer's installed instantiation or, where
        # the entry leaves it to the plan, the plan's at batch 128
        named = set()
        for r, d in zip(installed, DCGAN.deconvs):
            conf = r["config"].conf or ("mma_128x64" if d.c_out >= 16 else "few_channels")
            named.add(INSTANTIATION_KERNELS["domain_engine"][conf][0][0])
        for cd, N, M, blocks in conv_winners:
            conf = blocks.get("conf") or ("cuda_cores" if N % 4 else "mma_64x64")
            named.add(INSTANTIATION_KERNELS["conv_fused_engine"][conf][0][0])
        tuned = train_phase(torch, card, "cuda_prepacked", "cuda_prepacked", tag="train_tuned",
                            fwd_named=sorted(named))

        # a batch-8 generate (chained=False, kernel 1) with the table tuned at batch 128, and without it
        eng = GanServeEngine(_serve_params(torch), dataclasses.replace(DCGAN, deconv_impl="pallas_prepacked"),
                             batch=8, device="cuda", chained=False)
        z = torch.randn((8, DCGAN.z_dim), generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
        plain_cfg = dataclasses.replace(eng.cfg, deconv_impl="prepacked_ref")
        table = dict(G.DECONV_BLOCKS)
        with torch.inference_mode():
            want_img, _ = G.generator_apply(eng.params, plain_cfg, z)
            zero_counts()
            got = eng.generate(z)
            torch.cuda.synchronize()
            check_counts("autotune: the tuned batch-8 generate", read_counts(), {"domain_engine": 4})
            err = (got - want_img).abs().max().item()
            tol = 1e-4 * want_img.abs().max().item() + 1e-5
            if not err <= tol:
                fail(f"the tuned batch-8 generate vs prepacked_ref: max|err| {err:.3e} > {tol:.3e}")
            times = {"tuned": [], "plan": []}
            for turn in ("tuned", "plan", "plan", "tuned"):  # in turns, in this call
                G.DECONV_BLOCKS.clear()
                if turn == "tuned":
                    G.DECONV_BLOCKS.update(table)
                times[turn].append(dict(ms=event_median_ms(lambda: eng.generate(z), reps=30),
                                        kernel1_ms=profiled_ms(lambda: eng.generate(z), reps=20,
                                                               name=DOMAIN_FWD_KERNELS)[2]))
        emit({"phase": "autotune_serve_b8", "max_abs_err_vs_plain": err, "tol": tol, "tuned": times["tuned"],
              "plan": times["plan"],
              "tuned_ms": statistics.mean(t["ms"] for t in times["tuned"]),
              "plan_ms": statistics.mean(t["ms"] for t in times["plan"]),
              "entries": [G.DECONV_BLOCKS.get(("cuda_prepacked", d.dims, d.c_in, d.c_out)) for d in DCGAN.deconvs],
              "card": card})
        del eng
    finally:
        G.clear_deconv_blocks()
    torch.cuda.empty_cache()
    return dict(launches=tuned.get("launches"))


# ----------------------------------------------------------------- train_mesh
MESH_STEPS = 3
MESH_BUCKETS = (None, 16 << 20)  # the overlap step's plans: the default (4 MiB: 4 G buckets) and 16 MiB (2)
MESH_GAN = dict(steps=4, ckpt_every=2, fault_at=3)  # train_gan on the world-2 mesh
MESH_SEED = 0
MESH_DEVICE, MESH_W1_BACKEND = "cuda", "nccl"  # every rank on the one card; world 1 on NCCL
MESH_LR = 2e-4


def _mesh_cfg():
    import dataclasses

    from repro_torch.configs import DCGAN

    return dataclasses.replace(DCGAN, deconv_impl="cuda_chained", conv_impl="cuda_chained")


def _mesh_batches(torch, cfg):
    from repro_torch import data as D

    return [(D.latent_batch(MESH_SEED, s, TRAIN_BATCH, cfg.z_dim, device=MESH_DEVICE),
             D.gan_batch(MESH_SEED, s, TRAIN_BATCH, cfg.img_hw, device=MESH_DEVICE)) for s in range(MESH_STEPS)]


def _host(tree):
    """A tree (dicts, NamedTuples: OptState, the LM caches) with every
    tensor on the host."""
    import torch

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(v) for v in tree))
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def leaf_diffs(got, want) -> dict:
    """The largest |difference| of every leaf of two (G, D) param pairs."""
    out = {}
    for net, a, b in (("G", got[0], want[0]), ("D", got[1], want[1])):
        for k, leaf in a.items():
            for kk, v in leaf.items():
                out[f"{net}.{k}.{kk}"] = float((v.float() - b[k][kk].float().to(v.device)).abs().max())
    return out


def metric_errs(got: dict, want: dict, compressed: bool) -> dict:
    """One step's metric differences: relative (train_chained's 1e-3), or
    with compression the losses' absolute (the reference's 2e-2)."""
    keys = ("g_loss", "d_loss") if compressed else ("g_loss", "d_loss", "g_grad_norm", "d_grad_norm")
    return {k: abs(got[k] - want[k]) if compressed else abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
            for k in keys}


def hold_step(where: str, metrics: dict, want_metrics: dict, params, want_params, problems: list,
              compressed: bool = False) -> dict:
    """Hold one step's metrics and the params after it against the
    single-device step's: metrics 1e-3 relative and params 6·lr (the
    train_chained checks), or with compression the reference's 2e-2 on the
    losses and 5e-3 (absolute plus relative) on the params.  Misses go to
    ``problems`` (the phase fails on them after its readings).  Returns
    the metric differences and the largest param difference."""
    errs = metric_errs(metrics, want_metrics, compressed)
    if metrics["nonfinite"] or want_metrics["nonfinite"]:
        problems.append(f"{where}: non-finite metrics {metrics} / {want_metrics}")
    for k, e in errs.items():
        if not e <= (2e-2 if compressed else 1e-3):
            problems.append(f"{where} {k}: {metrics[k]!r} vs the single-device step's {want_metrics[k]!r}")
    diffs = leaf_diffs(params, want_params)
    for net, a, b in (("G", params[0], want_params[0]), ("D", params[1], want_params[1])):
        for k, leaf in a.items():
            for kk, v in leaf.items():
                w = b[k][kk].to(v.device)
                bound = (5e-3 + 5e-3 * w.abs()) if compressed else 6 * MESH_LR
                if not bool(((v - w).abs() <= bound).all()):
                    problems.append(f"{where}: {net}.{k}.{kk} differs by {diffs[f'{net}.{k}.{kk}']:.3e} from the "
                                    "single-device step's")
    return dict(metric_err=errs, max_param_err=max(diffs.values()), leaf_max_abs_err=diffs)


def _single_step_fn(cfg, impls=None):
    from repro_torch.train import StepSettings, make_gan_step

    return make_gan_step(cfg, settings=StepSettings(lr=MESH_LR, b1=0.5, **(impls or {})))


def _single_steps(torch, cfg, gp0, dp0, batches, impls=None, kinks=None, follow=None):
    """``make_gan_step``'s single-device steps from gp0 / dp0 (``impls``: the
    plain versions' names), step 1 inside ``kink_sides(kinks, follow)``."""
    from repro_torch.optim import adamw_init

    step = _single_step_fn(cfg, impls)
    gp, dp = gp0, dp0
    g_opt, d_opt = adamw_init(gp), adamw_init(dp)
    metrics, first = [], None
    for s, (z, real) in enumerate(batches):
        with kink_sides(kinks, follow) if (s == 0 and kinks is not None) else contextlib.nullcontext():
            gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
        metrics.append({k: float(v) for k, v in m.items()})
        first = first or (g_opt.m, d_opt.m)
    return dict(metrics=metrics, gp=gp, dp=dp, first=first, step=step)


def mesh_steps(torch, mesh, cfg, gp0, dp0, batches, variant, bucket_bytes=None, kinks=None, timings=None,
               teacher=None, problems=None, where="", ref_grads=None):
    """``len(batches)`` steps of a sharded step on ``mesh`` from the full
    params ``gp0`` / ``dp0`` and the global batches: variant "mesh"
    (make_gan_step(mesh=)), "overlap" (build_gan_comm_step at
    ``bucket_bytes``, None: the default) or "int8" (the same, compressed).
    Step 1 runs inside ``kink_sides(kinks)`` when ``kinks`` is a list;
    ``timings`` (a dict) records each bucket's all-reduce ms.

    With ``teacher`` (a single-device step) every step is also held, on
    rank 0, against the teacher's step from the same full params and
    optimizer state (gathered before the step) on the global batch
    (``hold_step``, misses to ``problems``): the function each step
    computes, apart from the trajectory.  With ``ref_grads`` (the
    uncompressed step-1 reduced gradients) the int8 step's step-1 reduced
    gradient is held to error feedback's identity: plus the ranks' mean
    residual it is the uncompressed mean.

    Returns the metrics, the full params after the last step (gathered), the
    step-1 first moments (gathered), each step's launches of every kernel
    (the sharded step's alone), the step's meta, the per-step readings
    against the teacher, the int8 identity's error and the step itself."""
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import overlap as OV
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import flat_leaves
    from repro_torch.train import StepSettings, make_gan_step

    B = batches[0][0].shape[0]
    kw = {} if bucket_bytes is None else {"bucket_bytes": bucket_bytes}
    if variant == "mesh":
        step = make_gan_step(cfg, settings=StepSettings(lr=MESH_LR, b1=0.5, mesh=mesh, batch=B))
    else:
        step, _ = OV.build_gan_comm_step(cfg, mesh, batch=B, lr=MESH_LR, b1=0.5, timings=timings,
                                         grad_compression="int8" if variant == "int8" else None, **kw)
    meta = step.meta
    gsp, dsp, gosp, dosp = meta["specs"]
    zspec, rspec = meta["batch_specs"]
    blk = lambda tree, sp: SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), tree, sp)  # noqa: E731
    full = lambda tree, sp: SH.map_specs(lambda t, s: SH.gather(t, s, mesh), tree, sp)  # noqa: E731
    gp, dp = blk(gp0, gsp), blk(dp0, dsp)
    g_opt, d_opt = adamw_init(gp), adamw_init(dp)
    comm = OV.init_comm_state(*meta["param_structs"], mesh, **kw) if variant == "int8" else None
    metrics, first, per_step, forced, identity = [], None, [], [], None
    for s, (z_full, real_full) in enumerate(batches):
        z, real = SH.block_of(z_full, zspec, mesh), SH.block_of(real_full, rspec, mesh)
        if teacher is not None:
            state = (full(gp, gsp), full(dp, dsp), full(g_opt, gosp), full(d_opt, dosp))
            taught = teacher(*state, z_full, real_full) if mesh.rank == 0 else None
            del state
        before = read_counts()
        with kink_sides(kinks) if (s == 0 and kinks is not None) else contextlib.nullcontext():
            if comm is not None:
                gp, dp, g_opt, d_opt, comm, m = step(gp, dp, g_opt, d_opt, comm, z, real)
            else:
                gp, dp, g_opt, d_opt, m = step(gp, dp, g_opt, d_opt, z, real)
        torch.cuda.synchronize()
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        metrics.append({k: float(v) for k, v in m.items()})
        if teacher is not None:
            got = (full(gp, gsp), full(dp, dsp))
            if mesh.rank == 0:
                forced.append(hold_step(f"{where} step {s} (from the same state)", metrics[-1],
                                        {k: float(v) for k, v in taught[4].items()}, got, taught[:2], problems,
                                        compressed=variant == "int8"))
                forced[-1].pop("leaf_max_abs_err")
            del got, taught
        if first is None:
            first = (full(g_opt.m, gsp), full(d_opt.m, dsp))
            if ref_grads is not None:  # error feedback's identity at step 1, bucket by bucket
                res = [SH.gather(r, sp, mesh) for r, sp in zip((*comm.g_res, *comm.d_res),
                                                                  (*meta["comm_specs"].g_res, *meta["comm_specs"].d_res))]
                k, worst = 0, 0.0
                for plan, mine, ref in ((meta["g_plan"], first[0], ref_grads[0]), (meta["d_plan"], first[1], ref_grads[1])):
                    ml, rl = flat_leaves(mine), flat_leaves(ref)
                    for idxs in plan.buckets:
                        got_v = torch.cat([ml[i].reshape(-1) / 0.5 for i in idxs]) + res[k].mean(0)
                        want_v = torch.cat([rl[i].reshape(-1).to(got_v.device) / 0.5 for i in idxs])
                        worst = max(worst, float((got_v - want_v).abs().max() / want_v.abs().max()))
                        k += 1
                identity = worst
                if not worst <= 1e-5:
                    problems.append(f"{where}: step 1's int8 reduced gradient plus the mean residual is "
                                    f"{worst:.3e} of the bucket's largest from the uncompressed mean")
    res_max = None if comm is None else max(float(r.abs().max()) for r in (*comm.g_res, *comm.d_res))
    return dict(metrics=metrics, gp=full(gp, gsp), dp=full(dp, dsp), first=first, per_step=per_step, meta=meta,
                residual_max=res_max, forced=forced, identity=identity, step=step,
                state=(gp, dp, g_opt, d_opt, comm), batch=(z, real))


def hold_run(where: str, run: dict, ref: dict, problems: list, compressed: bool = False) -> dict:
    """Hold a sharded run's trajectory against the single-device one: step
    1's metrics (both from the same params: train_chained's 1e-3 relative,
    int8 the reference's 2e-2) and, uncompressed, the params after the last
    step (6·lr).  Later steps' metrics are readings: from step 2 on the two
    trajectories part by AdamW's ±lr on near-zero gradients (at DCGAN's
    widths the step-3 g_loss is 9.1e-5, and the synced BN's rounding alone
    moves it 2e-3 relative), so ``mesh_steps``'s ``teacher`` holds each
    step's function from one state instead.  int8's trajectory leaves the
    uncompressed one at these widths (one scale a bucket rounds a tenth or
    more of the step-1 gradient to zero, elements that AdamW then leaves
    where the uncompressed step moves them by lr), so its params are held
    from one state only."""
    errs = metric_errs(run["metrics"][0], ref["metrics"][0], compressed)
    for k, e in errs.items():
        if not e <= (2e-2 if compressed else 1e-3):
            problems.append(f"{where} step 0 {k}: {run['metrics'][0][k]!r} vs the single-device step's "
                            f"{ref['metrics'][0][k]!r}")
    diffs = leaf_diffs((run["gp"], run["dp"]), (ref["gp"], ref["dp"]))
    if not compressed and not max(diffs.values()) <= 6 * MESH_LR:
        worst = max(diffs, key=diffs.get)
        problems.append(f"{where}: {worst} differs by {diffs[worst]:.3e} > 6·lr from the single-device run after "
                        f"{len(run['metrics'])} steps")
    return dict(metric_err_by_step=[metric_errs(a, b, compressed) for a, b in zip(run["metrics"], ref["metrics"])],
                max_param_err=max(diffs.values()), leaf_max_abs_err=diffs)


def _zero_share(first) -> float:
    """The share of a run's step-1 reduced gradient elements that are 0."""
    from repro_torch.tree import flat_leaves

    leaves = flat_leaves(first[0]) + flat_leaves(first[1])
    return sum(int((t == 0).sum()) for t in leaves) / sum(t.numel() for t in leaves)


def _mesh_rank(rank, world, backend, shape, axes, store, out, job):
    """One rank of a spawned world on cuda:0: joins the group through the
    FileStore ``store``, builds the mesh and runs ``job`` ("w2" or "w4"),
    writing its results (host tensors) to ``out`` + its rank."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # one host: the ranks talk over the loopback device
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import make_mesh

    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = make_mesh(shape, axes, device=MESH_DEVICE)
        res = _mesh_job(torch, mesh, job)
        torch.save(res, f"{out}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _mesh_job(torch, mesh, job) -> dict:
    """A spawned world's work (``_mesh_rank``): the overlap step, counted
    (the main path: counts at 0 just before, read just after; at world 2
    step 1's kink sides recorded), then the overlap and the int8 step each
    held step by step against the single-device step from the same state
    (rank 0), the int8 step-1 identity; at world 2 also the step ms, one
    step with each bucket's all-reduce timed, then train_gan clean, through
    a fault and resumed, and B's checkpoint restored onto the mesh."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.optim import adamw_init
    from repro_torch.parallel import overlap as OV
    from repro_torch.parallel import sharding as SH
    from repro_torch.train import StepSettings, TrainFaultPlan, train_gan
    from repro_torch.train import checkpoint as C

    cfg = _mesh_cfg()
    gp0, dp0 = _train_params(torch, cfg, seed=MESH_SEED)
    batches = _mesh_batches(torch, cfg)
    out, problems = {}, []
    kinks = [] if job == "w2" else None
    zero_counts()
    ov = mesh_steps(torch, mesh, cfg, gp0, dp0, batches, "overlap", kinks=kinks)
    out["launches"] = read_counts()  # the main path: counts at 0 just before, read just after
    teacher = _single_step_fn(cfg)
    where = f"train_mesh {job} rank {mesh.rank}"
    forced = mesh_steps(torch, mesh, cfg, gp0, dp0, batches, "overlap", teacher=teacher, problems=problems,
                        where=f"{where} overlap")
    i8 = mesh_steps(torch, mesh, cfg, gp0, dp0, batches, "int8", teacher=teacher, problems=problems,
                    where=f"{where} int8", ref_grads=ov["first"])
    for name, r in (("overlap", ov), ("int8", i8)):
        out[name] = dict(metrics=r["metrics"], gp=_host(r["gp"]), dp=_host(r["dp"]), per_step=r["per_step"],
                         first=tuple(_host(t) for t in r["first"]) if name == "overlap" else None,
                         residual_max=r["residual_max"], g_buckets=len(r["meta"]["g_plan"].buckets),
                         d_buckets=len(r["meta"]["d_plan"].buckets), wire=r["meta"]["wire"],
                         fallbacks=r["meta"]["fallbacks"], zero_share=_zero_share(r["first"]),
                         forced=(forced if name == "overlap" else r)["forced"], identity=r["identity"])
    out["problems"] = problems
    if kinks is not None:
        out["kinks"] = [(act, x.cpu(), side.cpu(), None if valid is None else valid.cpu())
                        for act, x, side, valid in kinks]
    state, (z, real) = list(ov["state"][:4]), ov["batch"]

    def one():
        state[:] = ov["step"](*state, z, real)[:4]

    out["step_ms"] = wall_ms(one, reps=3, warmup=1)
    # the gather a step opens with, on its own: both nets' blocks to full leaves
    gsp, dsp, _, _ = ov["meta"]["specs"]
    full = lambda tree, sp: SH.map_specs(lambda t, s: SH.gather(t, s, mesh), tree, sp)  # noqa: E731
    out["gather_ms"] = wall_ms(lambda: (full(state[0], gsp), full(state[1], dsp)), reps=3, warmup=1)
    del ov, i8, forced, kinks, state, one
    if job != "w2":
        return out
    # each bucket's all-reduce, one step on its own (a measurement mode)
    timings = {}
    tm = mesh_steps(torch, mesh, cfg, gp0, dp0, batches[:2], "overlap", timings=timings)
    out["bucket_ms"] = {k: v[-1] for k, v in timings.items()}
    out["bucket_numels"] = {"g": list(tm["meta"]["g_plan"].numels), "d": list(tm["meta"]["d_plan"].numels)}
    del tm
    # train_gan on the mesh: A clean, B a raise at fault_at (restore, replay), C resuming B's step-2 checkpoint
    root = os.environ["MESH_CKPT_ROOT"]
    kw = dict(steps=MESH_GAN["steps"], batch=TRAIN_BATCH, seed=MESH_SEED, ckpt_every=MESH_GAN["ckpt_every"],
              log_every=1, handle_signals=False, device=MESH_DEVICE,
              settings=StepSettings(lr=MESH_LR, b1=0.5, mesh=mesh))
    runs = {}
    for name in ("A", "B", "C"):
        plan = TrainFaultPlan(kind="raise", at_step=MESH_GAN["fault_at"], max_faults=1) if name == "B" else None
        if name == "C":
            if mesh.rank == 0:
                os.makedirs(os.path.join(root, "C"))
                shutil.copytree(os.path.join(root, "B", "step_000000000002"),
                                os.path.join(root, "C", "step_000000000002"))
            dist.barrier()
        before = read_counts()
        r = train_gan(cfg, ckpt_dir=os.path.join(root, name), fault_plan=plan, **kw)
        after = read_counts()
        runs[name] = dict(metrics=r["metrics"], counters=r["counters"], fault_log=r["fault_log"],
                          final_step=r["final_step"], gp=_host(r["params"]["gp"]), dp=_host(r["params"]["dp"]),
                          launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
    # B's step-2 checkpoint onto the (2,) mesh with shardings=: each rank its blocks
    gp_s, dp_s = OV.param_structs(cfg, torch.float32)
    like = {"gp": gp_s, "dp": dp_s, "g_opt": adamw_init(gp_s), "d_opt": adamw_init(dp_s)}
    gsp, dsp, _ = SH.gan_param_specs(cfg, mesh)
    placed = SH.named(mesh, {"gp": gsp, "dp": dsp, "g_opt": SH.opt_specs(gsp), "d_opt": SH.opt_specs(dsp)})
    blocks = C.restore_checkpoint(os.path.join(root, "B"), 2, like, shardings=placed)
    whole = dict(C._flatten(C.restore_checkpoint(os.path.join(root, "B"), 2, like, device=MESH_DEVICE)))
    where_of = dict(C._flatten(placed))
    mismatched, split = [], 0
    for key, b in C._flatten(blocks):
        w = whole[key]
        if isinstance(w, torch.Tensor):
            split += b.shape != w.shape
            if not torch.equal(b, SH.block_of(w, where_of[key].spec, mesh)):
                mismatched.append(key)
    runs["restore_blocks_mismatched"], runs["restore_split_leaves"] = mismatched, split
    out["train_gan"] = runs
    out["serve_mesh"] = _serve_mesh_job(torch, mesh)
    return out


SERVE_MESH_BATCH = 8


def _serve_mesh_z(torch):
    return torch.randn((SERVE_MESH_BATCH, 100), generator=torch.Generator(device="cuda").manual_seed(5),
                       device="cuda")


def _serve_mesh_job(torch, mesh) -> dict:
    """Sharded residency on a spawned world's mesh: DCGAN at its published
    widths (the serve phase's params), chained, GanServeEngine(mesh=) at
    batch 8; one counted generate (the main path: counts at 0 just
    before, read just after), this rank's bytes at rest against the whole
    tree's, the generate's ms (its gather included) and the gather's alone.
    Every rank makes the same calls (the gathers are collectives)."""
    from repro_torch.configs import DCGAN
    from repro_torch.models import gan as G
    from repro_torch.serve import GanServeEngine
    from repro_torch.tree import tree_leaves

    eng = GanServeEngine(_serve_params(torch), DCGAN, batch=SERVE_MESH_BATCH, mesh=mesh)
    res = eng.archs[DCGAN.arch_id]
    z = _serve_mesh_z(torch)
    zero_counts()
    img = eng.generate(z)
    torch.cuda.synchronize()
    launches = read_counts()
    whole = sum(t.numel() * t.element_size() for t in tree_leaves(G.gather_params(res.params, res.specs, mesh)))
    return dict(img=img.cpu(), launches=launches, resident_bytes=res.resident_bytes(), whole_bytes=whole,
                generate_ms=wall_ms(lambda: eng.generate(z), reps=5, warmup=1),
                gather_ms=wall_ms(lambda: G.gather_params(res.params, res.specs, mesh), reps=5, warmup=1))


def _spawn_world(torch, world, shape, axes, job, root):
    """Run ``job`` on a spawned gloo world of ``world`` ranks on this card;
    the ranks' results."""
    import os

    import torch.multiprocessing as tmp

    store, out = os.path.join(root, f"store_{job}"), os.path.join(root, f"out_{job}_")
    os.environ["MESH_CKPT_ROOT"] = os.path.join(root, "ckpt")
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, "gloo", shape, axes, store, out, job))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 400
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail(f"train_mesh: the {job} world's ranks exited with {codes} (a rank failed, or hung past 400 s)")
    return [torch.load(f"{out}{r}.pt", weights_only=False) for r in range(world)]


def _merge_kinks(per_rank: list) -> list:
    """The ranks' step-1 kink records as one global batch's: each call's
    inputs and sides concatenated over the ranks' rows (a mask without a
    batch dimension is the same on every rank)."""
    import torch

    merged = []
    for calls in zip(*per_rank):
        act = calls[0][0]
        if any(c[0] != act for c in calls):
            fail(f"train_mesh: the ranks' kink calls differ: {[c[0] for c in calls]}")
        valid = calls[0][3]
        if valid is not None and valid.shape[0] != 1:
            valid = torch.cat([c[3] for c in calls])
        merged.append((act, torch.cat([c[1] for c in calls]).to(MESH_DEVICE), torch.cat([c[2] for c in calls]).to(
            MESH_DEVICE), None if valid is None else valid.to(MESH_DEVICE)))
    return merged


def train_mesh_phase(torch, card):
    """The sharded train steps and train_gan on a mesh, DCGAN at its
    published widths, batch 128 global, both nets cuda_chained, fp32, TF32
    off, AdamW lr 2e-4, b1 0.5 (see the module docstring).  Returns the
    launches of every kernel of the world-2 counted overlap run's rank 0
    (its main path)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import make_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepSettings, train_gan

    cfg = _mesh_cfg()
    t0 = time.perf_counter()
    problems: list = []  # checks missed: the phase fails on them after its readings
    gp0, dp0 = _train_params(torch, cfg, seed=MESH_SEED)
    batches = _mesh_batches(torch, cfg)
    ref = _single_steps(torch, cfg, gp0, dp0, batches)  # the single-device kernel steps every world is held to
    ref_host = dict(metrics=ref["metrics"], gp=_host(ref["gp"]), dp=_host(ref["dp"]))

    # --- 1: world 1 on NCCL, in this process
    root = tempfile.mkdtemp(prefix="train_mesh_")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(MESH_W1_BACKEND, store=dist.FileStore(os.path.join(root, "store_w1"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1,), ("data",), device=MESH_DEVICE)
        w1, first_ov = {}, None
        variants = [("mesh", "mesh", None)] + [(f"overlap_{b or 'default'}", "overlap", b) for b in MESH_BUCKETS] \
            + [("int8", "int8", None)]
        for name, variant, bb in variants:
            where = f"train_mesh world 1 {name}"
            r = mesh_steps(torch, mesh, cfg, gp0, dp0, batches, variant, bucket_bytes=bb, teacher=ref["step"],
                           problems=problems, where=where, ref_grads=first_ov if variant == "int8" else None)
            if variant == "overlap" and first_ov is None:
                first_ov = r["first"]
            held = hold_run(where, r, ref, problems, compressed=variant == "int8")
            if any(ps != TRAIN_GAN_LAUNCHES for ps in r["per_step"]):
                problems.append(f"{where}: launches per step {r['per_step']}, want {TRAIN_GAN_LAUNCHES}")
            w1[name] = dict(held, forced=r["forced"], g_buckets=len(r["meta"]["g_plan"].buckets),
                            d_buckets=len(r["meta"]["d_plan"].buckets), residual_max=r["residual_max"],
                            int8_identity=r["identity"], step1_grad_zero_share=_zero_share(r["first"]))
            if variant == "overlap" and w1[name]["g_buckets"] < 2:
                problems.append(f"{where}: {w1[name]['g_buckets']} generator bucket(s), want more than one")
            if variant == "int8" and not r["residual_max"] > 0:
                problems.append(f"{where}: the residuals stayed 0")
            # the machinery's cost: the step ms against the single-device step in this call
            state, (z, real), step = list(r["state"]), r["batch"], r["step"]

            def one(step=step, state=state, z=z, real=real):
                if state[4] is not None:
                    state[:] = step(*state[:5], z, real)[:5]
                else:
                    state[:4] = step(*state[:4], z, real)[:4]

            w1[name]["step_ms"] = wall_ms(one, reps=5, warmup=2)
            if variant == "overlap" and bb is None:
                _, dev_ms, _, by_kernel = profiled_ms(one, reps=3, warmup=1, what="the world-1 overlap step")
                w1[name]["profiled_device_ms"] = dev_ms
                w1[name]["nccl_and_copies_ms"] = {k: v for k, v in by_kernel.items()
                                                  if "nccl" in k.lower() or "memcpy" in k.lower()}
            del r, state, step, one
        sstate = [ref["gp"], ref["dp"], adamw_init(ref["gp"]), adamw_init(ref["dp"])]

        def single(state=sstate, z=batches[0][0], real=batches[0][1]):
            state[:] = ref["step"](*state, z, real)[:4]

        single_ms = wall_ms(single, reps=5, warmup=2)
        del sstate, single, first_ov
    finally:
        dist.destroy_process_group()
    emit({"phase": "train_mesh_world1", "backend": MESH_W1_BACKEND, "world": 1, "mesh": {"data": 1},
          "batch": TRAIN_BATCH, "steps": MESH_STEPS, "arch": "dcgan", "impls": "cuda_chained/cuda_chained",
          "runs": w1, "single_device_step_ms": single_ms, "single_device_metrics": ref["metrics"], "card": card})

    # --- 2: world 2 (and 4) on gloo, every rank on this card, CUDA tensors
    worlds = {"w2": (2, (2,), ("data",)), "w4": (4, (2, 2), ("data", "model"))}
    results = {job: _spawn_world(torch, *spec, job, root) for job, spec in worlds.items()}
    for job, ranks in results.items():
        world, shape, axes = worlds[job]
        readings = {}
        for rank, r in enumerate(ranks):
            problems += r["problems"]
            for name in ("overlap", "int8"):
                got = r[name]
                if name == "overlap" and any(ps != TRAIN_GAN_LAUNCHES for ps in got["per_step"]):
                    problems.append(f"train_mesh {job} rank {rank}: launches per step {got['per_step']}, "
                                    f"want {TRAIN_GAN_LAUNCHES}")
                held = hold_run(f"train_mesh {job} rank {rank} {name}", got, ref_host, problems,
                                compressed=name == "int8")
                if rank == 0:
                    readings[name] = dict(held, forced=got["forced"], int8_identity=got["identity"],
                                          g_buckets=got["g_buckets"], d_buckets=got["d_buckets"],
                                          residual_max=got["residual_max"], fallbacks=got["fallbacks"],
                                          step1_grad_zero_share=got["zero_share"])
            if not r["int8"]["residual_max"] > 0:
                problems.append(f"train_mesh {job} rank {rank}: the int8 residuals stayed 0")
        emit({"phase": f"train_mesh_{job}", "backend": "gloo (CUDA tensors, no host staging)", "world": world,
              "mesh": dict(zip(axes, shape)), "ranks_on": "cuda:0, every rank", "batch": TRAIN_BATCH,
              "rows_per_rank": TRAIN_BATCH // shape[0], "steps": MESH_STEPS,
              "launches_per_rank_step": ranks[0]["overlap"]["per_step"][0], "runs": readings,
              "overlap_step_ms_by_rank": [r["step_ms"] for r in ranks],
              "param_gather_ms_by_rank": [r["gather_ms"] for r in ranks], "wire_report": ranks[0]["int8"]["wire"],
              "card": card})
    # step 1 of the world-2 overlap run against the plain step on its kink sides
    w2 = results["w2"]
    k_kinks = _merge_kinks([r["kinks"] for r in w2])
    p_kinks = []
    plain = _single_steps(torch, cfg, gp0, dp0, batches[:1], impls=dict(deconv_impl="chained_ref",
                                                                         conv_impl="chained_ref"),
                          kinks=p_kinks, follow=k_kinks)
    kinks = compare_kinks(k_kinks, p_kinks)
    first_mesh = tuple({k: {kk: v.to(MESH_DEVICE) for kk, v in leaf.items()} for k, leaf in t.items()}
                       for t in w2[0]["overlap"]["first"])
    moment_share = check_first_moments(first_mesh, plain["first"])
    del k_kinks, p_kinks, plain, first_mesh
    tg, bitwise = w2[0]["train_gan"], True
    for rank, r in enumerate(w2):
        runs = r["train_gan"]
        for name in ("B", "C"):
            diffs = leaf_diffs((runs[name]["gp"], runs[name]["dp"]), (runs["A"]["gp"], runs["A"]["dp"]))
            if runs[name]["metrics"] != runs["A"]["metrics"] or any(diffs.values()):
                bitwise = False
                problems.append(f"train_mesh rank {rank}: train_gan run {name} does not end on the clean run's bits")
        if runs["B"]["counters"]["restores"] != 1 or [(e["step"], e["action"]) for e in runs["B"]["fault_log"]] != \
                [(MESH_GAN["fault_at"], "restore")]:
            problems.append(f"train_mesh rank {rank}: the fault run's accounting {runs['B']['counters']} "
                            f"{runs['B']['fault_log']}")
        if runs["restore_blocks_mismatched"] or not runs["restore_split_leaves"]:
            problems.append(f"train_mesh rank {rank}: B's checkpoint onto the mesh: "
                            f"{runs['restore_blocks_mismatched']} leaves differ from their blocks, "
                            f"{runs['restore_split_leaves']} split")
        calls = {"A": MESH_GAN["steps"], "B": MESH_GAN["steps"] + 1, "C": MESH_GAN["steps"] - 2}  # B replays step 2
        for name, n in calls.items():
            want = {k: n * v for k, v in TRAIN_GAN_LAUNCHES.items()}
            if runs[name]["launches"] != want:
                problems.append(f"train_mesh rank {rank}: train_gan {name} launched {runs[name]['launches']}, "
                                f"want {want}")
    # B's step-2 checkpoint resumed on one device (no mesh): step 3 from step 2's state is held as a step, step 4
    # and the params as the trajectory (hold_run)
    os.makedirs(os.path.join(root, "ckpt", "D"))
    shutil.copytree(os.path.join(root, "ckpt", "B", "step_000000000002"),
                    os.path.join(root, "ckpt", "D", "step_000000000002"))
    one = train_gan(cfg, steps=MESH_GAN["steps"], batch=TRAIN_BATCH, seed=MESH_SEED,
                    ckpt_dir=os.path.join(root, "ckpt", "D"), ckpt_every=MESH_GAN["ckpt_every"], log_every=1,
                    handle_signals=False, device=MESH_DEVICE, settings=StepSettings(lr=MESH_LR, b1=0.5))
    if one["metrics"][:2] != tg["A"]["metrics"][:2]:
        problems.append("train_mesh: the one-device resume's history does not start with the mesh run's")
    strip = lambda hist: [{k: v for k, v in e.items() if k != "step"} for e in hist]  # noqa: E731
    one_held = hold_run("train_mesh one-device resume", dict(metrics=strip(one["metrics"][2:]),
                                                             gp=one["params"]["gp"], dp=one["params"]["dp"]),
                        dict(metrics=strip(tg["A"]["metrics"][2:]), gp=tg["A"]["gp"], dp=tg["A"]["dp"]), problems)
    del one
    shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "train_mesh_checks", "world": 2, "step1_first_moment_err_share_of_tol": moment_share, **kinks,
          "train_gan": {"steps": MESH_GAN["steps"], "ckpt_every": MESH_GAN["ckpt_every"],
                        "fault": f"raise at step {MESH_GAN['fault_at']}", "counters_B": tg["B"]["counters"],
                        "resumed_C_from_step": 2, "B_and_C_equal_A_bitwise": bitwise,
                        "one_device_resume_vs_A": {k: v for k, v in one_held.items() if k != "leaf_max_abs_err"},
                        "restored_onto_mesh_split_leaves": tg["restore_split_leaves"],
                        "launches": {k: tg[k]["launches"] for k in ("A", "B", "C")}},
          "bucket_allreduce_ms": w2[0]["bucket_ms"], "bucket_numels": w2[0]["bucket_numels"],
          "bytes_per_step": w2[0]["int8"]["wire"], "phase_s": time.perf_counter() - t0, "card": card})
    # sharded residency on the world-2 mesh against the single-device engine (serve_mesh)
    from repro_torch.configs import DCGAN
    from repro_torch.serve import GanServeEngine

    with torch.inference_mode():
        want = GanServeEngine(_serve_params(torch), DCGAN, batch=SERVE_MESH_BATCH).generate(_serve_mesh_z(torch)).cpu()
    serve_errs = []
    for rank, r in enumerate(w2):
        sm = r["serve_mesh"]
        diff = (sm["img"] - want).abs()
        serve_errs.append(diff.max().item())
        if not bool((diff <= 1e-5 + 1e-4 * want.abs()).all()):
            problems.append(f"serve_mesh rank {rank}: images vs the single-device engine max|err| {serve_errs[-1]:.3e}")
        if sm["launches"] != {row: 4 if row == "fused_engine_epi" else 0 for row in COUNTERS}:
            problems.append(f"serve_mesh rank {rank}: launches {sm['launches']}, want 4 of kernel 3")
    emit({"phase": "train_mesh_serve", "world": 2, "mesh": {"data": 2}, "arch": "dcgan", "batch": SERVE_MESH_BATCH,
          "impl": "cuda_chained", "max_abs_err_vs_single_device_by_rank": serve_errs, "tol": {"atol": 1e-5,
                                                                                           "rtol": 1e-4},
          "kernel3_launches_per_generate": w2[0]["serve_mesh"]["launches"]["fused_engine_epi"],
          "resident_bytes_by_rank": [r["serve_mesh"]["resident_bytes"] for r in w2],
          "whole_tree_bytes": w2[0]["serve_mesh"]["whole_bytes"],
          "generate_ms_by_rank": [r["serve_mesh"]["generate_ms"] for r in w2],
          "gather_ms_by_rank": [r["serve_mesh"]["gather_ms"] for r in w2], "card": card})
    if problems:
        fail(f"train_mesh: {len(problems)} check(s) missed: " + "; ".join(problems[:8]))
    return {"launches": w2[0]["launches"], "serve_launches": w2[0]["serve_mesh"]["launches"]}


# --------------------------------------------------------------- the LM stack
LM_ARCH = "mamba2-780m"  # at its published size: 48 layers, d_model 1536, d_inner 3072, d_state 128, vocab 50280
LM_SLOTS, LM_PROMPT, LM_MAX_LEN, LM_REQUESTS, LM_MAX_NEW, LM_SEED = 4, 256, 512, 8, 16, 0
# (channels, batch) of Mamba2's prefill conv at T = LM_PROMPT: conv_x (d_inner) and conv_B / conv_C (d_state)
LM_CONV_SHAPES = ((3072, 1), (3072, 4), (128, 1), (128, 4))
# The prefill logits' tolerance, its formula fixed before the first full run: each conv call on "engine" may
# differ from "direct" by eps, the largest relative error (of the output's largest magnitude) that the conv
# checks at the model's shapes allow; a prefill runs 3 x 48 of them, and the SSD, the norms and the residual
# stream may amplify each up to LM_LOGIT_GAIN times: |engine - direct| <= LM_LOGIT_GAIN * 144 * eps *
# max|logits| + 1e-5.  eps is LM_CONV_EPS, the value the conv checks measured on the card's first full runs
# (6.795e-7, the same in three runs), so the tolerance is a number (9.792e-4 relative) that a worse kernel
# cannot widen: the phase fails where this run's conv checks measure more than LM_CONV_EPS.
LM_LOGIT_GAIN = 10.0
LM_CONV_EPS = 6.8e-7
LM_ENGINE_TOL = dict(atol=5e-5, rtol=1e-4)  # a kernel against its plain version (the engine tolerance)


def _held_elementwise(what: str, got, want, atol: float, rtol: float) -> float:
    """Fail unless |got - want| <= atol + rtol |want| everywhere; the largest
    |difference|."""
    if tuple(got.shape) != tuple(want.shape):
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        fail(f"{what}: max|err| {diff.max().item():.3e} beyond atol {atol:g} / rtol {rtol:g}")
    return diff.max().item()


def _lm_conv_checks(torch, peaks, params, card):
    """Kernel 9 through Mamba2's ``_causal_conv`` at the model's shapes
    (LM_CONV_SHAPES, the layer-0 taps with a non-zero bias): "engine"
    against the plain 1D engine ("engine_interpret") and "direct" at the
    engine tolerance, its gradient in x, the taps and the bias (kernels 9 /
    4 / 5, one launch each) against autograd of the plain version at 1e-4 *
    max + 1e-5; then the wrapper alone timed (device ms a launch, plain and
    library ms, the bound).  Returns (rows, eps: the largest relative
    engine-versus-direct error)."""
    import torch.nn.functional as F

    from repro_torch.kernels import engine, ops
    from repro_torch.models import ssm as S

    blk = params["blocks"]["slot0"]["mamba"]
    rows, eps = [], 0.0
    for C, B in LM_CONV_SHAPES:
        name = f"mamba2.conv_C{C}_B{B}"
        g = torch.Generator(device="cuda").manual_seed(900 + C + B)
        x = torch.randn((B, LM_PROMPT, C), generator=g, device="cuda")
        key = "conv_x" if blk["conv_x"]["w"].shape[-1] == C else "conv_B"  # d_inner, or d_state
        conv = {"w": blk[key]["w"][0].clone(),
                "b": 0.1 * torch.randn((C,), generator=g, device="cuda")}
        if tuple(conv["w"].shape) != (4, C):
            fail(f"{name}: the model's taps are {tuple(conv['w'].shape)}")
        outs = {}
        with torch.no_grad():
            for impl in ("engine", "engine_interpret", "direct"):
                S.set_conv_impl(impl)
                before = read_counts()["engine1d_nlc"]
                outs[impl] = S._causal_conv(x, conv)[0]
                ran = read_counts()["engine1d_nlc"] - before
                if ran != (impl == "engine"):
                    fail(f"{name}: conv impl {impl!r} launched kernel 9 {ran} times")
        torch.cuda.synchronize()
        err_plain = _held_elementwise(f"{name} engine vs its plain version", outs["engine"], outs["engine_interpret"],
                                      **LM_ENGINE_TOL)
        err_direct = _held_elementwise(f"{name} engine vs direct", outs["engine"], outs["direct"], **LM_ENGINE_TOL)
        eps = max(eps, err_direct / outs["direct"].abs().max().item())
        # the gradient: kernels 9, 4 and 5 (rank 1) against autograd of the plain 1D engine
        ct = torch.randn(outs["engine"].shape, generator=g, device="cuda")
        grads = {}
        for impl in ("engine", "engine_interpret"):
            S.set_conv_impl(impl)
            leaves = [x.clone().requires_grad_(True), conv["w"].clone().requires_grad_(True),
                      conv["b"].clone().requires_grad_(True)]
            before = read_counts()
            (S._causal_conv(leaves[0], {"w": leaves[1], "b": leaves[2]})[0] * ct).sum().backward()
            torch.cuda.synchronize()
            after = read_counts()
            ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            want = {"engine1d_nlc": 1, "domain_engine_bwd_x_rank1": 1, "domain_engine_bwd_w_rank1": 1} \
                if impl == "engine" else {}
            if ran != want:
                fail(f"{name} gradient on {impl!r}: launches {ran}, want {want}")
            grads[impl] = [t.grad for t in leaves]
        S.set_conv_impl("direct")
        grad_err = {}
        for leaf, got, want in zip(("x", "w", "b"), grads["engine"], grads["engine_interpret"]):
            tol = 1e-4 * want.abs().max().item() + 1e-5
            grad_err[leaf] = (got - want).abs().max().item()
            if not grad_err[leaf] <= tol:
                fail(f"{name} gradient in {leaf}: max|err| {grad_err[leaf]:.3e} > {tol:.3e}")
        del grads, leaves, ct, outs
        # the wrapper alone, as the prefill launches it
        wd = conv["w"][:, :, None] * torch.eye(C, device="cuda")
        packed = ops.prepack_conv1d(wd, 4)
        xp = torch.cat([x.new_zeros((B, 3, C)), x], dim=1)
        cells, ty, _ = ops.conv1d_cells_from_seq(xp, 4, padding="valid")
        pos_idx, sub_slices, _, bt, n = ops.conv1d_layout(4)
        kw = dict(pos_idx=pos_idx, sub_slices=sub_slices, m=2, n=n, ty=ty, phases=1, out_mode="nlc", stride=1)
        run = lambda: engine.winograd_conv1d_fused_engine(cells, packed.ww, packed.inv, bt, **kw)  # noqa: E731
        plain = lambda: engine.winograd_conv1d_fused_engine_plain(cells, packed.ww, packed.inv, bt, **kw)  # noqa: E731
        xc, wt = xp.permute(0, 2, 1).contiguous(), wd.permute(2, 1, 0).contiguous()
        lib = lambda: F.conv1d(xc, wt)  # noqa: E731
        w_dw = conv["w"].t().contiguous()[:, None, :]  # (C, 1, 4): the depthwise taps the dense ones hold
        lib_dw = lambda: F.conv1d(xc, w_dw, groups=C)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        err = _held_elementwise(f"{name} wrapper vs plain", got, plain(), **LM_ENGINE_TOL)
        lib_err = (got[:, :LM_PROMPT] - lib().permute(0, 2, 1)).abs().max().item()
        lib_dw_err = (got[:, :LM_PROMPT] - lib_dw().permute(0, 2, 1)).abs().max().item()
        _, _, ms, by_kernel = profiled_ms(run, reps=20, name=ENGINE1D_KERNELS, what=f"kernel 9 at {name}")
        T, Cp = B * ty, len(pos_idx)
        products = 2 * T * Cp * C * C
        n_bytes = 4 * (cells.numel() + packed.ww.numel() + packed.inv.numel() + got.numel())
        n_ops = products + T * C * transform_ops_1d(bt) + T * C * fold_ops_1d(packed.inv.cpu().numpy(), sub_slices)
        # the bound at the 3xTF32 rate: engine1d_mma_kernel takes these shapes (M = C, a multiple of 4 and
        # >= 16), even where the plan runs the CUDA-core kernel at batch 1
        bound = mma_bound(n_bytes, n_ops, products, sorted(k for k in by_kernel if kernel_named(k, ENGINE1D_KERNELS)),
                          peaks, tensor_cores=True)
        row = dict(kernel="engine1d_nlc", name=name, B=B, T=LM_PROMPT, C=C, tiles=T, max_abs_err=err,
                   tol=LM_ENGINE_TOL, max_abs_err_vs_direct=err_direct, max_abs_err_vs_plain_conv=err_plain,
                   grad_max_abs_err=grad_err, ms=ms, ms_wall=event_median_ms(run, reps=20),
                   plain_ms=profiled_ms(plain, reps=5, warmup=1, what=f"plain kernel 9 at {name}")[1],
                   library_ms=profiled_ms(lib, reps=20, what=f"conv1d at {name}")[1],
                   library_note="conv1d (cuDNN) on the diagonal dense (C, C, 4) taps", library_max_abs_err=lib_err,
                   # the function the main path needs: one depthwise conv1d on the (C, 1, 4) taps
                   library_depthwise_ms=profiled_ms(lib_dw, reps=20, what=f"depthwise conv1d at {name}")[1],
                   library_depthwise_max_abs_err=lib_dw_err,
                   bytes=n_bytes, ops=n_ops, achieved_tflops=n_ops / (ms * 1e-3) / 1e12,
                   # the taps are diagonal: a depthwise conv needs C products a position, not C^2, and its
                   # bytes; the kernel is given dense weights and does the dense work (bound_ms)
                   bound_depthwise_ms=1e3 * 4 * (xp.numel() + 4 * C + got.numel()) / peaks[1], **bound)
        emit({"phase": "lm_conv", **row, "card": card})
        rows.append(row)
        del wd, packed, cells, got, x, xp, xc, wt
        torch.cuda.empty_cache()
    return rows, eps


class _ServeLog:
    """Records every prefill's and decode step's logits of a ServeEngine
    (the active rows of each call), and with ``force`` (another run's log)
    returns logits whose argmax is that run's token on every active row:
    teacher forcing, the true logits kept."""

    def __init__(self, torch, eng, force=None):
        self.calls, self.torch, self.force = [], torch, force
        pre, dec = eng._prefill_one, eng._decode

        def prefill_one(tokens):
            logits, cache = pre(tokens)
            return self._record("prefill", logits, [0]), cache

        def decode(toks, lens):
            logits, cache = dec(toks, lens)
            return self._record("decode", logits, [s for s, r in enumerate(eng.active) if r is not None]), cache

        eng._prefill_one, eng._decode = prefill_one, decode

    def _record(self, kind, logits, rows):
        i = len(self.calls)
        self.calls.append((kind, rows, logits[rows].clone()))
        if self.force is None:
            return logits
        f_kind, f_rows, f_logits = self.force.calls[i]
        if (f_kind, f_rows) != (kind, rows):
            fail(f"lm_serve: call {i} is a {kind} of rows {rows}; the run it follows made a {f_kind} of {f_rows}")
        forced = logits.clone()
        forced[rows, self.torch.argmax(f_logits, dim=-1)] = float("inf")
        return forced


def lm_serve_phase(torch, peaks, card):
    """Mamba2-780m at its published size through ServeEngine (see the
    module docstring); returns the engine run's launches and the conv rows."""
    from repro_torch import data as D
    from repro_torch.configs import LMS
    from repro_torch.models import lm as LM
    from repro_torch.models import ssm as S
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = LMS[LM_ARCH]
    params = LM.lm_init(cfg, seed=LM_SEED, device="cuda")
    leaves = tree_leaves(params)
    n_params, n_bytes = sum(t.numel() for t in leaves), sum(t.numel() * t.element_size() for t in leaves)
    rows, eps = _lm_conv_checks(torch, peaks, params, card)
    tol_rel = LM_LOGIT_GAIN * 3 * cfg.n_layers * LM_CONV_EPS
    emit({"phase": "lm_serve_setup", "arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "ssm": dataclasses.asdict(cfg.ssm), "params": n_params, "param_bytes": n_bytes,
          "conv_eps": eps, "conv_eps_cap": LM_CONV_EPS,
          "logit_tol": f"{LM_LOGIT_GAIN} * {3 * cfg.n_layers} * {LM_CONV_EPS} * max|logits| + 1e-5",
          "logit_tol_rel": tol_rel, "init_and_conv_checks_s": time.perf_counter() - t0, "card": card})
    if not eps <= LM_CONV_EPS:
        fail(f"lm_serve: the conv checks' relative error engine vs direct {eps:.4e} exceeds LM_CONV_EPS "
             f"{LM_CONV_EPS:g}, on which the logit tolerance rests")

    prompts = D.lm_batch(LM_SEED, 0, LM_REQUESTS, LM_PROMPT, cfg.vocab, device="cuda")["tokens"].tolist()
    runs = {}
    for impl in ("direct", "engine"):
        S.set_conv_impl(impl)
        eng = ServeEngine(params, cfg, slots=LM_SLOTS, max_len=LM_MAX_LEN, prompt_len=LM_PROMPT)
        log = _ServeLog(torch, eng, force=runs["direct"]["log"] if impl == "engine" else None)
        reqs = [Request(rid=i, tokens=p, max_new=LM_MAX_NEW) for i, p in enumerate(prompts)]
        # --- the main path: counts at 0 just before, read just after
        zero_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_counts()
        prefills = sum(kind == "prefill" for kind, _, _ in log.calls)
        check_counts(f"lm_serve {impl}", launches,
                     {"engine1d_nlc": 3 * cfg.n_layers * prefills} if impl == "engine" else {})
        if sorted(r.rid for r in done) != list(range(LM_REQUESTS)) or any(len(r.out) != LM_MAX_NEW for r in done):
            fail(f"lm_serve {impl}: finished {[(r.rid, len(r.out)) for r in done]}")
        if any(not (0 <= t_ < cfg.vocab) for r in done for t_ in r.out):
            fail(f"lm_serve {impl}: a token outside the vocabulary")
        if any(not bool(torch.isfinite(lg).all()) for _, _, lg in log.calls):
            fail(f"lm_serve {impl}: non-finite logits")
        runs[impl] = dict(log=log, wall_s=wall, launches=launches, prefills=prefills,
                          decodes=len(log.calls) - prefills, eng=eng, out={r.rid: r.out for r in done})
    S.set_conv_impl("direct")
    # engine against direct, call by call (the engine run teacher-forced on the direct run's tokens)
    worst_pre, worst_dec, worst_rel, flips, decided = 0.0, 0.0, 0.0, 0, 0
    for (kind, _, lg_e), (_, _, lg_d) in zip(runs["engine"]["log"].calls, runs["direct"]["log"].calls):
        top = lg_d.abs().max().item()
        err = (lg_e - lg_d).abs().max().item()
        if kind == "prefill":
            worst_pre = max(worst_pre, err)
        else:
            worst_dec = max(worst_dec, err)
        worst_rel = max(worst_rel, err / top)
        if not err <= tol_rel * top + 1e-5:
            fail(f"lm_serve: {kind} logits engine vs direct max|err| {err:.3e} > {tol_rel * top + 1e-5:.3e}")
    measured = max(worst_pre, worst_dec)
    for (kind, _, lg_e), (_, _, lg_d) in zip(runs["engine"]["log"].calls, runs["direct"]["log"].calls):
        top2 = torch.topk(lg_d, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * measured
        same = torch.argmax(lg_e, -1) == torch.argmax(lg_d, -1)
        decided += int(sure.sum())
        flips += int((~same).sum())
        if bool((sure & ~same).any()):
            fail(f"lm_serve: a {kind} token differs where the direct run's top-2 margin exceeds {2 * measured:.3e}")
    # --- readings, after the counted runs (the model's own calls, not the engines' logged ones)
    tok1 = torch.tensor([prompts[0]], device="cuda")

    def prefill():
        with torch.no_grad():
            return LM.prefill(params, cfg, {"tokens": tok1}, q_chunk=64, max_len=LM_MAX_LEN)

    prefill_ms = {}
    for impl in ("direct", "engine"):
        S.set_conv_impl(impl)
        prefill_ms[impl] = wall_ms(prefill, reps=5, warmup=1)
    S.set_conv_impl("engine")
    prof_ms, dev_ms, k9_ms, _ = profiled_ms(prefill, reps=2, warmup=1, name=ENGINE1D_KERNELS,
                                            what="an engine prefill")
    S.set_conv_impl("direct")
    # one decode step with every slot active, each at its own position
    eng_d = runs["direct"]["eng"]
    for s in range(LM_SLOTS):
        eng_d.try_admit(Request(rid=100 + s, tokens=prompts[s][: LM_PROMPT - 8 * s], max_new=LM_MAX_NEW))
    lens = torch.tensor(eng_d.pos, dtype=torch.int64, device="cuda")

    def decode():
        with torch.no_grad():
            return LM.decode_step(params, cfg, eng_d.cache, eng_d.last_tok, lens)

    decode_ms = wall_ms(decode, reps=10, warmup=2)
    top = lambda by_kernel: dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])  # noqa: E731
    S.set_conv_impl("direct")
    d_prof = profiled_ms(prefill, reps=2, warmup=1, what="a direct prefill")
    dec_prof = profiled_ms(decode, reps=5, warmup=1, what="a decode step")
    where = {"direct_prefill": dict(wall_ms=d_prof[0], device_ms=d_prof[1], top_kernels_ms=top(d_prof[3]),
                                    host_ops_ms=host_ops_ms(prefill, reps=2, top=6)),
             "decode_step": dict(wall_ms=dec_prof[0], device_ms=dec_prof[1], device_idle_share=1 - dec_prof[1] / dec_prof[0],
                                 top_kernels_ms=top(dec_prof[3]), host_ops_ms=host_ops_ms(decode, reps=5, top=6))}
    emit({"phase": "lm_serve", "arch": LM_ARCH, "slots": LM_SLOTS, "prompt_len": LM_PROMPT, "max_len": LM_MAX_LEN,
          "requests": LM_REQUESTS, "max_new": LM_MAX_NEW,
          "runs": {impl: {k: r[k] for k in ("wall_s", "prefills", "decodes")} for impl, r in runs.items()},
          "kernel9_launches_engine": runs["engine"]["launches"]["engine1d_nlc"],
          "kernel9_launches_per_prefill": runs["engine"]["launches"]["engine1d_nlc"] / runs["engine"]["prefills"],
          "kernel9_launches_direct": runs["direct"]["launches"]["engine1d_nlc"],
          "prefill_logits_max_abs_err": worst_pre, "decode_logits_max_abs_err": worst_dec,
          "logits_max_rel_err": worst_rel, "logit_tol_rel": tol_rel, "tokens_decided": decided,
          "tokens_differing_in_near_ties": flips, "direct_tokens_rid0": runs["direct"]["out"][0],
          "prefill_ms_per_request": prefill_ms, "engine_prefill_profile": {
              "wall_ms": prof_ms, "device_ms": dev_ms, "kernel9_ms": k9_ms,
              "kernel9_ms_per_launch": k9_ms / (3 * cfg.n_layers), "device_idle_share": 1.0 - dev_ms / prof_ms},
          "decode_ms_per_step": decode_ms, "decode_tokens_per_s": 1e3 * LM_SLOTS / decode_ms, "where_the_time_goes": where,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "phase_s": time.perf_counter() - t0,
          "card": card})
    launches = runs["engine"]["launches"]
    del runs, eng_d, params
    torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def lm_archs_phase(torch, card):
    """The nine other LM archs at smoke_config on the card (random weights
    from a seed, MoE at no-drop capacity): the decode of token T - 1 after
    a prefill of T - 1 tokens against the full prefill's last logits,
    atol 2e-4 / rtol 2e-3 (test_arch_smoke.py's check)."""
    from repro_torch import data as D
    from repro_torch.configs import LMS, smoke_config
    from repro_torch.models import lm as LM

    B, T = 2, 17
    out = {}
    for arch in sorted(a for a in LMS if a != LM_ARCH):
        cfg = smoke_config(arch)
        if cfg.moe:  # no-drop capacity: a decode's drops would differ from the prefill's
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
        params = LM.lm_init(cfg, seed=1, device="cuda")
        if cfg.frontend == "stub_embeds":
            full = {"embeds": D.embed_batch(0, 0, B, T, cfg.d_model, device="cuda")}
            pos = torch.arange(T, device="cuda")
            full["positions"] = pos[None, :, None].expand(B, T, 3) if cfg.mrope_sections else pos[None].expand(B, T)
            tok = full["embeds"][:, T - 1 : T]
        else:
            full = {"tokens": D.lm_batch(0, 0, B, T, cfg.vocab, device="cuda")["tokens"]}
            tok = full["tokens"][:, T - 1 : T]
        zero_counts()
        with torch.no_grad():
            lg_full, _ = LM.prefill(params, cfg, full, q_chunk=8)
            _, cache = LM.prefill(params, cfg, {k: v[:, : T - 1] for k, v in full.items()}, q_chunk=8, max_len=T + 1)
            lg_dec, new_cache = LM.decode_step(params, cfg, cache, tok, T - 1)
        torch.cuda.synchronize()
        check_counts(f"lm_archs {arch}", read_counts(), {})
        if tuple(lg_full.shape) != (B, cfg.vocab) or not bool(torch.isfinite(lg_dec).all()):
            fail(f"lm_archs {arch}: logits {tuple(lg_full.shape)}, finite {bool(torch.isfinite(lg_dec).all())}")
        err = _held_elementwise(f"lm_archs {arch} decode vs prefill", lg_dec, lg_full, atol=2e-4, rtol=2e-3)
        if new_cache is not cache:
            fail(f"lm_archs {arch}: the decode returned a new cache, not the one it was given")
        out[arch] = dict(max_abs_err=err, max_logit=lg_full.abs().max().item(), layers=cfg.n_layers)
    emit({"phase": "lm_archs", "B": B, "T": T, "tol": {"atol": 2e-4, "rtol": 2e-3}, "archs": out, "card": card})
    return out


# ------------------------------------------------------------ the LM on a mesh
# The lm_mesh phase's runs (see the module docstring).  A spec, not module constants: the spawned ranks take it as
# an argument (so a rehearsal on the CPU can hand them small configs).
LM_MESH = dict(
    device="cuda",
    # Mamba2-780m at its published size; prefill_32k's 32 x 32768 cut to 2 prompts of 256 tokens
    prefill=dict(arch="mamba2-780m", layers=None, smoke=False, batch=2, prompt=256, seed=0),
    # phi3-mini-3.8b at its published widths, depth cut from 32 to 4 layers; train_4k's 256 x 4096 cut to 4 x 512
    train=dict(arch="phi3-mini-3.8b", layers=4, smoke=False, batch=4, seq=512, steps=3, seed=0),
    # at smoke_config on (2, 2): jamba's conv on kernel 9 (4 / 5 in its backward); mixtral at capacity factor 1.0
    jamba=dict(arch="jamba-v0.1-52b", layers=None, smoke=True, batch=4, seq=64, seed=1),
    mixtral=dict(arch="mixtral-8x22b", layers=None, smoke=True, batch=8, seq=64, seed=2, capacity_factor=1.0),
    # the expert-parallel MoE on (4, 1): E = 4 experts, one a data shard
    ep=dict(arch="mixtral-8x22b", layers=None, smoke=True, batch=8, seq=64, seed=3),
    # gemma3-12b at its published widths, one super-block (5 local + 1 global layers), over long_500k's cache, in
    # the reference's PARAM_DTYPE bf16 and in fp32; the cache filled in chunks of `chunk` positions, each from its
    # own seed, so that a rank draws its half of the sequence alone
    decode=dict(arch="gemma3-12b", layers=6, smoke=False, positions=524288, steps=4, seed=0,
                dtypes=("bfloat16", "float32"), chunk=8192),
)
LM_MESH_FWD = dict(atol=1e-5, rtol=1e-4)  # the models' forward tolerance (ROADMAP §3)
# gemma3's decode logits, sequence-sharded against one device, max|err| / max|logits|: 1e-3 in fp32; in bf16 8 ulps
# of the largest logit (2^-5), since the two attentions round differently by design (the reference's sharded
# decode weighs V in fp32, its one-device decode rounds the probabilities to the cache's bf16 first)
LM_MESH_DECODE_TOL = {"float32": 1e-3, "bfloat16": 2.0**-5}


def _lm_mesh_cfg(sub: dict):
    from repro_torch.configs import LMS, smoke_config

    cfg = smoke_config(sub["arch"]) if sub["smoke"] else LMS[sub["arch"]]
    if sub.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=sub["layers"])
    if sub.get("capacity_factor") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=sub["capacity_factor"]))
    return cfg


def _now(device) -> float:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _lm_train_batch(torch, cfg, sub, step: int, device):
    from repro_torch import data as D

    return D.lm_batch(sub["seed"], step, sub["batch"], sub["seq"], cfg.vocab, device=device)


def _lm_grads(torch, cfg, params, batch):
    """The single-device loss and gradient (the port without a mesh)."""
    from repro_torch.models import lm as LM
    from repro_torch.tree import tree_leaves, tree_map

    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = LM.train_loss(leaves, cfg, batch, q_chunk=cfg.q_chunk, loss_chunk=cfg.loss_chunk)
        got = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g for p, g in zip(tree_leaves(leaves), got))
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def _lm_block_step(torch, cfg, full, opt_block, batch, pspecs, mesh):
    """The single-device step restricted to this rank's block: the loss and
    gradient of the whole batch from the full params, the clip's scale from
    the full gradient, AdamW (elementwise) on the block's params and
    moments.  Returns (new param blocks, loss, global grad norm)."""
    from repro_torch.launch.steps import LM_LR, LM_MAX_GRAD_NORM
    from repro_torch.optim import adamw_update, clip_by_global_norm
    from repro_torch.parallel import sharding as SH

    loss, grads = _lm_grads(torch, cfg, full, batch)
    grads, gn = clip_by_global_norm(grads, LM_MAX_GRAD_NORM)
    blk = lambda tree: SH.map_specs(lambda t, sp: SH.block_of(t, sp, mesh), tree, pspecs)  # noqa: E731
    new_p, _, _ = adamw_update(blk(full), blk(grads), opt_block, lr=LM_LR)
    return new_p, float(loss), float(gn)


def _max_leaf_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _lm_mesh_train(torch, mesh, sub, device) -> dict:
    """``sub``'s train cell on ``mesh`` (every rank calls it): its steps of
    ``build_lm_step``, each held from one shared state against the
    single-device step (this rank's block of it: loss and global gradient
    norm 1e-3 / 1e-4 relative, params 6·lr); the readings of every step (ms
    of its gather, forward and backward, reduction, update) and the
    single-device step's ms; the bytes this rank holds."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import LM_LR, build_lm_step
    from repro_torch.models import lm as LM
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    cfg = _lm_mesh_cfg(sub)
    cell = ShapeConfig("train_4k", sub["seq"], sub["batch"], "train")
    readings = []
    step, _, meta = build_lm_step(cfg, cell, mesh, readings=readings)
    pspecs, bspecs = SH.lm_param_specs(cfg, mesh)[0], SH.lm_batch_specs(cfg, cell, mesh)
    blk = lambda tree, sp: SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), tree, sp)  # noqa: E731
    params = blk(LM.lm_init(cfg, seed=sub["seed"], device=device), pspecs)
    if device == "cuda":
        torch.cuda.empty_cache()
    opt = adamw_init(params)
    held = sum(t.numel() * t.element_size() for t in tree_leaves(params) + tree_leaves(opt.m) + tree_leaves(opt.v))
    out = dict(steps=[], rank_bytes=held, fallbacks=meta["fallbacks"])
    problems = []
    for s in range(sub["steps"]):
        batch = _lm_train_batch(torch, cfg, sub, s, device)
        rows = {k: SH.block_of(v, bspecs[k], mesh) for k, v in batch.items()}
        # the pre-step state: the full params (a gather every rank joins) and this rank's moments
        with torch.no_grad():
            full = SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), params, pspecs)
        opt_before = opt
        t0 = _now(device)
        params, opt, loss = step(params, opt, rows)
        step_ms = 1e3 * (_now(device) - t0)
        r = dict(readings[-1], step_ms=step_ms, loss=float(loss))
        t0 = _now(device)
        want_p, want_loss, want_gn = _lm_block_step(torch, cfg, full, opt_before, batch, pspecs, mesh)
        r.update(single_device_step_ms=1e3 * (_now(device) - t0), single_loss=want_loss, single_grad_norm=want_gn,
                 param_max_abs_err=_max_leaf_diff(params, want_p))
        r["loss_rel_err"] = abs(r["loss"] - want_loss) / abs(want_loss)
        r["grad_norm_rel_err"] = abs(r["grad_norm"] - want_gn) / abs(want_gn)
        if not (r["loss_rel_err"] <= 1e-3 and r["grad_norm_rel_err"] <= 1e-4 and r["param_max_abs_err"] <= 6 * LM_LR):
            problems.append(f"step {s}: loss rel {r['loss_rel_err']:.3e}, grad norm rel {r['grad_norm_rel_err']:.3e}, "
                            f"params {r['param_max_abs_err']:.3e} (6·lr {6 * LM_LR:g})")
        del full, want_p, opt_before
        out["steps"].append(r)
    out["problems"] = problems
    return out


def _gemma_cache(torch, cfg, sub, device, dtype, part=(0, 1)):
    """The long_500k cache of ``cfg`` filled from ``sub``'s seed up to
    ``cache_len = positions - 1 - steps``: each global layer's K/V random at
    the positions below cache_len (the rest empty), each local layer's
    window-sized ring holding the last positions below cache_len.
    ``part`` = (i, n): share i of n of every global layer's sequence (a
    rank's block under ``cache_specs(seq_shard=True)``), the rings whole;
    K/V are drawn in chunks of ``sub["chunk"]`` positions, each from its own
    seed, so that every share draws what the whole cache holds there."""
    from repro_torch.models import lm as LM

    S, L, C = sub["positions"], sub["positions"] - 1 - sub["steps"], sub["chunk"]
    i_part, n_part = part
    S_l = S // n_part
    lo = i_part * S_l
    cache = LM.init_cache(cfg, 1, S_l, dtype, device=device)  # global caches S_l long, the rings window-sized

    def draw(slot_i: int, tag: int, shape):
        g = torch.Generator(device=device).manual_seed(sub["seed"] * 1_000_003 + slot_i * 100_003 + tag)
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)

    for i, (slot, spec) in enumerate(zip(cache, LM.slot_specs(cfg))):
        c = cache[slot]
        shape = c.k.shape[3:]
        if spec.attn_kind == "local" and cfg.window:
            W = c.k.shape[2]
            p = torch.arange(L - W, L, device=device)
            c.pos[:, :, p % W] = p.to(torch.int32)
            for j, leaf in enumerate((c.k, c.v)):
                leaf.copy_(draw(i, -1 - j, leaf.shape))
            continue
        p = torch.arange(lo, lo + S_l, device=device)
        c.pos.copy_(torch.where(p < L, p, -1).to(torch.int32).expand_as(c.pos))
        for start in range(lo, lo + S_l, C):
            for j, leaf in enumerate((c.k, c.v)):
                leaf[:, :, start - lo : start - lo + C] = draw(i, 2 * (start // C) + j, (1, 1, C, *shape))
        for leaf in (c.k, c.v):
            leaf.masked_fill_((c.pos < 0)[..., None, None], 0)
    return cache, L


def _gemma_tokens(torch, cfg, sub, device):
    g = torch.Generator(device=device).manual_seed(sub["seed"] + 11)
    return torch.randint(0, cfg.vocab, (sub["steps"], 1, 1), generator=g, device=device)


def _lm_single_refs(torch, spec) -> dict:
    """The single-device runs the ranks are held to, on the host: Mamba2's
    prefill of both prompts (conv on "engine"), gemma3's decode steps from
    the filled cache, mixtral's train step; the card freed after."""
    from repro_torch import data as D
    from repro_torch.launch.steps import LM_LR
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MoE
    from repro_torch.models import ssm as S
    from repro_torch.optim import adamw_init, adamw_update

    dev, out = spec["device"], {}
    sub = spec["prefill"]
    cfg = _lm_mesh_cfg(sub)
    params = LM.lm_init(cfg, seed=sub["seed"], device=dev)
    tokens = D.lm_batch(sub["seed"], 0, sub["batch"], sub["prompt"], cfg.vocab, device=dev)["tokens"]
    S.set_conv_impl("engine")
    try:
        zero_counts()
        with torch.no_grad():
            logits, cache = LM.prefill(params, cfg, {"tokens": tokens}, q_chunk=cfg.q_chunk, max_len=sub["prompt"] + 1)
        out["prefill_launches"] = read_counts()
    finally:
        S.set_conv_impl("direct")
    out["prefill"] = dict(logits=logits.cpu(), cache=_host(cache))
    del params, cache, logits
    sub = spec["decode"]
    cfg = _lm_mesh_cfg(sub)
    out["decode"] = {}
    for name in sub["dtypes"]:
        dtype = getattr(torch, name)
        params = LM.lm_init(cfg, seed=sub["seed"], device=dev, dtype=dtype)
        cache, L = _gemma_cache(torch, cfg, sub, dev, dtype)
        toks, lg, ms = _gemma_tokens(torch, cfg, sub, dev), [], []
        with torch.no_grad():
            for s in range(sub["steps"]):
                t0 = _now(dev)
                lg.append(LM.decode_step(params, cfg, cache, toks[s], L + s)[0].float().cpu())
                ms.append(1e3 * (_now(dev) - t0))
        out["decode"][name] = dict(logits=lg, step_ms=ms, cache_len=L)
        del params, cache
        if dev == "cuda":
            torch.cuda.empty_cache()
    sub = spec["mixtral"]
    cfg = _lm_mesh_cfg(sub)
    params = LM.lm_init(cfg, seed=sub["seed"], device=dev)
    batch = _lm_train_batch(torch, cfg, sub, 0, dev)
    with MoE.record_drops() as drops:
        loss, grads = _lm_grads(torch, cfg, params, batch)
    new_p, _, m = adamw_update(params, grads, adamw_init(params), lr=LM_LR, max_grad_norm=1.0)
    out["mixtral"] = dict(loss=float(loss), grad_norm=float(m["grad_norm"]), params=_host(new_p),
                          drops=int(sum(int(d) for d in drops)))
    del params, grads, new_p
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _lm_w2_job(torch, mesh, spec) -> dict:
    """World 2 ((2, 1)): Mamba2's prefill on "engine" (the main path: counts
    at 0 just before, read just after), the phi3 train cell, gemma3's
    sequence-sharded decode (the long_500k cell of build_lm_step)."""
    from repro_torch import data as D
    from repro_torch.configs import SHAPES, ShapeConfig
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import lm as LM
    from repro_torch.models import ssm as S
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    dev, out = spec["device"], {}
    blk = lambda tree, sp: SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), tree, sp)  # noqa: E731
    # --- Mamba2-780m prefill, world 2
    sub = spec["prefill"]
    cfg = _lm_mesh_cfg(sub)
    cell = ShapeConfig("prefill_32k", sub["prompt"], sub["batch"], "prefill")
    fn, _, _ = build_lm_step(cfg, cell, mesh)
    pspecs = SH.lm_param_specs(cfg, mesh)[0]
    params = blk(LM.lm_init(cfg, seed=sub["seed"], device=dev), pspecs)
    tokens = D.lm_batch(sub["seed"], 0, sub["batch"], sub["prompt"], cfg.vocab, device=dev)["tokens"]
    rows = {"tokens": SH.block_of(tokens, SH.lm_batch_specs(cfg, cell, mesh)["tokens"], mesh)}
    S.set_conv_impl("engine")
    try:
        zero_counts()
        t0 = _now(dev)
        logits, cache = fn(params, rows)
        prefill_ms = 1e3 * (_now(dev) - t0)
        out["prefill_launches"] = read_counts()
        t0 = _now(dev)
        fn(params, rows)
        prefill_ms2 = 1e3 * (_now(dev) - t0)
    finally:
        S.set_conv_impl("direct")
    t0 = _now(dev)
    SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), params, pspecs)
    gather_ms = 1e3 * (_now(dev) - t0)
    out["prefill"] = dict(logits=logits.cpu(), cache=_host(cache), ms=[prefill_ms, prefill_ms2], gather_ms=gather_ms,
                          rank_param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)))
    del params, logits, cache, fn
    if dev == "cuda":
        torch.cuda.empty_cache()
    # --- phi3-mini train
    out["train"] = _lm_mesh_train(torch, mesh, spec["train"], dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    # --- gemma3-12b sequence-sharded decode over long_500k's cache
    sub = spec["decode"]
    cfg = _lm_mesh_cfg(sub)
    shape = dataclasses.replace(SHAPES["long_500k"], seq_len=sub["positions"])
    fn, _, meta = build_lm_step(cfg, shape, mesh)
    pspecs = SH.lm_param_specs(cfg, mesh)[0]
    seq = SH.cache_specs(cfg, shape, mesh, seq_shard=True)
    out["decode"] = {}
    for name in sub["dtypes"]:
        dtype = getattr(torch, name)
        params = blk(LM.lm_init(cfg, seed=sub["seed"], device=dev, dtype=dtype), pspecs)
        # this rank's block of the cache: its share of the global layers' sequence (the spec's "data" entry)
        cache, L = _gemma_cache(torch, cfg, sub, dev, dtype, part=(mesh.index("data"), mesh.shape["data"]))
        if not any(isinstance(c, LM.AttnCache) and "data" in c.k for c in seq.values()):
            fail("lm_mesh decode: cache_specs(seq_shard=True) splits no attention cache's sequence")
        if dev == "cuda":
            torch.cuda.empty_cache()
        toks, lg, ms = _gemma_tokens(torch, cfg, sub, dev), [], []
        for s in range(sub["steps"]):
            t0 = _now(dev)
            lg.append(fn(params, cache, {"tokens": toks[s]}, L + s)[0].float().cpu())
            ms.append(1e3 * (_now(dev) - t0))
        t0 = _now(dev)
        SH.map_specs(lambda t, sp: SH.gather(t, sp, mesh), params, pspecs)
        out["decode"][name] = dict(
            logits=lg, step_ms=ms, gather_ms=1e3 * (_now(dev) - t0), seq_shard=meta["seq_shard"],
            rank_cache_bytes=sum(t.numel() * t.element_size() for c in cache.values() for t in c),
            rank_param_bytes=sum(t.numel() * t.element_size() for t in tree_leaves(params)))
        del params, cache
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def _lm_w4_job(torch, mesh22, mesh41, spec) -> dict:
    """World 4: on (2, 2) jamba's train step with its conv on "engine" (the
    main path: counts at 0 just before, read just after) and mixtral's at
    capacity factor 1.0; on (4, 1) the expert-parallel MoE."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MoE
    from repro_torch.models import ssm as S
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import sharding as SH
    from repro_torch.tree import tree_leaves

    dev, out = spec["device"], {}

    def one_step(name, mesh, cfg, counted=False):
        sub = spec[name]
        cell = ShapeConfig("train_4k", sub["seq"], sub["batch"], "train")
        readings = []
        step, _, _ = build_lm_step(cfg, cell, mesh, readings=readings)
        pspecs, bspecs = SH.lm_param_specs(cfg, mesh)[0], SH.lm_batch_specs(cfg, cell, mesh)
        params = SH.map_specs(lambda t, s: SH.block_of(t, s, mesh), LM.lm_init(cfg, seed=sub["seed"], device=dev),
                              pspecs)
        batch = _lm_train_batch(torch, cfg, sub, 0, dev)
        rows = {k: SH.block_of(v, bspecs[k], mesh) for k, v in batch.items()}
        opt = adamw_init(params)
        with MoE.record_drops() as drops:
            if counted:
                zero_counts()
            params, opt, loss = step(params, opt, rows)
            if counted:
                if dev == "cuda":
                    torch.cuda.synchronize()
                launches = read_counts()
        full = SH.map_specs(lambda t, s: SH.gather(t, s, mesh), params, pspecs)
        r = dict(loss=float(loss), grad_norm=readings[-1]["grad_norm"], drops=int(sum(int(d) for d in drops)),
                 finite=all(bool(torch.isfinite(t).all()) for t in tree_leaves(full)), params=_host(full))
        if counted:
            r["launches"] = launches
        return r

    S.set_conv_impl("engine")
    try:
        out["jamba"] = one_step("jamba", mesh22, _lm_mesh_cfg(spec["jamba"]), counted=True)
    finally:
        S.set_conv_impl("direct")
    del out["jamba"]["params"]
    out["mixtral"] = one_step("mixtral", mesh22, _lm_mesh_cfg(spec["mixtral"]))
    # --- the expert-parallel MoE on (4, 1): its forward against moe_apply on each source shard's rows
    sub = spec["ep"]
    cfg = dataclasses.replace(_lm_mesh_cfg(sub), moe_ep=True)
    moe = LM.lm_init(cfg, seed=sub["seed"], device=dev)["blocks"]["slot0"]["moe"]
    moe = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in moe.items()}
    g = torch.Generator(device=dev).manual_seed(sub["seed"] + 5)
    x = torch.randn((sub["batch"], sub["seq"], cfg.d_model), generator=g, device=dev)
    x_rows = SH.block_of(x, SH.P(("data",), None, None), mesh41)
    with torch.no_grad(), MoE.record_drops() as drops:
        got, aux = MoE.moe_apply_ep(moe, x_rows, cfg.moe, cfg.mlp, mesh=mesh41)
        want, want_aux = MoE.moe_apply(moe, x_rows, cfg.moe, cfg.mlp)
    diff = (got - want).abs()
    out["ep"] = dict(max_abs_err=float(diff.max()), held=bool((diff <= LM_MESH_FWD["atol"] + LM_MESH_FWD["rtol"]
                                                               * want.abs()).all()),
                     aux_share=float(aux), aux_shard=float(want_aux), drops=int(drops[0]))
    r = one_step("ep", mesh41, cfg)
    out["ep"]["train"] = {k: v for k, v in r.items() if k != "params"}
    return out


def _lm_mesh_rank(rank, world, backend, store, out, spec):
    """One rank of a spawned LM world on the card (or the CPU, for a
    rehearsal): joins the group through the FileStore ``store``, runs the
    world's job, writes its results (host tensors) to ``out`` + its rank."""
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if spec["device"] == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch import make_mesh

    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        if world == 2:
            res = _lm_w2_job(torch, make_mesh((2, 1), ("data", "model"), device=spec["device"]), spec)
        else:
            mesh22 = make_mesh((2, 2), ("data", "model"), device=spec["device"])
            mesh41 = make_mesh((4, 1), ("data", "model"), device=spec["device"])
            res = _lm_w4_job(torch, mesh22, mesh41, spec)
        torch.save(res, f"{out}{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn_lm(torch, world: int, root: str, spec: dict, deadline_s: float = 500.0) -> list:
    """``_lm_mesh_rank`` on a spawned gloo world of ``world`` ranks; the
    ranks' results."""
    import os

    import torch.multiprocessing as tmp

    store, out = os.path.join(root, f"store_lm{world}"), os.path.join(root, f"out_lm{world}_")
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_lm_mesh_rank, args=(r, world, "gloo", store, out, spec)) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        fail(f"lm_mesh: the world-{world} ranks exited with {codes} (a rank failed, or hung past {deadline_s:.0f} s)")
    return [torch.load(f"{out}{r}.pt", weights_only=False) for r in range(world)]


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()), 1e-30)


def lm_mesh_phase(torch, card, spec=None):
    """The LM stack on a mesh (see the module docstring): the single-device
    runs first (the card freed after each), world 1 on NCCL in this process,
    then spawned gloo worlds of 2 and 4 sharing the card.  Returns the
    launches of the main path's runs (rank 0's Mamba2 prefill and jamba
    train step)."""
    import os
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import make_mesh

    spec = spec or LM_MESH
    dev = spec["device"]
    t0 = time.perf_counter()
    problems: list = []
    refs = _lm_single_refs(torch, spec)
    root = tempfile.mkdtemp(prefix="lm_mesh_")
    # --- world 1 on NCCL (the CPU: gloo), in this process: the phi3 train cell
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(MESH_W1_BACKEND if dev == "cuda" else "gloo",
                            store=dist.FileStore(os.path.join(root, "store_w1"), 1), rank=0, world_size=1)
    try:
        w1 = _lm_mesh_train(torch, make_mesh((1, 1), ("data", "model"), device=dev), spec["train"], dev)
    finally:
        dist.destroy_process_group()
    problems += [f"lm_mesh train world 1 {p}" for p in w1["problems"]]
    if dev == "cuda":
        torch.cuda.empty_cache()
    w2 = _spawn_lm(torch, 2, root, spec)
    w4 = _spawn_lm(torch, 4, root, spec)
    shutil.rmtree(root, ignore_errors=True)
    # --- prefill: each rank's rows and cache block against the single-device prefill of both prompts
    sub = spec["prefill"]
    n_layers = _lm_mesh_cfg(sub).n_layers
    tol_rel = LM_LOGIT_GAIN * 3 * n_layers * LM_CONV_EPS
    pre_err, pre_cache_err = [], []
    want_k9 = 3 * n_layers if dev == "cuda" else 0
    for rank, r in enumerate(w2):
        p = r["prefill"]
        pre_err.append(_rel_err(p["logits"], refs["prefill"]["logits"][rank : rank + 1]))
        worst = 0.0
        for slot, c in refs["prefill"]["cache"].items():
            for field, leaf in zip(c._fields, c):
                worst = max(worst, _rel_err(getattr(p["cache"][slot], field), leaf[:, rank : rank + 1]))
        pre_cache_err.append(worst)
        if not (pre_err[-1] <= tol_rel and worst <= tol_rel):
            problems.append(f"lm_mesh prefill rank {rank}: logits {pre_err[-1]:.3e}, cache {worst:.3e} relative "
                            f"(tol {tol_rel:.3e})")
        if r["prefill_launches"] != {row: want_k9 if row == "engine1d_nlc" else 0 for row in COUNTERS}:
            problems.append(f"lm_mesh prefill rank {rank}: launches {r['prefill_launches']}, want {want_k9} of "
                            f"kernel 9")
    emit({"phase": "lm_mesh_prefill", "arch": sub["arch"], "world": 2, "mesh": {"data": 2, "model": 1},
          "backend": "gloo (CUDA tensors)", "batch": sub["batch"], "prompt": sub["prompt"],
          "conv": "engine", "cut": "prefill_32k's 32 x 32768 to 2 x 256",
          "logits_max_rel_err_by_rank": pre_err, "cache_max_rel_err_by_rank": pre_cache_err, "tol_rel": tol_rel,
          "kernel9_launches_per_rank": [r["prefill_launches"]["engine1d_nlc"] for r in w2],
          "single_device_kernel9_launches": refs["prefill_launches"]["engine1d_nlc"],
          "prefill_ms_by_rank": [r["prefill"]["ms"] for r in w2],
          "param_gather_ms_by_rank": [r["prefill"]["gather_ms"] for r in w2],
          "rank_param_bytes": [r["prefill"]["rank_param_bytes"] for r in w2], "card": card})
    # --- train: phi3 on world 1 and 2, each step from one shared state
    sub = spec["train"]
    runs = {"world1_nccl": w1, "world2_gloo": w2[0]["train"]}
    for rank, r in enumerate(w2):
        problems += [f"lm_mesh train world 2 rank {rank} {p}" for p in r["train"]["problems"]]
    emit({"phase": "lm_mesh_train", "arch": sub["arch"], "layers": sub["layers"], "batch": sub["batch"],
          "seq": sub["seq"], "steps": sub["steps"], "cut": "32 to 4 layers; train_4k's 256 x 4096 to 4 x 512",
          "tol": {"loss_rel": 1e-3, "grad_norm_rel": 1e-4, "params_abs": "6·lr"},
          "runs": {k: dict(steps=v["steps"], rank_bytes=v["rank_bytes"]) for k, v in runs.items()},
          "world2_rank_bytes": [r["train"]["rank_bytes"] for r in w2], "card": card})
    # --- jamba (2, 2): kernels 9 / 4 / 5 a rank and step; mixtral (2, 2): drops, and the single-device step
    mix_ref = refs["mixtral"]
    jam = [r["jamba"] for r in w4]
    # a step runs each mamba layer's three convs forward twice (the remat recompute) and backward once
    from repro_torch.models import lm as LM

    jcfg = _lm_mesh_cfg(spec["jamba"])
    n_mamba = sum(sp.kind == "mamba" for sp in LM.slot_specs(jcfg)) * (jcfg.n_layers // LM.superblock_period(jcfg))
    want_jam = {"engine1d_nlc": 6 * n_mamba, "domain_engine_bwd_x_rank1": 3 * n_mamba,
                "domain_engine_bwd_w_rank1": 3 * n_mamba} if dev == "cuda" else {}
    for rank, r in enumerate(jam):
        if not (r["finite"] and math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            problems.append(f"lm_mesh jamba rank {rank}: not finite (loss {r['loss']}, grad norm {r['grad_norm']})")
        if r["launches"] != {row: want_jam.get(row, 0) for row in COUNTERS}:
            problems.append(f"lm_mesh jamba rank {rank}: launches {r['launches']}, want {want_jam}")
    mix = [r["mixtral"] for r in w4]
    mix_err = dict(loss_rel=abs(mix[0]["loss"] - mix_ref["loss"]) / abs(mix_ref["loss"]),
                   grad_norm_rel=abs(mix[0]["grad_norm"] - mix_ref["grad_norm"]) / abs(mix_ref["grad_norm"]),
                   params_max_abs=_max_leaf_diff(mix[0]["params"], mix_ref["params"]))
    if sum(r["drops"] for r in mix) == 0 or not (mix_err["loss_rel"] <= 1e-3 and mix_err["grad_norm_rel"] <= 1e-4
                                                 and mix_err["params_max_abs"] <= 6 * 3e-4):
        problems.append(f"lm_mesh mixtral: drops {[r['drops'] for r in mix]}, against the single device {mix_err}")
    emit({"phase": "lm_mesh_moe", "mesh": {"data": 2, "model": 2}, "jamba": {
        "arch": spec["jamba"]["arch"], "conv": "engine", "loss": jam[0]["loss"], "grad_norm": jam[0]["grad_norm"],
        "mamba_layers": n_mamba, "launches_want": want_jam,
        "launches_per_rank_step": [{k: v for k, v in r["launches"].items() if v} for r in jam]},
        "mixtral": {"capacity_factor": spec["mixtral"]["capacity_factor"], "drops_by_rank": [r["drops"] for r in mix],
                    "single_device_drops": mix_ref["drops"], "vs_single_device": mix_err},
        "card": card})
    # --- EP (4, 1)
    ep = [r["ep"] for r in w4]
    for rank, r in enumerate(ep):
        t = r["train"]
        if not (r["held"] and t["finite"] and math.isfinite(t["loss"]) and math.isfinite(t["grad_norm"])):
            problems.append(f"lm_mesh ep rank {rank}: forward held {r['held']} ({r['max_abs_err']:.3e}), train "
                            f"finite {t['finite']} loss {t['loss']}")
    emit({"phase": "lm_mesh_ep", "arch": spec["ep"]["arch"], "mesh": {"data": 4, "model": 1}, "experts": 4,
          "transport": "gloo all_to_all through the host (CUDA tensors staged)" if dev == "cuda" else "gloo",
          "forward_max_abs_err_by_rank": [r["max_abs_err"] for r in ep], "tol": LM_MESH_FWD,
          "drops_by_rank": [r["drops"] for r in ep], "train_loss": ep[0]["train"]["loss"],
          "train_grad_norm": ep[0]["train"]["grad_norm"], "card": card})
    # --- decode: gemma3 sequence-sharded over long_500k's cache against the single-device decode
    sub = spec["decode"]
    for name in sub["dtypes"]:
        ref = refs["decode"][name]
        errs = [[_rel_err(a, b) for a, b in zip(r["decode"][name]["logits"], ref["logits"])] for r in w2]
        worst = max(max(e) for e in errs)
        if not worst <= LM_MESH_DECODE_TOL[name]:
            problems.append(f"lm_mesh decode {name}: logits {worst:.3e} relative (tol {LM_MESH_DECODE_TOL[name]:g})")
        if not all(r["decode"][name]["seq_shard"] for r in w2):
            problems.append("lm_mesh decode: build_lm_step did not shard the long_500k cache's sequence")
        emit({"phase": "lm_mesh_decode", "arch": sub["arch"], "layers": sub["layers"], "dtype": name,
              "positions": sub["positions"], "cache_len_first": ref["cache_len"], "steps": sub["steps"], "world": 2,
              "cut": "48 to 6 layers (one super-block)", "logits_max_rel_err": worst,
              "logits_rel_err_by_rank_step": errs, "tol_rel": LM_MESH_DECODE_TOL[name],
              "step_ms_by_rank": [r["decode"][name]["step_ms"] for r in w2], "single_device_step_ms": ref["step_ms"],
              "param_gather_ms_by_rank": [r["decode"][name]["gather_ms"] for r in w2],
              "rank_cache_bytes": [r["decode"][name]["rank_cache_bytes"] for r in w2],
              "rank_param_bytes": [r["decode"][name]["rank_param_bytes"] for r in w2], "card": card})
    emit({"phase": "lm_mesh_seconds", "seconds": time.perf_counter() - t0})
    if problems:
        fail(f"lm_mesh: {len(problems)} check(s) missed: " + "; ".join(problems[:8]))
    return {"prefill_launches": w2[0]["prefill_launches"], "train_launches": jam[0]["launches"]}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all)")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES))}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # fp32 as the reference serves: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(kind)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda, "device": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi, "peak_table": peak_key,
          "peak_fp32_flops": peaks[0], "peak_bytes_per_s": peaks[1], "peak_3xtf32_flops": peaks[2]})

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library()
    ptxas = [ln.strip() for ln in _build.last_build_log.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build_log.get("seconds"), "ptxas": ptxas,
          "library": str(_build.library_path().relative_to(ROOT))})

    def timed(name, fn, default):
        """Run phase ``name`` if it was asked for, and print its seconds."""
        if name not in phases:
            return default
        t = time.perf_counter()
        out = fn()
        emit({"phase_seconds": name, "seconds": time.perf_counter() - t})
        return out

    rows = timed("kernel", lambda: kernel_phase(torch, peaks), [])
    bwd_rows = timed("kernel_bwd", lambda: kernel_bwd_phase(torch, peaks), [])
    conv_rows = timed("kernel_conv", lambda: kernel_conv_phase(torch, peaks), [])
    domain_rows = timed("kernel_domain", lambda: kernel_domain_phase(torch, peaks), [])
    serve_launches = timed("serve", lambda: serve_phase(torch, smi), None)
    train = timed("train", lambda: train_phase(torch, smi), {})
    chained = timed("train_chained", lambda: train_phase(torch, smi, "cuda_chained"), {})
    serve_pl = timed("serve_per_layer", lambda: serve_per_layer_phase(torch, smi), {})
    per_layer = timed("train_per_layer", lambda: train_phase(torch, smi, "cuda_prepacked", "cuda_prepacked"), {})
    rows_1d = timed("kernel_1d", lambda: kernel_1d_phase(torch, peaks), [])
    audio = timed("audio", lambda: audio_phase(torch, smi), {})
    serve_faults = timed("serve_faults", lambda: serve_faults_phase(torch, smi), None)
    train_loop = timed("train_gan", lambda: train_gan_phase(torch, smi), None)
    tuned = timed("autotune", lambda: autotune_phase(torch, smi), {})
    mesh = timed("train_mesh", lambda: train_mesh_phase(torch, smi), {})
    lm = timed("lm_serve", lambda: lm_serve_phase(torch, peaks, smi), {})
    timed("lm_archs", lambda: lm_archs_phase(torch, smi), None)
    lm_mesh = timed("lm_mesh", lambda: lm_mesh_phase(torch, smi), {})
    # each path's launches of every kernel, counted in its run (None: not run)
    path_launches = {"serve": serve_launches, "train": train.get("launches"),
                     "train_chained": chained.get("launches"), "serve_per_layer": serve_pl.get("launches"),
                     "train_per_layer": per_layer.get("launches"), "audio": audio.get("launches"),
                     "audio_grad": audio.get("grad_launches"), "serve_faults": serve_faults,
                     "train_gan": train_loop, "train_tuned": tuned.get("launches"), "train_mesh": mesh.get("launches"),
                     "serve_mesh": mesh.get("serve_launches"), "lm_serve": lm.get("launches"),
                     "lm_mesh_prefill": lm_mesh.get("prefill_launches"), "lm_mesh_train": lm_mesh.get("train_launches")}

    def step_device_ms(kname, run=None):
        """Device ms per step of the instantiations of ``kname`` (or of a
        tuple of kernel names) in a train step's profile (the chained step's
        by default; None without it)."""
        run = chained if run is None else run
        if not run:
            return None
        return sum(v for k, v in run["step_kernels"].items() if kernel_named(k, kname))

    def summary(krows, weights=None, batch=None, prefix="dcgan."):
        """Sums over the main path's layer rows (``prefix``: DCGAN's, one
        generate or one train step, those at ``batch`` if given; the audio
        decoder's), layer i counted ``weights[i]`` times (once each by
        default). Null figures where no such row was measured in this run
        (its phase did not run)."""
        main_rows = [r for r in krows if r["name"].startswith(prefix) and (batch is None or r["B"] == batch)]
        shapes = [{k: r[k] for k in ("name", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_fp32_ms",
                                     "instantiation", "max_abs_err") if k in r} for r in krows]
        if not main_rows:
            return dict(ms=None, plain_ms=None, bound_ms=None, bound_by=None, library_ms=None,
                        max_abs_err=max((r["max_abs_err"] for r in krows), default=None), shapes=shapes)
        wts = weights or (1,) * len(main_rows)
        tot = {k: sum(w * r[k] for w, r in zip(wts, main_rows)) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        by_bytes = sum(w * 1e3 * r["bytes"] / peaks[1] for w, r in zip(wts, main_rows))
        by_ops = sum(w * r.get("bound_ops_ms", 1e3 * r["ops"] / peaks[0]) for w, r in zip(wts, main_rows))
        tc = {"bound_fp32_ms": sum(w * r["bound_fp32_ms"] for w, r in zip(wts, main_rows))} \
            if all("bound_fp32_ms" in r for r in main_rows) else {}
        return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                    bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=tot["library_ms"], **tc,
                    max_abs_err=max((r["max_abs_err"] for r in krows), default=None), shapes=shapes)

    def by_path(row):
        paths = {path: None if n is None else n[row] for path, n in path_launches.items()}
        return dict(launches=sum(n for n in paths.values() if n), launches_by_path=paths)

    line = [{"name": "fused_engine_epi", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
             "corner": "deconv", **by_path("fused_engine_epi"),
             # ms ... library_ms: one DCGAN generate at batch 8, the four layer shapes summed
             **summary(rows, batch=8), "step_profile_ms": step_device_ms(FWD_KERNELS)}]
    if rows:
        line[0]["train_step_batch128"] = {k: v for k, v in summary(rows, batch=TRAIN_BATCH).items()
                                          if k != "shapes"}
    for key, replaces in (("x", REPLACES_BWD_X), ("w", REPLACES_BWD_W)):
        krows = [r for r in bwd_rows if r["kernel"] == f"fused_engine_bwd_{key}"]
        line.append({"name": f"fused_engine_bwd_{key}", "route": "cuda", "source": SOURCE_BWD,
                     "replaces": replaces, "corner": "deconv", **by_path(f"fused_engine_bwd_{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, the four layer shapes summed
                     **summary(krows),
                     "step_profile_ms": step_device_ms(BWD_X_KERNELS if key == "x" else BWD_W_KERNELS)})
    for key, replaces in (("fwd", REPLACES), ("bwd_x", REPLACES_BWD_X), ("bwd_w", REPLACES_BWD_W)):
        krows = [r for r in conv_rows if r["kernel"] == f"conv_engine_{key}"]
        weights = chained["per_layer"][key] if chained else None
        line.append({"name": f"conv_engine_{key}", "route": "cuda", "source": SOURCE_CONV,
                     "replaces": replaces + " (conv corner, via src/repro/kernels/winograd_deconv.py)",
                     "corner": "conv", **by_path(f"conv_engine_{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, each discriminator layer
                     # counted as often as the train_chained run launched it per step (per_pass: once
                     # each, when that phase did not run)
                     **summary(krows, weights), "launches_per_step_by_layer": weights,
                     "step_profile_ms": step_device_ms(CONV_KERNELS[key]),
                     "per_pass": {k: v for k, v in summary(krows).items() if k != "shapes"}})
    for key, replaces in (("", REPLACES_DOM), ("_bwd_x", REPLACES_DOM_X), ("_bwd_w", REPLACES_DOM_W)):
        krows = [r for r in domain_rows if r["kernel"] == f"domain_engine{key}"]
        kname = {"": DOMAIN_FWD_KERNELS, "_bwd_x": DOMAIN_BWD_X_KERNELS, "_bwd_w": DOMAIN_BWD_W_KERNELS}[key]
        line.append({"name": f"domain_engine{key}", "route": "cuda", "source": SOURCE_DOM, "replaces": replaces,
                     "corner": "deconv", **by_path(f"domain_engine{key}"),
                     # ms ... library_ms: one DCGAN train step at batch 128, the four layer shapes summed
                     **summary(krows, batch=TRAIN_BATCH), "step_profile_ms": step_device_ms(kname, per_layer)})
        if not key:  # kernel 1 also serves: one DCGAN generate at batch 8
            line[-1]["serve_batch8"] = {k: v for k, v in summary(krows, batch=8).items() if k != "shapes"}
            line[-1]["serve_batch8_profile_ms"] = serve_pl.get("kernel_ms", {}).get("domain_engine")
    scratch = [r for r in domain_rows if r["kernel"] == "fused_engine_scratch"]
    line.append({"name": "fused_engine_scratch", "route": "cuda", "source": SOURCE, "replaces": REPLACES_SCRATCH,
                 "corner": "deconv", **by_path("fused_engine_scratch"),
                 # ms ... library_ms: one DCGAN generate at batch 8, the four layer shapes summed
                 **summary(scratch, batch=8),
                 "train_step_batch128": {k: v for k, v in summary(scratch, batch=TRAIN_BATCH).items()
                                         if k != "shapes"},
                 "serve_batch8_profile_ms": serve_pl.get("kernel_ms", {}).get("fused_engine_scratch")})
    for key, replaces in (("nlc", REPLACES_1D_NLC), ("scratch", REPLACES_1D_SCRATCH)):
        krows = [r for r in rows_1d if r["kernel"] == f"engine1d_{key}"]
        line.append({"name": f"engine1d_{key}", "route": "cuda", "source": SOURCE_1D, "replaces": replaces,
                     "corner": "1d", **by_path(f"engine1d_{key}"),
                     # ms ... library_ms: one audio decoder forward at batch 16, the three layers summed
                     **summary(krows, prefix="audio."),
                     "decode_profile_ms": audio.get("fwd_kernel_ms", {}).get(AUDIO_BATCH) if key == "nlc" else None})
        if key == "nlc":  # one decode at batch 1, the three layers summed
            line[-1]["decode_batch1"] = {k: v for k, v in summary(krows, prefix="audio_b1.").items()
                                         if k != "shapes"}
            # one Mamba2-780m prefill at batch 1: per layer conv_x (C = 3072) once, conv_B and conv_C (C = 128)
            lm_rows = lm.get("rows", [])
            line[-1]["mamba2_prefill"] = summary(lm_rows, weights=(48, 96), batch=1, prefix="mamba2.")
            b1 = [r for r in lm_rows if r["B"] == 1]
            line[-1]["mamba2_prefill"].update({k: sum(w * r[k] for w, r in zip((48, 96), b1)) if b1 else None
                                               for k in ("library_depthwise_ms", "bound_depthwise_ms")})
    for key, replaces, weights in (("x", REPLACES_DOM_X, (0, 1, 1)), ("w", REPLACES_DOM_W, (1, 1, 1))):
        krows = [r for r in rows_1d if r["kernel"] == f"domain_engine_bwd_{key}_rank1"]
        line.append({"name": f"domain_engine_bwd_{key}_rank1", "route": "cuda", "source": SOURCE_DOM,
                     "replaces": replaces + " (rank 1, via src/repro/kernels/engine.py:"
                     + ("1772" if key == "x" else "1818") + ")", "corner": "1d",
                     **by_path(f"domain_engine_bwd_{key}_rank1"),
                     # ms ... library_ms: one audio decoder gradient at batch 16, each layer counted as often
                     # as the audio gradient run launches it (kernel 4: not on layer 0, whose input is the latent)
                     **summary(krows, weights, prefix="audio."), "launches_per_gradient_by_layer": weights,
                     "grad_profile_ms": sum(v for k, v in audio.get("grad_kernels", {}).items()
                                            if f"domain_bwd_{key}_" in k) if audio else None})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
