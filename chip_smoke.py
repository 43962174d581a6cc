#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It imports only ``onset_fingerprinting_torch`` (never jax) and fails with a
non-zero exit code, printing no result, on any error or without CUDA.

Phase 0  prints the card's name and power limit, starts the plain
         realtime engine on the CPU in a child process (phase 4's
         reference), the plain detector over 6b's recording in another
         (phase 6b's) and over its channel 0 in a third (7a's), the plain
         engine with ``cc_refine=True`` over the stream's first 2 s in a
         fourth (8d's), the detector tuner at 9a's three slider settings
         over 6b's recording in three more (one each), and builds the
         twelve kernel libraries from
         ``onset_fingerprinting_torch/csrc`` with nvcc, all started
         together.
Phase 1  holds each kernel against its plain PyTorch version on the card
         (TF32 off for cuDNN and matmuls): K1 the fused detector bit for
         bit (warmup state, on, deltas, rel, state) on each of its kernels
         — the pipe at the fleet width on two seeds and at a ragged width,
         the pipe's coupled instantiation (lane groups, the route of every
         coupled call of more than one block at C <= 32) in coupled_off +
         backtrack, at the realtime engine's config (C = 3, no high-pass)
         and at C = 32, the one-thread-per-channel kernel at C = 1000 —
         and, at
         the fleet shape as the main path runs it (events only), the pipe
         against the plain detector and against the other kernel bit for
         bit, and the two kernels timed; K2 the window gather
         and K4 the roll gather on each of their two kernels
         (``tools/gather_bench.run``: the row-vector kernels the routes
         take and the old one-float-per-thread ones), bit-exact
         (K2 in both contracts, K4 also equal to K2's block-aligned
         windows) on 32768 random hits with clipped starts and on the fleet
         path's own hit list, timed in this process on both, with the
         useful-bytes bound and the sector floor of those hits, and
         bit-exact once more at a ragged C and N; K3 the fused conv stack
         (flagship, 131072 signals): bfloat16 on the tensor-core kernel
         (four draws of weights, biases and input; a far signal is saved
         under ``build/conv_stack_far/``), float32 on the CUDA-core kernel
         (two draws: the path's windows, then unit-normal input with the
         flagship's second weight seed; its plan's CTAs per SM held to the
         card's occupancy query), and a bfloat16 stack with no tensor-core
         plan (16 features at every layer, 8192 windows) on the CUDA-core
         kernel, each dtype timed beside its cuDNN conv1d chain; and the
         bf16 flagship at B = 48 and B = 3 (L = 256) on the cluster kernel
         (``csrc/conv_stack_mma_cluster.cu``, the route of a batch that
         leaves the card idle) against the plain version.
Phase 2  drives the fleet path at full width — 8192 four-channel 96 kHz
         streams, three carried chunks of 32000 samples after a 38-block
         warmup, the flagship CCCNN in bfloat16 with random weights carried
         across in flax layout — gates recall/precision/dropped hits, shows
         that every kernel launched and no plain version ran, times each
         stage with CUDA events (median over 5 iterations of varied
         input), and compares the path with its plain version on the CPU at
         32 streams.  The bf16 path must take the tensor-core K3 and never
         the CUDA-core one, the pipelined K1 (4 launches) and never the
         one-thread-per-channel one, and K2's routed kernel and
         instantiation (3 launches) and no other K2.
Phase 2b drives the same fleet path with the flagship CCCNN in float32, the
         model's default dtype (JAX: ``CCCNN(dtype=float32,
         conv_impl="pallas")``, whose conv stack takes HIGHEST band products
         and whose DFT head runs at "highest"): the same gates, K3 on the
         CUDA-core kernel once per chunk and never on the tensor-core one,
         each stage timed with CUDA events over 2 iterations (not 5: the
         script's time limit) and no profiler pass; at 32 streams K3 on the
         path's windows within atol 5e-4 / rtol 1e-4 of the plain version
         on the CPU and the predictions within 1e-4 + 1e-4 |CPU| (float32,
         TF32 off).
Phase 2c holds the CCCNN's bf16 DFT head kernel (``csrc/cccnn_head.cu``) to
         its plain version on the card at the benchmark cells' calls
         (36480 x 4 windows and 2 outputs, 32768 x 3 and 3, 3712 x 4 and
         2), one launch a call, and times it beside its bound, the plain
         version and the chain it replaces (cuBLAS bf16 GEMMs, ATen passes,
         the f32 dense layer).  ``--only-head`` runs the build, 2c and the
         realtime engine's classify call (16 hits, a graph of 16; the
         classifier's 512-sample windows keep the chain).
Phase 3  drives the fingerprint-stage anatomy
         (``tools.fingerprint_anatomy.main``) at full width — 8192 streams,
         G = 32768, W = 256 — shows that K3 and the routed K2 and K4
         launched (and no other gather kernel) and no plain version ran,
         checks the pair head's predictions, prints the per-chunk table
         (with the DFT head at bf16 and at f32, and on a contiguous copy of
         its input), holds the bf16 head to its CPU emulation on the path's
         features, and compares the pair-head CCCNN on the card with its
         plain version on the CPU at 32 streams (float32, TF32 off).
Phase 4  drives the realtime engine (``tools.realtime_sim``: 3 sensors at
         96 kHz, 128-sample blocks, the step replayed from a CUDA graph)
         over a 20 s stream of 80 strikes, harvesting every 64 blocks and
         classifying each hit with the bf16 flagship CCCNN (3 x 512) from
         the device ring; shows that the captured step is two kernel
         nodes and nothing else (no copy); gates the locate rate and median
         error, shows that K1 (coupled, one warp per channel, one launch
         per block) and the locate kernel with the ring write ran on every
         step,
         the coupled pipe once for the warmup, and K3 for the classifier,
         with no plain version; holds the
         device ring after the run to the stream's last 16 s bit for bit,
         counter included; holds the events of the first 5 s to the plain
         engine on the CPU and the classifier to its plain version on the
         same windows; holds K1, in place as the step calls it, over the
         first 0.5 s to the plain detector (events and state; the plain
         detector takes ~50 ms a block on the card), the locate kernel,
         in place, to its plain version on their fired and quiet blocks,
         and the locate launch's ring write to the plain ring write on
         copies of the engine's ring with the head wrapping past the
         ring's end and past the int32 counter's largest value; times the
         step (graph replays, a graph of 256 steps, eager), K1 at [128, 3]
         per launch in a graph of launches (detector_warp.cu and the
         coupled pipe in turns) beside detector.cu and an empty kernel,
         the locate kernel on quiet and fired blocks, the ring write (the
         locate launch with it less the launch without it, on quiet
         blocks, in turns), and K3 at the classifier's shape (B = 48, L =
         512) on the kernel its route takes, the cluster kernel: bit for
         bit against ``csrc/conv_stack_mma.cu`` (named) on two seeds, held
         to the plain version and the witness gate, per call in a graph of
         16 in turns with that kernel, and the engine's whole classify call
         (ring gather, K3, head, dense) in turns with either kernel
         (``tools/step_bench``).
Phase 5  trains on the card.  5a holds K3 under autograd at the training
         shape (B = 9216, L = 256, both routes) to autograd of the plain
         chain on the card: the forward at phase 1's tolerances, the grads
         of x, weights and biases within 1e-5 of their scale (f32) or
         3e-2 / 2e-2 (bf16), with TF32 on in the process flags around the
         backward (the recompute turns it off); one launch per forward, one
         recompute per backward, no plain call.  5c runs
         ``tools.fingerprint_capability.run`` at the JAX demo's fixture
         (768 hits; epochs cut 2000 -> 200 for every model; the CCCNNs
         from seeds 0-4), gates the demo's bars and the float32 fleet
         flagship's on the medians, shows that K3 f32 launched once per
         forward of that model (and recomputed once per step), the
         tensor-core K3 and every other kernel never, no plain version,
         and times each model's step and the flagship's split.  5b trains
         the float32 flagship from one init for 10 full-batch adam steps
         on 256 of the fixture's windows on the card and on the CPU in
         this process: the losses within 1e-4 relative at every step.
Phase 6  the player's setup loop at the JAX journey's size (3 sensors at
         96 kHz, 128-sample blocks, FCNN [10, 10, 10] with BatchNorm).  6a
         holds the locate kernel with an FCNN (random weights from a seed,
         both ``model_input`` modes; and FCNNs of [32, 32], [128, 128] and
         12 layers of 16, past the plan's old bounds), in place, to its
         plain version on the realtime stream's fired and quiet blocks
         (state and events exactly, points within 1e-3 cm) and times it
         per launch in a graph of launches beside the Newton kernel.  6b runs
         tests/test_journey.py's arrival journey on the card: 48 hits (seed
         3) mined by ``mine_file(fix=True)`` with K1 (the coupled pipe,
         one launch for the 0.5 s warmup and one for the whole recording)
         and no plain call, K1's events over the recording equal to the
         plain detector's on the CPU (a child process started in phase 0;
         rel within 2e-2 + 1e-3 |rel|), bit-identical to the plain
         detector on the card over the first 0.2 s and to
         ``detector_warp.cu`` (named) over the whole recording, both
         kernels' two launches timed in turns;
         the FCNN trained (1500 epochs), ``save_setup`` → ``build_engine``
         → 8 fresh hits through ``process`` with the journey's bars; the
         captured step two kernel nodes, the locate kernel taking the
         model and the ring write on every step, no plain version; the
         events equal to the
         plain engine on the CPU with the same weights.  6c the full-head
         journey (``by_channel``, 96 hits, 2500 epochs) served through
         ``run_wav`` (the native executor, the pipelined dispatcher).  6d
         ``examples/calibration_demo.py``'s stages 1-2 on the card and on
         the CPU: the TDOA residual under 2 samples, the refined C, the
         positions within 1e-4 m of the CPU's, both timed.
Phase 7  the classification pillar and the reference-model migration.  7a
         ``detect_onsets`` over channel 0 of 6b's recording: the spectral
         route on the card against the CPU (the same peaks, the flux
         within 1e-5 of its scale), the amplitude route on the card (K1,
         two launches, no plain call) against the plain detector on the
         CPU (a child process from phase 0; the same onsets).  7b
         ``tools.zone_classifier.run`` at the JAX demo's defaults (150
         hits per zone, 3 rounds of augmentation, the modal transform, the
         CNN trained 700 epochs, seed 0) on the card through POSD's device
         half: held-out accuracy >= 0.60, no plain call, the MFCC and modal
         transforms on the card within 1e-4 of the CPU's on the same rows,
         the augmentation, the transform, training and the two
         augmentation recursions timed.  7c reference-layout checkpoints
         (CNN, the flagship CCCNN with ``conv_impl="pallas"``, a
         bidirectional 2-layer GRU RNN, a CNNRNN; seeded weights) through
         ``models.torch_import``: each model on the card within 1e-4 of its
         scale of the CPU's; the imported CCCNN serves 1024 of phase 5's
         capability windows through K3 f32 (one launch, nothing else), K3
         at that shape held to its plain version at 5e-4/1e-4 and timed
         beside cuDNN's f32 chain.  7d the leftover ops on the card against
         the CPU (``ar_envelope``, ``streaming_cc_scan``,
         ``batch_cross_correlate_dft``) and the host ``Multilaterate`` on a
         16-strike onset stream against the true positions.

Phase 8  the parallel package on a world-1 NCCL process group (a localhost
         store; NCCL takes no two ranks on one card, so the CPU tests show
         two ranks), destroyed at the end.  8a
         ``make_detect_fingerprint_sharded`` at bench.py's headline point
         (8192 streams x 4, layout 'wide', one chunk of 32000 samples,
         compact_capacity 32768, the bf16 flagship): one launch each of
         K1's pipe, K2 (gather_vec, not anchored) and K3 (mma), no plain
         call; starts, valid, n_dropped and predictions equal to
         ``pipeline.DetectFingerprint``'s stages on the same chunk and
         state with block-start windows; a chunk timed.  8b
         ``detect_offline_time_sharded`` and ``detect_events_time_sharded``
         over 6b's recording (two coupled-pipe launches): dense events and
         the all_gather-ed event list equal to the sequential K1.  8c
         ``make_detect_locate_sharded`` over 1024 streams of the realtime
         demo's drum (2 s each, a seed per stream, 32 events per stream,
         the bf16 flagship classifier on 256-sample windows): one K1
         launch over the batch of streams (the coupled pipe, 8 streams a
         CTA), one launch of the stream-batched locate kernel, K3; the
         located rate and median error against the truth at the realtime
         bars; the locate kernel equal to its plain scan on the CPU on 8
         streams, K1 to the plain detector on 3 streams' first 24064
         samples on the CPU, bit-identical to ``detector_warp.cu``'s
         stream batch (named) at the full shape and to the plain detector
         under ``vmap`` on the card on 64 streams' first 24064 samples;
         K1 old and new timed in turns, the locate kernel timed.  8d
         ``tools.realtime_sim`` with ``cc_refine=True`` over phase 4's 20 s
         stream: two kernel nodes, phase 4's bars, the first 2 s equal to
         the plain engine on the CPU (a fourth child process from phase 0),
         the refining locate kernel with the ring write in place against
         the plain ring write and its plain version block by block on the
         first 2 s (the ring bit for bit; each logged refinement held to
         the plain CC, where an argmax may differ only at a float32 tie,
         and to the kernel's schedule on the CPU exactly), its launch
         timed on fired and on quiet blocks beside the Newton kernel's, in
         turns, and on fired blocks with an FCNN (variant
         ``fcnn+cc_refine``).  8e the capability fixture's float32
         flagship, 10 full-batch steps with ``Trainer(mesh=)`` against the
         unmeshed trainer: losses within 1e-6 relative.

Phase 9  the last modules of the JAX package on the card.  9a
         ``tools.choose_od_settings.DetectorTuner`` over 6b's recording
         ([299904, 3]) at the defaults and two other slider settings:
         channels, onsets and groups equal to the tuner on the CPU (child
         processes from phase 0), two K1 launches (the coupled pipe) per
         detect() and no plain call, a warm detect() timed by the host
         clock (the slider-change latency).  9b ``utils.metrics.
         profile_trace`` around one detect() under ``trace("tuner.detect",
         metrics)`` and 8 engine steps: the Chrome trace it writes names the
         span and K1's kernel (no CUDA event fails the phase), and the
         Metrics hold the span.  9c ``python -m onset_fingerprinting_torch.
         tools.realtime_sim --serve`` in a child process (a fresh
         interpreter, as a user runs it) over 30 s of the realtime demo's
         stream (119 strikes; the demo's 60 s cut) at realtime pacing: the
         zone CNN trained on the card, the native
         ring and executor, the dispatcher, harvester and classifier
         threads, ``Metrics``; every card gate (>= 99% located, median
         error <= 0.2 cm, zone accuracy >= 0.8, audio-thread p99 under
         1.333 ms, 0 drops, 0 harvest overflows, the hit-latency p50 bound,
         the north-star estimate under 1 ms); K1 and the locate kernel
         with the ring write launched on every served block, the coupled
         pipe
         once for the warmup, no plain call.

Phase 10 the examples' twins (``tools/``), each at its example's defaults
         with the example's gate, its launches (exactly the kernels named,
         no other) and no plain call.  10a ``serving_window_accuracy``
         (512 hits, two CCCNNs over 1500 epochs): K1 twice on the coupled
         pipe, K2 once on ``gather_vec.cu`` at cps 4 (its route printed
         and held); the session's K1 output (channels, onsets, rel) bit
         for bit against ``detector_warp.cu`` over the same tensor, the
         anchors from both equal, the anchored windows equal to exact
         slices of the session; the models' GroupNorm stacks run the
         cuDNN chain, not K3.  10b ``location_hpo`` (2 TPE trials x 300
         epochs): no hand-written kernel.  10c ``fleet_detect`` (8
         streams of 1 s on ``parallel.default_mesh``, no process group):
         one K1 launch on the pipe; on/deltas and the located points
         equal to the CPU's.  10d ``e2e_locate`` (8 hits): K1 twice on
         the coupled pipe; channels, onsets, groups and points equal to
         the CPU's.  10c's and 10d's references run in a child process
         that phase 10 starts beside 10a and 10b (after 9c's realtime
         pacing).  10e ``calibration_run``, stages 1-4.  10f ``cc_bench``
         (plain PyTorch: no TPU kernel computes it): the scan against the
         CPU.

Each phase line prints the seconds of the phase before it.

Prints one ``{"kernels": [...]}`` line (K1 as three rows: ``detector``,
the pipe, the fleet path's; ``detector_warp``, the warp-per-channel kernel
of the coupled mode, the realtime engine's, timed at [128, 3];
``detector_coupled``, the one-thread-per-channel kernel, timed at [128, 3],
which no path launches; K2 and K4 as two rows each, timed on the random
hits: ``gather_vec`` and ``gather_roll_vec``, the paths' kernels, and
``gather`` and ``gather_roll``, the old kernels, which the paths never
launch; K3 as four rows: ``conv_stack_mma`` in bfloat16, the fleet path's,
``conv_stack_mma_classifier``, the cluster kernel at the realtime
classifier's shape and with its launches,
``conv_stack_mma_classifier_pr3``, the fleet's kernel at that shape, which
no path launches; ``conv_stack_f32`` in float32, the CUDA-core
kernel, phase 2b's; ``locate_block``, the realtime engine's locate
step, which replaces no TPU kernel, timed on fired blocks; ``ring_write``,
the engine's audio-ring write, which replaces no TPU kernel either: it
runs inside the locate launch, so its source is
``csrc/locate_block.cu``, its time the launch with the write less the
launch without it on quiet blocks, and its launches the locate launches
that wrote the ring;
``detector_warp_mining``, K1's warp kernel timed over 6b's warmup and
recording, which no path launches since PR 14; ``locate_block_fcnn``, the locate kernel
with the learned locator, timed on fired blocks; ``locate_block_fcnn_wide``,
the same with a [128, 128] FCNN, which no path launches;
``conv_stack_f32_imported``, K3 f32 serving the imported reference CCCNN,
timed at its shape; ``detector_warp_streams``, K1's warp kernel over 8c's
batch of streams, which no path launches either; ``locate_streams``, the locate kernel's stream-batched
entry at 8c's shape; ``locate_block_cc_refine``, the locate kernel with
CC refinement, timed on fired blocks; ``detector_pipe_coupled``, the
pipe's coupled instantiation over one recording, timed at mining's two
launches, with the launches of mining, the tuner, the engines' warmups,
time sharding and 7a; ``detector_pipe_coupled_streams``, the same over
8c's batch of streams; ``cccnn_head``, the CCCNN's bf16 DFT head, which
replaces no TPU kernel, timed at the fleet's call).  Launch counts are the
sums over
the paths that phases 2, 2b, 3, 4, 5c, 6, 7, 8, 9 and 10 drive, each from
counts set to 0 just before it (``detector_warp`` counts the engines'
(9c's serve loop's too), ``locate_block`` the Newton engines', the FCNN rows phase 6's,
``conv_stack_f32_imported`` 7c's).  Last comes ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_STREAMS = 8192
CHUNK = 32000
CHUNKS = 3
WARMUP_BLOCKS = 38
ITERS = 5
#: draws of the flagship conv stack's weights, biases and input for K3's
#: bf16 check (the first on the path's windows)
K3_SEEDS = 4
#: global hit capacity of the gather and anatomy phases
G = 32768
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 FMA-unit
#: FLOP/s (an FMA counted as two), f64 FMA-unit FLOP/s (not the tensor
#: cores'), dense bf16 tensor FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
BF16_FLOPS = 989e12
#: FP32 lane instructions per second, an FMA or any other one counted as
#: one: 132 SMs x 128 lanes x 1.98 GHz
LANE_OPS = 33.5e12
#: FP32-pipe instructions (F* and MUFU in SASS) per channel-sample of the
#: detector's arithmetic in the fleet mode (high-pass, adaptive
#: thresholds), counted by tools/detector_split.py in detector.cu's
#: innermost loops (IIR, dB with log2f, envelopes, linear with exp2f,
#: min/max, pass 2); -fmad=false leaves no FMA to fuse them
DETECTOR_OPS_PER_SAMPLE = 77
#: K1's chain bound for one detector: its longest recurrence, the envelope
#: step (xdb - y, + eps, the attack/release select, x the step, + y), is
#: 6 dependent FP32 operations a sample at ~4 cycles each, at the SM clock
#: (1.98 GHz, as LANE_OPS); T samples cannot take less however many lanes
#: run beside them
CHAIN_CYCLES_PER_SAMPLE = 6 * 4
SM_HZ = 1.98e9


def log(*a):
    print(*a, flush=True)


def time_ms(fn, n=5, warm=1):
    """Mean device time of ``fn`` over ``n`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def states_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def check_detector(name, cfg, x, warmup_blocks=WARMUP_BLOCKS):
    """K1 (the kernel ``kernel_for`` names) against the plain detector on
    ``x``, bit for bit: the warmup state, then on, deltas, rel and every
    state tensor of detection from the warmed state."""
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        kernel_for,
        make_fused_detector,
    )

    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=True)
    kernel = kernel_for(fst.plain, x.shape[0])
    before = kernel.launches
    lead = x[: warmup_blocks * 128]
    wk = fused_warmup_minmax(fst, params, st0, lead)
    wp = warmup_minmax(fst.plain, params, st0, lead)
    check(states_equal(wk, wp), f"K1 warmup state differs ({name})")
    sk, (on_k, d_k, rel_k) = fused_detect_offline(fst, params, wk, x)
    sp, (on_p, d_p, rel_p) = detect_offline(fst.plain, params, wp, x)
    torch.cuda.synchronize()
    check(kernel.launches == before + 2, f"K1 {name} did not run on "
          f"{kernel.name}")
    check(torch.equal(on_k, on_p), f"K1 on differs ({name})")
    check(torch.equal(d_k, d_p), f"K1 deltas differ ({name})")
    check(torch.equal(rel_k, rel_p),
          f"K1 rel differs ({name}): max err {max_err(rel_k, rel_p)}")
    for field, u, v in zip(sk._fields, sk, sp):
        check(torch.equal(u, v), f"K1 state {field} differs ({name})")
    log(f"K1 {name} ({kernel.name}): {int(on_k.sum())} events; warmup "
        "state, on, deltas, rel and state bit-identical to plain")
    return kernel


def phase_detector(report):
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import detect_offline
    from onset_fingerprinting_torch.locate.multilaterate import locator_init
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        _launch,
        fused_detect_offline,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.pipeline import fleet_detector_config
    from onset_fingerprinting_torch.workload import make_audio

    c = N_STREAMS * 4
    ragged = c - 20  # the last CTA holds 12 of 32 channels
    cases = [
        (f"fleet C={c} seed 1", fleet_detector_config(N_STREAMS), c, 1),
        (f"fleet C={c} seed 7", fleet_detector_config(N_STREAMS), c, 7),
        (f"C={ragged} per-channel gate (ragged)", DetectorConfig(
            n_channels=ragged, hipass_freq=2000.0, coupled_off_gate=False),
         ragged, 3),
        ("C=3 coupled_off backtrack", DetectorConfig(
            n_channels=3, backtrack=True, backtrack_buffer_size=256), 3, 1),
        ("C=3 coupled_off, no high-pass (the realtime engine's)",
         DetectorConfig(n_channels=3, hipass_freq=0.0), 3, 5),
        ("C=32 coupled_off high-pass backtrack", DetectorConfig(
            n_channels=32, backtrack=True, backtrack_buffer_size=256,
            hipass_freq=2000.0), 32, 2),
        ("C=1000 coupled_off backtrack (scratch stage)", DetectorConfig(
            n_channels=1000, backtrack=True, backtrack_buffer_size=256),
         1000, 1),
    ]
    for name, cfg, n_ch, seed in cases:
        x = make_audio(64 * 128, n_ch, seed=seed)
        kernel = check_detector(name, cfg, x)
        want = (_cuda.DETECTOR_PIPE if not cfg.coupled_off_gate
                else _cuda.DETECTOR_PIPE_COUPLED if n_ch <= 32
                else _cuda.DETECTOR)
        check(kernel is want, f"K1 {name} routed to {kernel.name}")
        del x

    # the fleet shape as the main path runs it (one chunk, events only: the
    # pipe's instantiation without rel), held to the plain detector and to
    # the one-thread-per-channel kernel through its private launcher
    cfg = fleet_detector_config(N_STREAMS)
    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=False)
    x = make_audio(CHUNK, cfg.n_channels, seed=2)
    sk, (on_k, d_k, _) = fused_detect_offline(fst, params, st0, x, False)
    so, (on_o, d_o, _) = _launch(fst, params, st0, x, False, False,
                                 _cuda.DETECTOR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sp, (on_p, d_p, rel_p) = detect_offline(fst.plain, params, st0, x)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(on_k, on_p) and torch.equal(d_k, d_p)
          and states_equal(sk, sp), "K1: the pipe differs from the plain "
          "detector at the fleet shape, events only")
    check(torch.equal(on_k, on_o) and torch.equal(d_k, d_o)
          and states_equal(sk, so), "K1: the two kernels differ at the "
          "fleet shape")
    log(f"K1 fleet shape events only: {int(on_k.sum())} events; on, deltas "
        "and state of the pipe bit-identical to plain and to detector.cu")
    del sp, on_p, d_p, rel_p
    ms = time_ms(lambda: fused_detect_offline(fst, params, st0, x, False))
    old_ms = time_ms(lambda: _launch(fst, params, st0, x, False, False,
                                     _cuda.DETECTOR))
    report["detector"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                              library_ms=None, **detector_work(x.shape))
    log(f"K1 time at [{x.shape[0]}, {x.shape[1]}]: pipe (detector_pipe.cu) "
        f"{ms:.3f} ms, one thread per channel (detector.cu) {old_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms (one call)")
    del x, sk, so


def chain_bound_ms(t):
    """K1's chain bound over ``t`` samples of one detector (the streams of a
    batch run side by side)."""
    return 1e3 * t * CHAIN_CYCLES_PER_SAMPLE / SM_HZ


def bounds_line(work, t):
    """The operations, bytes and chain bounds of K1 work, for a log line."""
    return (f"bounds: operations {1e3 * work['ops'] / work['peak']:.4f} ms, "
            f"bytes {1e3 * work['bytes'] / HBM_BPS:.4f} ms, chain "
            f"{chain_bound_ms(t):.4f} ms (T = {t} x "
            f"{CHAIN_CYCLES_PER_SAMPLE} cycles / {SM_HZ / 1e9:g} GHz)")


def detector_work(shape):
    """K1's least work on ``x [T, C]``, events only: x read once, events
    and state read and written once; ``DETECTOR_OPS_PER_SAMPLE`` lane
    instructions per channel-sample at the lane rate."""
    t, c = shape
    nb = t // 128
    state_bytes = 2 * c * (4 * 4 + 6 * 4 + 1)
    return dict(bytes=t * c * 4 + nb * c * (1 + 4) + state_bytes,
                ops=t * c * DETECTOR_OPS_PER_SAMPLE, peak=LANE_OPS)


#: the gathers' kernels-line rows: (row, gather, route name)
GATHER_ROWS = (("gather", "k2", "old"), ("gather_vec", "k2", "vec"),
               ("gather_roll", "k4", "old"), ("gather_roll_vec", "k4", "vec"))


def phase_gather(report, x):
    """K2 and K4 on every kernel that takes the fleet shape
    (``tools/gather_bench.run``: bit-exact to plain, K4 also to K2's
    block-aligned windows, on random and on the fleet path's hits, then
    timed old against new in this process), and once more at a ragged
    shape.  Returns K2's windows at the random hits for K3's check."""
    from onset_fingerprinting_torch.ops import windows as ow
    from onset_fingerprinting_torch.tools import gather_bench as gb
    from onset_fingerprinting_torch.workload import PRE, WINDOW

    t, c = x.shape
    res = gb.run(x, N_STREAMS, G, log=log)
    for row, which, route in GATHER_ROWS:
        r = res[which]["random"]
        report[row] = dict(
            max_abs_err=0.0, ms=float(np.mean(r["ms"][route])),
            plain_ms=float(np.mean(r["ms"]["plain"])), bytes=r["useful_bytes"],
            ops=0, peak=F32_FLOPS,
            library_ms=float(np.mean(r["ms"]["library"])))
    # a ragged shape: C not a multiple of 128 (K2), a hit count that fills
    # no CTA or ring evenly, on every route that takes it
    cr, n = c - 12, G - 13
    xr = x[:, :cr].contiguous()
    starts, sids = gb.random_hits(t, cr, 4, n, 11, x.device)
    for anchored in (True, False):
        plain = ow.gather_hit_windows_reference(xr, starts, sids, 4, WINDOW,
                                                PRE, anchored)
        for name, route in ow.gather_routes(4, WINDOW,
                                            xr.data_ptr()).items():
            got = ow._launch_gather(route, xr, starts, sids, 4, WINDOW, PRE,
                                    anchored)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"K2 {name} differs at the ragged "
                  f"C={cr}, N={n}, anchored={anchored}")
    del xr, plain, got
    rows8 = torch.clamp(starts - PRE, 0, t - WINDOW) // 8 * 8
    plain = ow.gather_windows_roll_reference(x, rows8, sids, 4, WINDOW)
    for name, route in ow.roll_routes(4, WINDOW, x.data_ptr()).items():
        got = ow._launch_roll(route, x, rows8, sids, 4, WINDOW)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"K4 {name} differs at N={n}")
    log(f"K2 at C={cr}, N={n} (both contracts) and K4 at N={n}: every "
        "route bit-exact")
    starts, sids = gb.random_hits(t, c, 4, G, 3, x.device)
    return ow.gather_hit_windows(x, starts, sids, 4, WINDOW, PRE, True)


def gate_far(k, p, x, ws, bs, tag, padding=1, activation="silu"):
    """K3 bf16 against plain (``tools/conv_stack_gate.gate``): few signals
    more than about one bf16 ulp apart, each but a few explained by one
    bf16 rounding flipped at a near-tie.  Every far signal is saved for
    ``tools/conv_stack_gate.py --witness``."""
    from onset_fingerprinting_torch.tools.conv_stack_gate import (
        FAR_DIR,
        far_cap,
        gate,
        passes,
        save_far,
        unexplained_limit,
    )

    far, bad = gate(k, p, x, ws, bs, padding, activation)
    where = ""
    if len(far):
        path = save_far(FAR_DIR / f"chip_smoke_{tag}.pt", far, x, ws, bs, k, p,
                        padding, activation)
        where = f", saved to {path}"
    check(passes(far, bad, len(x)),
          f"K3 {tag}: {len(far)} signals more than one bf16 ulp from plain "
          f"(cap {far_cap(len(x))}), {len(bad)} not explained by one "
          f"rounding flip (limit {unexplained_limit(len(x))}){where}")
    return f"; {len(far)} signals more than one bf16 ulp apart, all but " \
        f"{len(bad)} explained by one rounding flip{where}"


def wide_stack(seed):
    """The flagship's kernels with 16 features at every layer (no
    tensor-core plan in bf16): LeCun-scaled normal weights, biases
    ``0.1 * N(0, 1)``."""
    from onset_fingerprinting_torch.workload import FLAGSHIP

    g = torch.Generator().manual_seed(seed)
    ws, bs, cin = [], [], 1
    for k in FLAGSHIP["kernel_sizes"]:
        ws.append((torch.randn(16, cin, k, generator=g) / (k * cin) ** 0.5
                   ).cuda())
        bs.append((0.1 * torch.randn(16, generator=g)).cuda())
        cin = 16
    return ws, bs


def phase_conv(report, windows):
    import torch.nn.functional as F

    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
        issued_flops,
        kernel_for,
        mma_plan,
        simt_occupancy,
        simt_plan,
    )
    from onset_fingerprinting_torch.tools.conv_stack_gate import (
        flagship_stack,
    )

    ws, bs = flagship_stack(seed=0)
    x = windows.reshape(-1, windows.shape[-1]).contiguous()  # [131072, 256]
    b_n, length = x.shape
    check(kernel_for(length, ws, 1, torch.bfloat16) is _cuda.CONV_STACK_MMA,
          "the flagship bf16 stack does not take the tensor-core kernel")
    check(kernel_for(length, ws, 1, torch.float32) is _cuda.CONV_STACK,
          "the flagship f32 stack does not take the CUDA-core kernel")
    shapes = [tuple(w.shape) for w in ws]
    plan = simt_plan(length, shapes, 1, 4)
    ctas = simt_occupancy(length, shapes, 1, torch.float32)
    check(ctas == plan.ctas_per_sm, f"K3 f32: the card keeps {ctas} CTAs "
          f"per SM, the plan {plan.ctas_per_sm}")
    log(f"K3 f32 plan: {plan.ns} signals (warps) per CTA, {plan.smem} bytes "
        f"of shared memory, TT {[lp.tt for lp in plan.layers]}; the card "
        f"keeps {ctas} CTAs ({ctas * plan.ns} warps) per SM")
    errs = {}
    # the path's windows, then unit-normal input, each with its own draw of
    # the flagship's random weights and biases: f32 on two draws, bf16 on
    # K3_SEEDS; then a bf16 stack with no tensor-core plan (16 features at
    # every layer) on the path's first 8192 windows
    normal = [torch.randn(x.shape, device="cuda", generator=torch.Generator(
        "cuda").manual_seed(s)) for s in range(1, K3_SEEDS)]
    wide = x[:8192]
    cases = [("f32", torch.float32, x, ws, bs),
             ("f32_seed1", torch.float32, normal[0], *flagship_stack(seed=1))]
    cases += [(f"bf16_seed{s}", torch.bfloat16, x if s == 0 else normal[s - 1],
               *flagship_stack(seed=s)) for s in range(K3_SEEDS)]
    cases += [("bf16_16x7", torch.bfloat16, wide, *wide_stack(seed=5))]
    for tag, dt, xs, wl, bl in cases:
        atol, rtol = (5e-4, 1e-4) if dt == torch.float32 else (3e-2, 2e-2)
        kern = kernel_for(length, wl, 1, dt)
        check(kern is (_cuda.CONV_STACK_MMA if tag.startswith("bf16_seed")
                       else _cuda.CONV_STACK),
              f"K3 {tag} routed to {kern.name}")
        before = kern.launches
        k = conv_stack(xs, wl, bl, 1, "silu", dt)
        p = conv_stack_reference(xs, wl, bl, 1, "silu", dt)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"K3 {tag} did not launch")
        check(k.shape == p.shape, f"K3 shape {k.shape} != {p.shape}")
        err = max_err(k, p)
        bad = ((k - p).abs() > atol + rtol * p.abs()).sum()
        check(int(bad) == 0, f"K3 {tag}: {int(bad)} values outside atol "
              f"{atol} rtol {rtol} (max err {err})")
        far = (gate_far(k, p, xs, wl, bl, tag)
               if kern is _cuda.CONV_STACK_MMA else "")
        key = (kern.name, dt)
        errs[key] = max(errs.get(key, 0.0), err)
        log(f"K3 {tag} ({kern.name}) B={len(xs)}: max err {err:.3g} vs "
            f"plain (atol {atol}, rtol {rtol}){far}")
        del k, p
    # the cluster kernel, the route of a batch that leaves the card idle:
    # B = 48 and an odd B = 3 at L = 256
    for b_c in (48, 3):
        xs = normal[0][:b_c].contiguous()
        tag = f"bf16_cluster_{b_c}"
        kern = kernel_for(length, ws, 1, torch.bfloat16, b_c)
        check(kern is _cuda.CONV_STACK_MMA_CLUSTER,
              f"K3 {tag} routed to {kern.name}")
        before = kern.launches
        k = conv_stack(xs, ws, bs, 1, "silu", torch.bfloat16)
        p = conv_stack_reference(xs, ws, bs, 1, "silu", torch.bfloat16)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"K3 {tag} did not launch")
        check(k.shape == p.shape, f"K3 {tag} shape {k.shape} != {p.shape}")
        err = max_err(k, p)
        bad = ((k - p).abs() > 3e-2 + 2e-2 * p.abs()).sum()
        check(int(bad) == 0, f"K3 {tag}: {int(bad)} values outside atol "
              f"3e-2 rtol 2e-2 (max err {err})")
        far = gate_far(k, p, xs, ws, bs, tag)
        log(f"K3 {tag} ({kern.name}) B={b_c}, L={length}: max err {err:.3g} "
            f"vs plain (atol 3e-2, rtol 2e-2){far}")
    del normal, wide
    times = {}
    for dt in (torch.bfloat16, torch.float32):
        wl = [w.to(dt) for w in ws]
        bl = [b.to(dt) for b in bs]
        xl = x.to(dt)[:, None, :]

        def library(wl=wl, bl=bl, xl=xl):
            y = xl
            for w, b in zip(wl, bl):
                y = F.silu(F.conv1d(y, w, b, padding=1))
            return y

        times[dt] = dict(
            ms=time_ms(lambda dt=dt: conv_stack(x, ws, bs, 1, "silu", dt),
                       n=20),
            plain_ms=time_ms(lambda dt=dt: conv_stack_reference(
                x, ws, bs, 1, "silu", dt)),
            library_ms=time_ms(library),
        )
    flops, t = 0, length
    for w in ws:
        o, i, kk = w.shape
        t = t + 2 - kk + 1
        flops += 2 * o * i * kk * t * b_n
    issued = issued_flops(mma_plan(length, [tuple(w.shape) for w in ws], 1),
                          b_n)
    bytes_ = b_n * length * 4 + b_n * t * ws[-1].shape[0] * 4
    for name, dt, peak in (("conv_stack_mma", torch.bfloat16, BF16_FLOPS),
                           ("conv_stack_f32", torch.float32, F32_FLOPS)):
        report[name] = dict(max_abs_err=errs[(kernel_for(
            length, ws, 1, dt).name, dt)], bytes=bytes_, ops=flops,
            peak=peak, **times[dt])
    tb, tf = times[torch.bfloat16], times[torch.float32]
    log(f"K3 bf16 (tensor cores): kernel {tb['ms']:.3f} ms, plain "
        f"{tb['plain_ms']:.3f} ms, cuDNN bf16 conv1d chain "
        f"{tb['library_ms']:.3f} ms; {flops / 1e9:.1f} GFLOP useful "
        f"({flops / tb['ms'] / 1e9:.1f} TFLOP/s), {issued / 1e9:.1f} GFLOP "
        f"issued ({issued / tb['ms'] / 1e9:.1f} TFLOP/s; issued bound "
        f"{1e3 * issued / BF16_FLOPS:.3f} ms)")
    log(f"K3 f32 (CUDA cores): kernel {tf['ms']:.3f} ms, plain "
        f"{tf['plain_ms']:.3f} ms, cuDNN f32 conv1d chain (TF32 off) "
        f"{tf['library_ms']:.3f} ms")


def profile_path(run, state, audio):
    """Device time by kernel over one second of audio through ``run``
    (torch.profiler), and the device's busy share of the wall clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in audio:
            state, _, _, _ = run(state, x)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    busy = sum(r[1] for r in rows)
    log(f"profile, one second of audio through run(): wall {wall_ms:.3f} ms "
        f"(profiler on), device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%)")
    for name, ms, n in rows[:12]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name[:90]}")


#: phase 2b (the float32 flagship through the fleet pipeline): timed
#: iterations, fewer than phase 2's to stay inside the script's limit
ITERS_F32 = 2


def phase_main_path(report, dtype=torch.bfloat16, iters=ITERS,
                    profile=True):
    """The fleet pipeline at full width with the flagship CCCNN in
    ``dtype``: phase 2 in bfloat16, phase 2b in float32 (the model's
    default), where K3 runs on the CUDA-core kernel and the DFT head in
    full f32."""
    import numpy as np

    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.models.jax_import import (
        cccnn_state_dict_from_flax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.windows import (
        gather_kernel_for,
        gather_routes,
    )
    from onset_fingerprinting_torch.pipeline import (
        fleet_detector_config,
        make_detect_fingerprint,
    )
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        WINDOW,
        chunk_capacities,
        correctness,
        flagship_flax_params,
        make_audio,
        n_injected,
    )

    def build(n_streams, t, device):
        model = CCCNN(input_size=WINDOW, dtype=dtype, **FLAGSHIP)
        model.load_state_dict(
            cccnn_state_dict_from_flax(flagship_flax_params(seed=0)))
        max_hits, cap = chunk_capacities(n_streams, t)
        run = make_detect_fingerprint(
            fleet_detector_config(n_streams), model, n_streams, t, cap,
            device=device)
        return run, max_hits, cap

    run, max_hits, cap = build(N_STREAMS, CHUNK, None)
    audio = [make_audio(CHUNK, N_STREAMS * 4, seed=10 + j)
             for j in range(CHUNKS)]
    n_exp = N_STREAMS * n_injected(CHUNK)
    log(f"main path ({dtype}): {N_STREAMS} streams x {CHUNKS} chunks of "
        f"{CHUNK} samples, G={cap}, {n_exp} injected hits per chunk")

    _cuda.reset_counts()
    state = run.warmup(run.init_state(), audio[0][: WARMUP_BLOCKS * 128])
    for j in range(CHUNKS):
        state, on, deltas = run.detect(state, audio[j])
        preds, n_hits, n_dropped = run.fingerprint(audio[j], on, deltas)
        tp, spur, matched = correctness(on, 128, N_STREAMS, max_hits, CHUNK)
        recall = matched / n_exp
        precision = tp / max(tp + spur, 1)
        log(f"chunk {j}: recall {recall} precision {precision} "
            f"n_hits {int(n_hits)} dropped {int(n_dropped)}")
        check(recall == 1.0 and precision == 1.0, "recall/precision gate")
        check(int(n_dropped) == 0, "dropped hits")
        check(int(n_hits) == n_exp, f"n_hits {int(n_hits)} != {n_exp}")
        check(tuple(preds.shape) == (cap, 2), f"preds shape {preds.shape}")
        check(bool(torch.isfinite(preds).all()), "non-finite predictions")
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    log(f"launches/plain calls on the main path (warmup + {CHUNKS} "
        f"chunks): {counts}")
    # K3 on the route of the model's dtype, one launch per chunk, never on
    # the other kernel
    k3, other = ((_cuda.CONV_STACK_MMA, _cuda.CONV_STACK)
                 if dtype == torch.bfloat16
                 else (_cuda.CONV_STACK, _cuda.CONV_STACK_MMA))
    check(k3.launches == CHUNKS, f"K3 {k3.name} launched {k3.launches} "
          f"times, want one per chunk ({CHUNKS})")
    check(other.launches == 0, f"K3 ran on {other.name} on the {dtype} path")
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran on the main path")
        report["_launches"][k.name] = (report["_launches"].get(k.name, 0)
                                       + k.launches)
    # K2: one launch per chunk, all on the routed kernel and instantiation
    gather = gather_kernel_for(4, WINDOW)
    check(gather.kernel.variants[gather.variant] == CHUNKS
          and gather.kernel.launches == CHUNKS,
          f"K2 ran {gather.kernel.variants} on {gather.kernel.name}, want "
          f"{CHUNKS} x {gather.variant}")
    for route in gather_routes(4, WINDOW).values():
        check(route == gather or route.kernel.launches == 0,
              f"the fleet path launched {route.kernel.name}")
    # the fleet detector runs the pipe only: warmup + one launch per chunk
    check(_cuda.DETECTOR_PIPE.launches == 1 + CHUNKS,
          f"{_cuda.DETECTOR_PIPE.launches} pipe launches, want {1 + CHUNKS}")
    check(_cuda.DETECTOR.launches == 0,
          "the one-thread-per-channel detector ran on the fleet path")

    # timed iterations: each is one second of audio (3 carried chunks),
    # chunk order rotated so every iteration sees other input
    stages = ("detect", "hit_list", "gather", "model")
    per = {s: [] for s in stages}
    totals = []
    for it in range(iters):
        ev = {s: [] for s in stages}
        for j in range(CHUNKS):
            x = audio[(it + j) % CHUNKS]
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            marks[0].record()
            state, on, deltas = run.detect(state, x)
            marks[1].record()
            starts, sids, valid, _ = run.hit_list(on, deltas)
            marks[2].record()
            win = run.windows(x, starts, sids)
            marks[3].record()
            preds = run.predict(win, valid)
            marks[4].record()
            for si, s in enumerate(stages):
                ev[s].append((marks[si], marks[si + 1]))
        torch.cuda.synchronize()
        for s in stages:
            per[s].append(sum(a.elapsed_time(b) for a, b in ev[s]))
        t0 = time.perf_counter()
        for j in range(CHUNKS):
            state, preds, n_hits, n_dropped = run(
                state, audio[(it + j + 1) % CHUNKS])
        torch.cuda.synchronize()
        totals.append(1e3 * (time.perf_counter() - t0))
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS),
          "a plain version ran during the timed iterations")
    med = {s: float(np.median(per[s])) for s in stages}
    dev_total = sum(med.values())
    host_total = float(np.median(totals))
    log("per second of audio (median of %d, CUDA events): %s; sum %.3f ms "
        "-> %.0fx realtime" % (
            iters, ", ".join(f"{s} {med[s]:.3f} ms" for s in stages),
            dev_total, N_STREAMS / (dev_total / 1e3)))
    log(f"run() wall clock per second of audio (median, one read per "
        f"chunk): {host_total:.3f} ms -> "
        f"{N_STREAMS / (host_total / 1e3):.0f}x realtime "
        f"(min {min(totals):.3f}, max {max(totals):.3f})")
    if profile:
        profile_path(run, state, audio)

    # the same path at 32 streams on the card and, plain, on the CPU; in
    # float32 also K3 on the path's windows
    small_s, small_t = 32, 20480
    xs = make_audio(small_t, small_s * 4, seed=20, device="cpu")
    outs = []
    for device in ("cuda", "cpu"):
        r, _, _ = build(small_s, small_t, device)
        st = r.warmup(r.init_state(), xs[: WARMUP_BLOCKS * 128].to(device))
        xd = xs.to(device)
        st, on, deltas = r.detect(st, xd)
        preds, n_hits, _ = r.fingerprint(xd, on, deltas)
        feats = None
        if dtype == torch.float32:
            starts, sids, _, _ = r.hit_list(on, deltas)
            with torch.inference_mode():
                feats = r.model.fused_features(
                    r.windows(xd, starts, sids)).cpu()
        outs.append((on.cpu(), deltas.cpu(), preds.cpu(), int(n_hits),
                     feats))
    (on_g, d_g, p_g, n_g, f_g), (on_c, d_c, p_c, n_c, f_c) = outs
    check(torch.equal(on_g, on_c) and torch.equal(d_g, d_c),
          "card and CPU events differ at 32 streams")
    perr = max_err(p_g, p_c)
    if dtype == torch.bfloat16:
        check(n_g == n_c and perr <= 2e-2,
              f"card vs CPU predictions differ by {perr}")
        log(f"32-stream path, card vs plain CPU: events exact, {n_g} hits, "
            f"predictions max err {perr:.3g} (bound 2e-2)")
        return
    # float32: K3 within the JAX suite's f32 bar, the predictions within
    # 1e-4 + 1e-4 |CPU| (tests/test_torch_port_cccnn.py)
    ferr = max_err(f_g, f_c)
    fbad = int(((f_g - f_c).abs() > 5e-4 + 1e-4 * f_c.abs()).sum())
    pbad = int(((p_g - p_c).abs() > 1e-4 + 1e-4 * p_c.abs()).sum())
    check(n_g == n_c and fbad == 0 and pbad == 0
          and bool(torch.isfinite(p_g).all()),
          f"f32 card vs CPU at 32 streams: {fbad} K3 values outside atol "
          f"5e-4 rtol 1e-4 (max err {ferr}), {pbad} predictions outside "
          f"1e-4 + 1e-4 |CPU| (max err {perr})")
    log(f"32-stream path in float32, card vs plain CPU: events exact, {n_g} "
        f"hits, K3 features max err {ferr:.3g} (atol 5e-4, rtol 1e-4), "
        f"predictions max err {perr:.3g} (scale "
        f"{float(p_c.abs().max()):.3g}; bound 1e-4 + 1e-4 |CPU|)")


def phase_anatomy(report):
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.models.jax_import import (
        cccnn_state_dict_from_flax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.windows import (
        compact_hit_list,
        gather_hit_windows,
        gather_kernel_for,
        gather_routes,
        roll_kernel_for,
        roll_routes,
        top_hit_blocks,
    )
    from onset_fingerprinting_torch.tools import fingerprint_anatomy as fa
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        PRE,
        WINDOW,
        cccnn_flax_params,
    )

    g = G
    _cuda.reset_counts()
    outputs = {}
    rows = fa.main(n_streams=N_STREAMS, chunk=CHUNK, capacity=g,
                   iters=ITERS, outputs=outputs)
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    log(f"launches/plain calls on the anatomy path ({ITERS} + 1 "
        f"iterations): {counts}")
    check(_cuda.CONV_STACK_MMA.launches > 0, "kernel conv_stack_mma never "
          "launched")
    check(_cuda.CONV_STACK.launches == 0,
          "the CUDA-core conv stack ran on the bf16 anatomy path")
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran on the anatomy path")
    # K2 and K4 (2 calls each per iteration) only on their routed kernels
    for routes, route, calls in (
            (gather_routes(4, WINDOW), gather_kernel_for(4, WINDOW), 2),
            (roll_routes(4, WINDOW), roll_kernel_for(4, WINDOW), 2)):
        want = calls * (ITERS + 1)
        check(route.kernel.variants[route.variant] == want,
              f"{route.kernel.name} ran {route.kernel.variants}, want {want}"
              f" x {route.variant}")
        for other in routes.values():
            check(other == route or other.kernel.launches == 0,
                  f"the anatomy launched {other.kernel.name}")
    for k in (_cuda.GATHER_ROLL, _cuda.GATHER_ROLL_VEC):
        report["_launches"][k.name] = k.launches
    for name in ("preds", "preds_pairs"):
        out = outputs[name]
        check(tuple(out.shape) == (g, 2), f"{name} shape {out.shape}")
        check(bool(torch.isfinite(out).all()), f"non-finite {name}")
    log(f"anatomy per chunk ({CHUNK} samples, {N_STREAMS} streams, G={g}, "
        f"W={WINDOW}; CUDA events, median of {ITERS}):")
    for name, ms in rows.items():
        log(f"  {name:24s} {ms:9.3f} ms")
    check_bf16_head(outputs["feats"], outputs["cc"])

    # the pair-head CCCNN at 32 streams: card vs its plain version on the
    # CPU, float32, on windows of the anatomy's own hit grid
    small_s, small_t, small_g = 32, 20480, 128
    gen = torch.Generator().manual_seed(21)
    xs = torch.randn((small_t, small_s * 4), generator=gen)
    st, v = top_hit_blocks(fa.hit_grid(small_t, small_s, 0, "cpu"), 128,
                           small_s, fa.MAX_HITS)
    starts, sids, _, _ = compact_hit_list(st, v, small_g)
    windows = gather_hit_windows(xs, starts, sids, 4, WINDOW, PRE, True)
    config = dict(FLAGSHIP, **fa.PAIR_HEAD)
    model = CCCNN(input_size=WINDOW, **config).eval()
    model.load_state_dict(cccnn_state_dict_from_flax(
        cccnn_flax_params(config, seed=7)))
    with torch.inference_mode():
        want = model(windows)
        got = model.cuda()(windows.cuda()).cpu()
    err = max_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-3,
          f"pair head card vs CPU differ by {err}")
    log(f"pair-head CCCNN, 32 streams ({small_g} windows), card vs plain "
        f"CPU in float32: max err {err:.3g} (bound 1e-3)")


#: rows of the path's features whose bf16 head the CPU emulates
HEAD_ROWS = 2048


def check_bf16_head(feats, cc):
    """The bf16 DFT head on the card (bf16 x bf16 -> f32 GEMMs) against its
    CPU emulation (operands rounded to bf16, f32 products) on the first
    rows of the path's own features: within 1e-3 of the output's scale (f32
    sums in another order can flip a bf16 rounding of one spectral term)."""
    from onset_fingerprinting_torch.ops.xcorr import batch_self_correlate_dft

    want = batch_self_correlate_dft(feats[:HEAD_ROWS].cpu(), sum_axis=2,
                                    precision="default")
    got = cc[:HEAD_ROWS].cpu()
    scale = float(want.abs().max())
    err = max_err(got, want)
    check(got.dtype == torch.float32 and err <= 1e-3 * scale,
          f"bf16 DFT head: card vs CPU emulation differ by {err} "
          f"(scale {scale})")
    log(f"bf16 DFT head (tensor-core bf16 GEMMs, f32 accumulation) on "
        f"{HEAD_ROWS} windows of the path's features: max err {err:.3g} vs "
        f"the CPU emulation, {err / scale:.2e} of the scale (bound 1e-3)")


#: phase 2c: the head kernel's shapes, the benchmark's cells' calls (name,
#: windows, channels, outputs); the kernels line's row is the first
HEAD_SHAPES = (("fleet4-bf16.hits10", 36480, 4, 2),
               ("drum3-bf16.streams1024", 32768, 3, 3),
               ("fleet4-bf16.hits1", 3712, 4, 2))


def phase_head(report):
    """2c: the CCCNN's bf16 DFT head kernel (``csrc/cccnn_head.cu``) at the
    benchmark cells' calls (flagship widths: V = 133, K = 5) against its
    plain version on the card (TF32 off) within 1e-3 of the output's scale,
    one launch a call and no plain call; timed (mean of 20 calls by CUDA
    events) beside its bound (the f32 features, fc and the outputs at the
    HBM rate; the forward and inverse products at the bf16 peak), the plain
    version and the chain it replaces (cuBLAS bf16 GEMMs, the ATen passes,
    the f32 dense layer) as the library; the row is hits10's."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.cccnn_head import (
        self_cc_head,
        self_cc_head_reference,
    )
    from onset_fingerprinting_torch.ops.xcorr import batch_self_correlate_dft

    v, k = 133, 5
    f = (2 * v - 1 + 15) // 16 * 8 + 1
    for name, b, c, o in HEAD_SHAPES:
        g = torch.Generator("cuda").manual_seed(b)
        feats = torch.randn((b * c, v, k), device="cuda", generator=g).to(
            torch.bfloat16).float().reshape(b, c, v, k).transpose(2, 3)
        torch.manual_seed(c)
        fc = torch.nn.Linear(c * (2 * v - 1) + c, o).cuda()

        def kernel():
            return self_cc_head(feats, fc.weight, fc.bias)

        def plain():
            return self_cc_head_reference(feats, fc.weight, fc.bias)

        def library():
            cc = batch_self_correlate_dft(feats, sum_axis=2,
                                          precision="default")
            lag0 = cc[..., v - 1: v] + 1e-6
            return fc(torch.cat([(cc / lag0).reshape(b, -1),
                                 torch.log(lag0).reshape(b, -1)], dim=-1))

        with torch.inference_mode():
            before = (_cuda.CCCNN_HEAD.launches, _cuda.CCCNN_HEAD.plain_calls)
            got = kernel()
            check((_cuda.CCCNN_HEAD.launches, _cuda.CCCNN_HEAD.plain_calls)
                  == (before[0] + 1, before[1]),
                  f"2c {name}: the head kernel did not launch once")
            want = plain()
            lib = library()
            scale = float(want.abs().max())
            err = max_err(got, want)
            check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
                  f"2c {name}: the head kernel differs from its plain "
                  f"version by {err} (scale {scale})")
            ms = time_ms(kernel, n=20)
            plain_ms = time_ms(plain, n=3)
            lib_ms = time_ms(library, n=10)
        work = dict(bytes=4 * (b * c * v * k + fc.weight.numel() + b * o),
                    ops=2 * 2 * v * f * b * c * k + 2 * f * (2 * v - 1) * b * c,
                    peak=BF16_FLOPS)
        bound = max(1e3 * work["bytes"] / HBM_BPS,
                    1e3 * work["ops"] / BF16_FLOPS)
        log(f"2c head kernel, {name} ({b} x {c}, {o} outputs): {ms:.4f} ms "
            f"(bound {bound:.4f} ms, {work['ops'] / 1e9:.1f} GFLOP, "
            f"{work['bytes'] / 1e6:.0f} MB), plain {plain_ms:.3f} ms, the "
            f"chain {lib_ms:.4f} ms; max err {err:.3g} vs plain "
            f"({err / scale:.2e} of the scale), chain vs plain "
            f"{max_err(lib, want):.3g}")
        if "cccnn_head" not in report:
            report["cccnn_head"] = dict(max_abs_err=err, ms=ms,
                                        plain_ms=plain_ms, library_ms=lib_ms,
                                        **work)
        del feats, got, want, lib
        torch.cuda.empty_cache()


def classify_call(report):
    """The realtime engine's whole classify call (ring gather, K3, the head,
    dense; 16 hits) per call in a graph of 16, twice, as phase 4 times it:
    the classifier's 512-sample windows keep the chain (no head kernel)."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.tools.step_bench import graph_ms

    audio, _, _ = sim.synth_stream(6.0, 0)
    eng = sim.build_engine(None)
    eng.attach_classifier(sim.classifier(0), window=sim.CLS_WINDOW,
                          pre=sim.CLS_PRE, capacity=sim.CLS_CAPACITY)
    events, _, _ = sim.run(eng, audio)
    check(len(events) >= sim.CLS_CAPACITY, f"{len(events)} events")
    ons = torch.tensor([o for o, _ in events[-sim.CLS_CAPACITY:]],
                       dtype=torch.int32, device="cuda")
    valid = torch.ones(sim.CLS_CAPACITY, dtype=torch.bool, device="cuda")
    before = _cuda.CCCNN_HEAD.launches
    turns = [graph_ms([lambda: eng._classify(eng.state.ring, ons, valid)]
                      * 16) for _ in range(2)]
    check(_cuda.CCCNN_HEAD.launches == before,
          "the classifier's head ran on the head kernel")
    report["_classify_call"] = turns
    log(f"the whole classify call (ring gather, K3, DFT head, dense; 16 "
        f"hits) per call in a graph of 16: "
        + ", ".join(f"{t:.5f}" for t in turns) + " ms")


#: phase 4: the realtime stream's length and the CPU reference's prefix
RT_SECONDS = 20.0
RT_CPU_SECONDS = 5.0
#: the prefix over which K1 is held to the plain detector on the card (the
#: plain detector takes ~50 ms per block there)
RT_K1_PLAIN_SECONDS = 0.5
#: graph replays and eager steps timed
RT_REPLAYS = 1000
RT_EAGER = 300


def realtime_cpu_reference(seconds, prefix, seed, out):
    """The plain engine on the CPU over the first ``prefix`` seconds of the
    ``seconds``-long stream (run in a child process beside the card
    phases): its event queue as numpy arrays, put on ``out``."""
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    torch.set_num_threads(1)  # thousands of tiny ops per block
    audio, _, _ = sim.synth_stream(seconds, seed)
    eng = sim.build_engine("cpu")
    sim.run(eng, audio[: int(prefix * sim.SR)], classify=False)
    st = eng.state
    out.put({k: getattr(st, k).numpy() for k in
             ("ev_count", "ev_points", "ev_onsets", "ev_emits")})


def start_cpu_reference():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=realtime_cpu_reference,
                    args=(RT_SECONDS, RT_CPU_SECONDS, 0, q), daemon=True)
    p.start()
    return p, q


def wait_cpu_reference(proc, q):
    import queue

    while True:
        try:
            ref = q.get(timeout=5)
            break
        except queue.Empty:
            check(proc.is_alive(), f"the CPU reference died ({proc.exitcode})")
    proc.join(timeout=60)
    check(proc.exitcode == 0, f"the CPU reference exited {proc.exitcode}")
    return ref


def phase_realtime(report, cpu_ref):
    """Slice B: the realtime engine on the card at the demo's configuration
    (tools/realtime_sim): a 20 s three-sensor stream, the step replayed
    from its CUDA graph through process_nosync, harvests every 64 blocks,
    every harvested hit classified by the bf16 flagship CCCNN from the
    device ring."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import kernel_for
    from onset_fingerprinting_torch.ops.fused_detector import (
        _launch,
        fused_warmup_minmax,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        LocateBlock,
        locate_block,
        locate_block_reference,
    )
    from onset_fingerprinting_torch.core.tree import leaves
    from onset_fingerprinting_torch.realtime.engine import (
        EngineState,
        _clone,
        make_classify_fn,
    )
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.tools.step_bench import (
        graph_nodes,
        k1_times,
        locate_calls,
        locate_times,
        per_launch_ms,
        step_graph,
    )

    audio, _, hits = sim.synth_stream(RT_SECONDS, 0)
    eng = sim.build_engine(None)
    check(eng._graph is not None, "the engine did not capture its step")
    types, names = graph_nodes(eng._graph.graph)
    log(f"the captured step: {sum(types.values())} graph nodes {types}: "
        f"{names}")
    check(types == {"kernel": 2}, "the captured step holds other nodes than "
          "its two kernels")
    model = sim.classifier(0)
    eng.attach_classifier(model, window=sim.CLS_WINDOW, pre=sim.CLS_PRE,
                          capacity=sim.CLS_CAPACITY)
    n_blocks = len(sim.blocks_of(audio))
    _cuda.reset_counts()
    events, preds, wall = sim.run(eng, audio)
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    log(f"realtime: {RT_SECONDS:g} s stream, {len(hits)} strikes, "
        f"{n_blocks} blocks after a {sim.WARMUP}-sample warmup; "
        f"launches/plain calls: {counts}")
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran on the realtime path")
    check(_cuda.DETECTOR_WARP.launches == n_blocks
          and _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"] == 1
          == _cuda.DETECTOR_PIPE_COUPLED.launches,
          f"coupled K1 launched {_cuda.DETECTOR_WARP.launches} times on the "
          f"warp kernel, {_cuda.DETECTOR_PIPE_COUPLED.launches} on the "
          f"coupled pipe: want {n_blocks} steps and the warmup")
    n_ring = _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants)
    check(_cuda.LOCATE_BLOCK.launches == n_blocks == n_ring,
          f"the locate kernel launched {_cuda.LOCATE_BLOCK.launches} times, "
          f"{n_ring} with the ring write: want {n_blocks} steps")
    k3 = kernel_for(sim.CLS_WINDOW, [m.weight for m in model.convs], 1,
                    torch.bfloat16, 3 * sim.CLS_CAPACITY)
    check(k3 is _cuda.CONV_STACK_MMA_CLUSTER, f"the classifier's K3 routes "
          f"to {k3.name}, not the cluster kernel")
    check(k3.launches > 0 and all(k.launches == 0 for k in _cuda.KERNELS
                                  if k not in (_cuda.DETECTOR_WARP,
                                               _cuda.DETECTOR_PIPE_COUPLED,
                                               _cuda.LOCATE_BLOCK, k3)),
          f"the classifier's K3 ({k3.name}) did not launch, or another "
          "kernel did")
    log(f"classifier: K3 route for B = {3 * sim.CLS_CAPACITY} signals of "
        f"L = {sim.CLS_WINDOW}: {k3.name} ({k3.launches} launches)")
    for name in ("detector_warp", "locate_block", "detector_pipe_coupled"):
        report["_launches"][name] = (report["_launches"].get(name, 0)
                                     + counts[name][0])
    add_launches(report, ("ring_write",), {"ring_write": n_ring})
    report["_launches"]["classifier"] = counts[k3.name][0]
    matched, med, ok = sim.locate_gates(hits, events)
    log(f"locate gates: {len(events)} hits located, {matched}/{len(hits)} "
        f"strikes matched ({matched / len(hits):.3f}, gate "
        f"{sim.LOCATE_BARS['cuda'][0]}), median error {med:.4f} cm (gate "
        f"{sim.LOCATE_BARS['cuda'][1]}); {n_blocks} blocks in {wall:.3f} s "
        "host wall "
        f"({1e3 * wall / n_blocks:.4f} ms per block incl. harvests and "
        "classification)")
    check(ok, "realtime locate gates failed")
    check(eng.harvest_drops == 0, "harvest overflowed")
    check(preds is not None and preds.shape == (len(events), sim.N_ZONES)
          and bool(np.isfinite(preds).all()),
          f"classifier predictions {None if preds is None else preds.shape}")
    check(eng.classify_stale == 0, "stale classifications")

    # the device ring the steps wrote: the stream's last `cap` samples at
    # their slots (frame s at s mod cap), and the counter at every sample
    ring = eng.state.ring
    cap, n_fed = ring.capacity, 128 * n_blocks
    lo = max(0, n_fed - cap)
    want = np.zeros((cap, 3), np.float32)
    want[np.arange(lo, n_fed) % cap] = audio[lo:n_fed]
    check(int(ring.counter) == n_fed and np.array_equal(
        ring.data.cpu().numpy(), want),
          "the device ring differs from the stream's last samples")
    log(f"device ring after the run: counter {int(ring.counter)} = "
        f"{n_blocks} x 128, its {cap} frames bit-identical to the stream's "
        f"last {n_fed - lo} samples")

    # the classifier on the card against its plain version on the CPU, on
    # the same ring windows: the last 48 hits, B = 48 signals per call
    last = events[-sim.CLS_CAPACITY * 3:]
    got = eng.classify_hits(last)
    cpu_ring = type(eng.state.ring)(*(v.cpu() for v in eng.state.ring))
    cpu_fn = make_classify_fn(sim.classifier(0), window=sim.CLS_WINDOW,
                              pre=sim.CLS_PRE, capacity=sim.CLS_CAPACITY,
                              device="cpu")
    want = []
    for b in range(0, len(last), sim.CLS_CAPACITY):
        chunk = last[b: b + sim.CLS_CAPACITY]
        ons = torch.tensor([o for o, _ in chunk], dtype=torch.int32)
        p, fresh = cpu_fn(cpu_ring, ons, torch.ones(len(chunk),
                                                    dtype=torch.bool))
        check(bool(fresh.all()), "CPU classifier: stale windows")
        want.append(p.numpy())
    cerr = float(np.abs(got - np.concatenate(want)).max())
    check(cerr <= 2e-2, f"classifier card vs CPU differ by {cerr}")
    log(f"classifier (bf16 flagship CCCNN, 3 x {sim.CLS_WINDOW}): "
        f"{len(last)} hits, card vs plain CPU on the same ring windows "
        f"max err {cerr:.3g} (bound 2e-2)")

    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    # K1 as the engine runs it (detector_warp.cu, one launch per block)
    # against the plain detector over the first RT_CPU_SECONDS, events and
    # state, from the same warmed state (while the CPU reference runs on);
    # the locate kernel's inputs there
    l0, q0, quiet, fired, _ = locate_calls(audio, blocks, RT_CPU_SECONDS)
    _, _, _, _, (on_k, d_k, det_k, warm) = locate_calls(
        audio, blocks, RT_K1_PLAIN_SECONDS)
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, st0, _ = make_fused_detector(cfg, emit_rel=False)
    warm_p = warmup_minmax(fst.plain, params, st0, torch.as_tensor(
        audio[: sim.WARMUP // 128 * 128], device="cuda"))
    check(states_equal(warm, warm_p), "K1 warmup state differs at [128, 3]")
    t0 = time.perf_counter()
    det_p, (on_p, d_p, _) = detect_offline(
        fst.plain, params, warm_p,
        blocks[: on_k.shape[0]].reshape(-1, 3).contiguous())
    torch.cuda.synchronize()
    k1_plain = 1e3 * (time.perf_counter() - t0) / on_k.shape[0]
    check(torch.equal(on_k, on_p) and torch.equal(d_k, d_p),
          "K1 (detector_warp) events differ from plain on the stream")
    for field, u, v in zip(det_k._fields, det_k, det_p):
        check(torch.equal(u, v), f"K1 (detector_warp) state {field} differs "
              "from plain on the stream")
    log(f"K1 (detector_warp.cu) one launch per block over the first "
        f"{RT_K1_PLAIN_SECONDS:g} s ({on_k.shape[0]} blocks, "
        f"{int(on_k.sum())} "
        "onsets): warmup state, on, deltas and final state bit-identical to "
        "the plain detector")

    # the first RT_CPU_SECONDS against the plain engine on the CPU: the
    # card's events emitted in the blocks the CPU ran
    t_wait = time.perf_counter()
    ref = wait_cpu_reference(*cpu_ref)
    log(f"waited {time.perf_counter() - t_wait:.1f} s for the CPU reference")
    n_ref = int(ref["ev_count"])
    cpu_end = 128 * len(sim.blocks_of(audio[: int(RT_CPU_SECONDS * sim.SR)]))
    st = eng.state
    n_card = int(st.ev_count)
    emits = st.ev_emits.cpu().numpy()[:n_card]
    onsets = st.ev_onsets.cpu().numpy()[:n_ref]
    pts = st.ev_points.cpu().numpy()[:n_ref]
    check(n_ref > 0 and int((emits < cpu_end).sum()) == n_ref
          and np.array_equal(onsets, ref["ev_onsets"][:n_ref])
          and np.array_equal(emits[:n_ref], ref["ev_emits"][:n_ref]),
          "card and CPU engines' events differ")
    perr = float(np.abs(pts - ref["ev_points"][:n_ref]).max())
    check(perr <= 1e-3, f"card and CPU points differ by {perr} cm")
    log(f"first {RT_CPU_SECONDS:g} s: {n_ref} events, onsets and emit "
        f"stamps identical to the plain engine on the CPU, points max err "
        f"{perr:.3g} cm (bound 1e-3)")

    # the step's device time: graph replays on the stream's own blocks,
    # and one graph of 256 consecutive steps
    g = eng._graph

    def replay(i):
        g.block.copy_(blocks[i % len(blocks)])
        g.graph.replay()

    rep = per_launch_ms(replay, RT_REPLAYS)
    steps = step_graph(eng, blocks[sim.WARMUP // 128:])
    # the same step run eagerly, from the warmed initial state: equal to
    # the replays on the stream's first 2 s, then timed
    a, b = sim.build_engine(None), sim.build_engine(None)
    short = audio[: 2 * sim.SR]
    sim.run(a, short, classify=False)
    b.warmup(short[: sim.WARMUP])
    st = EngineState(*_clone(b.state))
    for blk in blocks[: len(sim.blocks_of(short))]:
        st, _ = b._step(st, blk, b.params)
    check(all(torch.equal(u, v) for u, v in zip(leaves(a.state),
                                                  leaves(st))),
          "graph replay and eager step differ")
    log(f"graph replay == eager step on 2 s: state identical, "
        f"{int(st.ev_count)} events")

    def eager_step(i):
        nonlocal st
        st, _ = b._step(st, blocks[i % len(blocks)], b.params)

    eag = per_launch_ms(eager_step, RT_EAGER, backlog_cycles=2e9,
                        chunk=RT_EAGER)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RT_EAGER):
        eager_step(i)
    torch.cuda.synchronize()
    eager_host = 1e3 * (time.perf_counter() - t0) / RT_EAGER
    budget = eng.budget_ms
    log(f"engine step, per block (budget {budget:.4f} ms): graph replay "
        f"{rep[0]:.4f} ms median, {rep[1]:.4f} ms p99 over {RT_REPLAYS} "
        f"replays (CUDA events); {steps['step_ms']:.5f} ms per step in one "
        f"graph of 256 steps; eager step {eag[0]:.4f} / {eag[1]:.4f} ms "
        f"on the card, {eager_host:.4f} ms host wall per step")
    check(rep[0] < budget, f"graph-replayed step {rep[0]} ms over budget")

    # the locate kernel in place against its plain version on the same
    # blocks: the fired ones in stream order, then the quiet ones (which
    # must leave the locator and the queue as they are)
    lb = LocateBlock(eng.locator, 3, 128, device="cuda")
    lk, qk = type(l0)(*_clone(l0)), type(q0)(*_clone(q0))
    lp, qp = l0, q0
    lerr, n_hit = 0.0, 0
    for i, (on, d, count) in enumerate(fired + quiet):
        ck = count.clone()
        was = [v.clone() for v in (*lk, *qk)]
        _, _, hk, _ = locate_block(lb, lk, qk, on, d, ck, out=(lk, qk, ck))
        lp, qp, hp, cp = locate_block_reference(lb, lp, qp, on, d, count)
        check(all(torch.equal(u, v) for u, v in zip(lk, lp))
              and torch.equal(hk.emits, hp.emits) and torch.equal(ck, cp)
              and all(torch.equal(u, v) for u, v in zip(qk[1:], qp[1:])),
              f"locate kernel differs from plain at block {i}")
        if i >= len(fired):
            check(all(torch.equal(u, v) for u, v in zip(was, (*lk, *qk))),
                  f"the locate kernel changed the state on quiet block {i}")
        lerr = max(lerr, max_err(hk.points, hp.points),
                   max_err(qk.points, qp.points))
        n_hit += int(hk.emits.sum())
    check(n_hit >= 2 and lerr <= 1e-3,
          f"locate kernel: {n_hit} hits, points max err {lerr}")
    log(f"locate kernel (locate_block.cu) in place at the engine's shape: "
        f"{n_hit} hits in the {len(fired)} fired blocks of the first "
        f"{RT_CPU_SECONDS:g} s, then {len(quiet)} quiet blocks: state, queue "
        f"and counter identical to plain, points max err {lerr:.3g}")

    # times: K1 per launch in a graph of launches, detector_warp.cu and the
    # coupled pipe in turns, beside detector.cu and an empty kernel; the
    # locate kernel on quiet and on fired blocks
    xb = blocks[len(blocks) // 2].contiguous()
    k1a, k1b = k1_times(xb), k1_times(xb, reverse=True)
    k1 = {k: (k1a[k] + k1b[k]) / 2 for k in k1a}
    # the engine's warmup launch ([48000, 3]): the coupled pipe (its route)
    # and detector_warp.cu in turns, old, new, new, old
    xw = torch.as_tensor(audio[: sim.WARMUP // 128 * 128], device="cuda")
    warm_t = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        warm_t[which].append(time_ms(
            (lambda: fused_warmup_minmax(fst, params, st0, xw)) if which ==
            "new" else (lambda: _launch(fst, params, st0, xw, False, True,
                                        _cuda.DETECTOR_WARP)), n=5))
    log(f"the engine's warmup [{xw.shape[0]}, 3], one launch, in turns: "
        f"the coupled pipe {warm_t['new']} ms, detector_warp.cu "
        f"{warm_t['old']} ms; chain bound {chain_bound_ms(xw.shape[0]):.4f}"
        " ms")
    loc = locate_times(lb, l0, q0, quiet, fired)
    on, d, count = fired[-1]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        locate_block_reference(lb, lp, qp, on, d, count)
    torch.cuda.current_stream().wait_stream(side)
    plain_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain_graph):
        locate_block_reference(lb, lp, qp, on, d, count)
    lplain = per_launch_ms(lambda i: plain_graph.replay(), 100)
    log(f"K1 at [128, 3] per launch in a graph of 128 launches (the mean of "
        f"two passes, the second in reverse): detector_warp.cu "
        f"{k1['detector_warp']:.5f} ms ({k1a['detector_warp']:.5f}, "
        f"{k1b['detector_warp']:.5f}), the coupled pipe "
        f"{k1['detector_pipe_coupled']:.5f} ms "
        f"({k1a['detector_pipe_coupled']:.5f}, "
        f"{k1b['detector_pipe_coupled']:.5f}), detector.cu "
        f"{k1['detector']:.5f} ms, an empty kernel {k1['empty']:.5f} ms; "
        f"plain {k1_plain:.3f} ms per block (one call over the blocks); "
        f"chain bound {chain_bound_ms(128):.5f} ms")
    log(f"locate kernel per launch in a graph of launches: quiet blocks "
        f"{loc['quiet']:.5f} ms ({loc['quiet_blocks']}), fired blocks "
        f"{loc['fired']:.5f} ms ({loc['fired_blocks']}, in stream order); "
        f"the plain version replayed from a CUDA graph {lplain[0]:.4f} ms")
    xb = blocks[0]
    report["_realtime_k1_pipe_ms"] = k1["detector_pipe_coupled"]
    report["detector_warp"] = dict(max_abs_err=0.0, ms=k1["detector_warp"],
                                   plain_ms=k1_plain, library_ms=None,
                                   **detector_work(xb.shape))
    report["detector_coupled"] = dict(max_abs_err=0.0, ms=k1["detector"],
                                      plain_ms=k1_plain, library_ms=None,
                                      **detector_work(xb.shape))
    state_bytes = sum(v.numel() * v.element_size()
                      for v in (*lk, *qk)) + 3 * (1 + 4 + 4 + 8 + 1)
    report["locate_block"] = dict(max_abs_err=lerr, ms=loc["fired"],
                                  plain_ms=lplain[0], library_ms=None,
                                  bytes=2 * state_bytes, ops=0,
                                  peak=F32_FLOPS)
    report["_realtime"] = dict(step_nodes=types, replay_ms=rep,
                               step_ms=steps["step_ms"], k1=k1, locate=loc)
    ring_check(report, eng.state.ring, blocks, lb, l0, q0, quiet, loc)
    classifier_k3(report, model, eng, last)


def ring_check(report, engine_ring, blocks, lb, l0, q0, quiet, loc):
    """The ring write inside the locate launch (``locate_block(block=)``,
    ``csrc/locate_block.cu``) against its plain version
    (``core/ring_buffer.ring_write``, then ``locate_block_reference``) on
    copies of the engine's ring, the head 50 frames before the ring's end
    (the blocks wrap) and 100 frames before the int32 counter's largest
    value: ring data, ring counter, locator state, queue and sample
    counter bit for bit after each of 8 quiet blocks.  The write's time
    is ``loc``'s (``tools/step_bench.locate_times``: the quiet launches
    with the write less those without, in turns); the plain ring write is
    timed per call in a graph of calls."""
    from onset_fingerprinting_torch.core.ring_buffer import (
        RingBuffer,
        ring_write,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import (
        locate_block,
        locate_block_reference,
    )
    from onset_fingerprinting_torch.realtime.engine import _clone
    from onset_fingerprinting_torch.tools.step_bench import graph_ms

    cap = engine_ring.capacity
    before = _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants)
    for head in (cap - 50, 2 ** 31 - 100):
        rk = RingBuffer(engine_ring.data.clone(), engine_ring.counter.clone())
        rk.counter.fill_(head)
        rp = RingBuffer(rk.data.clone(), rk.counter.clone())
        lk, qk = type(l0)(*_clone(l0)), type(q0)(*_clone(q0))
        lp, qp = l0, q0
        for i in range(8):
            blk = blocks[1000 + i]
            on, d, count = quiet[i % len(quiet)]
            ck = count.clone()
            locate_block(lb, lk, qk, on, d, ck, rk, out=(lk, qk, ck),
                         block=blk)
            rp = ring_write(rp, blk)
            lp, qp, _, cp = locate_block_reference(lb, lp, qp, on, d, count)
            check(torch.equal(rk.data, rp.data)
                  and torch.equal(rk.counter, rp.counter)
                  and all(torch.equal(u, v) for u, v in zip(
                      (*lk, *qk, ck), (*lp, *qp, cp))),
                  f"the fused ring write differs from plain at block {i}, "
                  f"head {head}")
    check(_cuda.ring_writes(_cuda.LOCATE_BLOCK.variants) == before + 16,
          "the ring check's launches did not take the ring write")
    xb = blocks[1000]
    rp = RingBuffer(engine_ring.data.clone(), engine_ring.counter.clone())
    plain_ms = graph_ms([lambda: ring_write(rp, xb)] * 16)
    b_n, c = xb.shape
    report["ring_write"] = dict(max_abs_err=0.0, ms=loc["write"],
                                plain_ms=plain_ms, library_ms=None,
                                bytes=2 * b_n * c * 4 + 8, ops=0,
                                peak=F32_FLOPS)
    log(f"ring write inside the locate launch at [{b_n}, {c}] into [{cap}, "
        f"{c}], the head wrapping past the ring's end and past the int32 "
        f"counter's largest value: ring, counter, state and queue "
        f"bit-identical to plain over 8 quiet blocks each; per quiet launch "
        f"in a graph of launches, in turns: with the write "
        f"{loc['quiet_write']:.6f} ms, without {loc['quiet']:.6f} ms "
        f"(and again in turn), the write {loc['write']:.6f} ms; plain ring "
        f"write (6 kernels) {plain_ms:.5f} ms per call in a graph of calls")


def classifier_k3(report, model, eng, events):
    """K3 bf16 at the realtime classifier's shape: B = 48 signals (3
    channels x 16 hits) of L = 512 through the classifier's own stack (as
    ``CCCNN.fused_features`` calls it), on the kernel the route takes (the
    cluster kernel, ``csrc/conv_stack_mma_cluster.cu``): bit for bit against
    ``csrc/conv_stack_mma.cu`` (the fleet's kernel, named) on two seeds, against
    its plain version (3e-2 / 2e-2 and the witness gate), per call in a
    graph of 16 calls in turns with that kernel (new, old, old, new),
    beside cuDNN's bf16 chain; and the engine's whole classify call (ring
    gather, K3, DFT head, dense) on ``events``' onsets, per call in a graph
    of 16 with either kernel, in turns."""
    import torch.nn.functional as F

    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops import conv_stack as k3mod
    from onset_fingerprinting_torch.ops.conv_stack import (
        _ACTIVATIONS,
        _launch_mma,
        conv_stack,
        conv_stack_reference,
        kernel_for,
    )
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.tools.step_bench import graph_ms

    ws = [m.weight for m in model.convs]
    bs = [m.bias for m in model.convs]
    pad, act, dt = model.padding, model.activation, model.dtype
    b_n = 3 * sim.CLS_CAPACITY
    check(kernel_for(sim.CLS_WINDOW, ws, pad, dt, b_n)
          is _cuda.CONV_STACK_MMA_CLUSTER,
          "K3 at the classifier's shape does not route to the cluster kernel")
    errs, old_errs, far = [], [], ""
    for seed in (48, 49):
        x = torch.randn((b_n, sim.CLS_WINDOW), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
        with torch.inference_mode():
            k = conv_stack(x, ws, bs, padding=pad, activation=act,
                           compute_dtype=dt)
            old = torch.full_like(k, float("nan"))
            _launch_mma(_cuda.CONV_STACK_MMA, x, ws, bs, pad, act, old)
            t0 = time.perf_counter()
            p = conv_stack_reference(x, ws, bs, pad, act, dt)
            torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        check(torch.equal(k, old), f"the cluster kernel differs from "
              f"conv_stack_mma.cu at the classifier's shape (seed {seed}): "
              f"max err {max_err(k, old)}")
        errs.append(max_err(k, p))
        old_errs.append(max_err(old, p))
        bad = int(((k.float() - p.float()).abs()
                   > 3e-2 + 2e-2 * p.float().abs()).sum())
        check(bad == 0, f"K3 at the classifier's shape (seed {seed}): {bad} "
              f"values outside atol 3e-2 rtol 2e-2 (max err {errs[-1]})")
        far += gate_far(k, p, x, [w.detach() for w in ws],
                        [b.detach() for b in bs], f"classifier_{seed}", pad,
                        act)
    wl = [w.detach().to(dt) for w in ws]
    bl = [b.detach().to(dt) for b in bs]
    xl = x.to(dt)[:, None, :]
    fn = _ACTIVATIONS[act]

    def library():
        y = xl
        for w, b in zip(wl, bl):
            y = fn(F.conv1d(y, w, b, padding=pad))
        return y

    out_old = torch.empty_like(k)
    calls = {
        "cluster": lambda: conv_stack(x, ws, bs, padding=pad, activation=act,
                                      compute_dtype=dt),
        "pr3": lambda: _launch_mma(_cuda.CONV_STACK_MMA, x, ws, bs, pad, act,
                                   out_old),
    }
    turns = []
    with torch.inference_mode():
        for tag in ("cluster", "pr3", "pr3", "cluster"):
            turns.append((tag, graph_ms([calls[tag]] * 16)))
        lib_ms = graph_ms([library] * 16)
    ms = {tag: float(np.mean([t for g, t in turns if g == tag]))
          for tag in calls}
    # the whole classify call on the engine's ring, with either kernel
    fn_cls = eng._classify
    ons = torch.tensor([o for o, _ in events[-sim.CLS_CAPACITY:]],
                       dtype=torch.int32, device="cuda")
    valid = torch.ones(sim.CLS_CAPACITY, dtype=torch.bool, device="cuda")
    routes = {"cluster": k3mod.CLUSTER_MAX_CTAS, "pr3": 0}
    cls_turns = []
    try:
        for tag in ("cluster", "pr3", "pr3", "cluster"):
            k3mod.CLUSTER_MAX_CTAS = routes[tag]
            cls_turns.append((tag, graph_ms(
                [lambda: fn_cls(eng.state.ring, ons, valid)] * 16)))
    finally:
        k3mod.CLUSTER_MAX_CTAS = routes["cluster"]
    cls_ms = {tag: float(np.mean([t for g, t in cls_turns if g == tag]))
              for tag in routes}
    t = sim.CLS_WINDOW
    flops = 0
    for w in ws:
        o, i, kk = w.shape
        t = t + 2 * pad - kk + 1
        flops += 2 * o * i * kk * t * b_n
    work = dict(bytes=b_n * sim.CLS_WINDOW * 4 + b_n * t * ws[-1].shape[0] * 4,
                ops=flops, peak=BF16_FLOPS)
    report["conv_stack_mma_classifier"] = dict(
        max_abs_err=max(errs), ms=ms["cluster"], plain_ms=plain_ms,
        library_ms=lib_ms, **work)
    report["conv_stack_mma_classifier_pr3"] = dict(
        max_abs_err=max(old_errs), ms=ms["pr3"], plain_ms=plain_ms,
        library_ms=lib_ms, **work)
    report["_classify"] = dict(k3_turns=turns, classify_turns=cls_turns)
    log(f"K3 bf16 at the classifier's shape B = {b_n}, L = {sim.CLS_WINDOW}: "
        f"the cluster kernel bit-identical to conv_stack_mma.cu on two seeds; "
        f"per call in a graph of 16, in turns: "
        + ", ".join(f"{g} {v:.5f}" for g, v in turns)
        + f" ms; cuDNN bf16 chain {lib_ms:.5f} ms, plain {plain_ms:.3f} ms "
        f"(one call); max err {max(errs):.3g} vs plain{far}; "
        f"{flops / 1e6:.1f} MFLOP useful")
    log(f"the whole classify call (ring gather, K3, DFT head, dense; 16 "
        f"hits) per call in a graph of 16, in turns: "
        + ", ".join(f"{g} {v:.5f}" for g, v in cls_turns)
        + f" ms; K3's share: {ms['cluster'] / cls_ms['cluster']:.2f} "
        f"(cluster), {ms['pr3'] / cls_ms['pr3']:.2f} (conv_stack_mma.cu)")


#: phase 5: the capability fixture's size (JAX demo: 768 hits); its
#: training set is 576 hits x 4 extractions = 2304 windows of 4 channels,
#: so K3 runs at B = 9216 signals.  Epochs cut from the demo's 2000 by 10
#: for every model, to keep the phase near 150 s with the CCCNNs trained
#: from five seeds: their rate is 0 after 100 updates anyway
#: (tools/fingerprint_capability.py)
CAP_HITS = 768
CAP_EPOCHS = 200
TRAIN_SIGNALS = 9216
#: phase 5b: windows and full-batch steps of the card-against-CPU run
PARITY_WINDOWS = 256
PARITY_STEPS = 10


def phase_train_k3(report):
    """5a: K3 under autograd at the training shape, both routes: the
    Function's forward (the routed kernel, one launch, no plain call)
    against the plain chain at phase 1's tolerances; the grads of x,
    weights and biases for a fixed cotangent against autograd of the plain
    chain on the card (f32 within 1e-5 of each grad's scale, bf16 within
    atol 3e-2 / rtol 2e-2), with TF32 on in the process flags and off in
    the recompute; one recompute per backward."""
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
        kernel_for,
    )
    from onset_fingerprinting_torch.tools.conv_stack_gate import (
        flagship_stack,
    )

    x = torch.randn((TRAIN_SIGNALS, 256), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(91))
    for dt in (torch.float32, torch.bfloat16):
        ws, bs = flagship_stack(seed=0)
        leaves = [x.clone().requires_grad_(),
                  *(t.clone().requires_grad_() for t in (*ws, *bs))]
        xl, wl, bl = leaves[0], leaves[1:8], leaves[8:]
        kern = kernel_for(256, wl, 1, dt)
        before = (kern.launches, kern.plain_calls, kern.backward_recomputes)
        out = conv_stack(xl, wl, bl, 1, "silu", dt)
        ct = torch.randn(out.shape, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(92))
        torch.backends.cudnn.allow_tf32 = True
        try:
            got = torch.autograd.grad(out, leaves, ct)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize()
        after = (kern.launches, kern.plain_calls, kern.backward_recomputes)
        check(after == (before[0] + 1, before[1], before[2] + 1),
              f"K3 {dt} under autograd: (launches, plain calls, recomputes) "
              f"went {before} -> {after}, want one launch and one "
              "recompute")
        ref = conv_stack_reference(xl, wl, bl, 1, "silu", dt)
        want = torch.autograd.grad(ref, leaves, ct)
        atol, rtol = (5e-4, 1e-4) if dt == torch.float32 else (3e-2, 2e-2)
        out, ref = out.detach(), ref.detach()
        fwd_err = max_err(out, ref)
        check(int(((out - ref).abs() > atol + rtol * ref.abs()).sum()) == 0,
              f"K3 {dt} forward under autograd: max err {fwd_err}")
        worst = 0.0
        for name, g, w in zip(["x"] + [f"w{i}" for i in range(7)]
                              + [f"b{i}" for i in range(7)], got, want):
            scale = float(w.abs().max())
            err = max_err(g, w)
            worst = max(worst, err / scale)
            if dt == torch.float32:
                check(err <= 1e-5 * scale, f"K3 f32 grad {name}: max err "
                      f"{err} over scale {scale}")
            else:
                check(int(((g - w).abs() > 3e-2 + 2e-2 * w.abs()).sum())
                      == 0, f"K3 bf16 grad {name}: max err {err}")
        log(f"5a K3 {dt} ({kern.name}) B={TRAIN_SIGNALS}: forward max err "
            f"{fwd_err:.3g}, grads max err / scale {worst:.3g} against "
            f"autograd of the plain chain (TF32 on outside the recompute)")
        del out, ref, got, want, leaves


def phase_train_parity(fix):
    """5b: the float32 flagship from one init, PARITY_STEPS full-batch adam
    steps on PARITY_WINDOWS windows of the fixture, on the card and on the
    CPU in this process: the losses within 1e-4 relative at every step."""
    from onset_fingerprinting_torch.core.config import TrainConfig
    from onset_fingerprinting_torch.models.train import (
        Trainer,
        make_optimizer,
    )
    from onset_fingerprinting_torch.tools.fingerprint_capability import (
        flagship_f32,
    )

    x = fix.x_train[:PARITY_WINDOWS].cpu()
    y = fix.y_train[:PARITY_WINDOWS].cpu()
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(flagship_f32(), TrainConfig(loss="l1", seed=0),
                     optimizer=make_optimizer("adam", 3e-3, "cosine", 100),
                     device=dev)
        st = tr.init_state()
        xd, yd = x.to(dev), y.to(dev)
        losses = [float(tr.step(st, xd, yd)) for _ in range(PARITY_STEPS)]
        runs[dev] = (losses, st.module.state_dict())
    lc, lh = (np.array(runs[d][0]) for d in ("cuda", "cpu"))
    rel = np.abs(lc - lh) / np.abs(lh)
    pdiff = max(max_err(runs["cuda"][1][k].cpu(), v)
                for k, v in runs["cpu"][1].items())
    log(f"5b flagship f32, {PARITY_STEPS} adam steps on {PARITY_WINDOWS} "
        f"windows: card losses {lc.tolist()}, CPU {lh.tolist()}, largest "
        f"relative difference {rel.max():.3g}; largest parameter "
        f"difference {pdiff:.3g}")
    check(bool((rel <= 1e-4).all()), f"5b: card and CPU losses part by "
          f"{rel.max()} relative")


def phase_capability(report):
    """5c: the capability tool's ``run()`` at the demo's size on the card:
    the bars; K3 f32 launched once per forward of the fleet flagship and
    the tensor-core K3 never; no plain version; each model's ms per
    training step and the flagship's step split."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
    )
    from onset_fingerprinting_torch.tools import (
        fingerprint_capability as cap,
    )

    _cuda.reset_counts()
    res = cap.run(hits=CAP_HITS, epochs=CAP_EPOCHS, log=log)
    counts = {k.name: (k.launches, k.plain_calls, k.backward_recomputes)
              for k in _cuda.KERNELS}
    log(f"5c launches/plain calls/recomputes: {counts}")
    fwd = res["forwards"]["flagship_f32"]
    steps = res["steps"]
    check(_cuda.CONV_STACK.launches == fwd, f"K3 f32 launched "
          f"{_cuda.CONV_STACK.launches} times, want one per forward of the "
          f"fleet flagship ({fwd})")
    check(_cuda.CONV_STACK.backward_recomputes == steps["flagship_f32"],
          f"{_cuda.CONV_STACK.backward_recomputes} K3 recomputes for "
          f"{steps['flagship_f32']} steps")
    check(_cuda.CONV_STACK_MMA.launches == 0,
          "the tensor-core K3 ran on the float32 training path")
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran on the training path")
        if k is not _cuda.CONV_STACK:
            check(k.launches == 0, f"{k.name} ran on the training path")
    report["_launches"]["conv_stack"] = (
        report["_launches"].get("conv_stack", 0) + _cuda.CONV_STACK.launches)
    for name in ("mean", *cap.MODELS):
        check(bool(np.isfinite(res[name])), f"5c {name}: {res[name]}")
    log(f"5c capability ({CAP_HITS} hits, {CAP_EPOCHS} epochs, CCCNN seeds "
        f"{cap.SEEDS}), test L1 (cm; CCCNNs: median, then per seed): "
        + "; ".join(f"{n} {res[n]:.4f}" + (" (" + ", ".join(
            f"{v:.4f}" for v in res["runs"][n]) + ")" if n in res["runs"]
            else "") for n in ("mean", *cap.MODELS)))
    fix = res["fixture"]
    x, y = fix.x_train, fix.y_train
    log(f"5c ms per training step (CUDA events, {len(x)} windows): fcnn "
        f"{1e3 * res['seconds']['fcnn'] / CAP_EPOCHS:.3f} (host clock over "
        f"its run, lags included)")
    for name, (tr, st) in res["trainers"].items():
        ms = time_ms(lambda tr=tr, st=st: tr.step(st, x, y), n=10)
        log(f"  {name}: {ms:.3f} ms per step; {steps[name]} steps over "
            f"the seeds, {res['seconds'][name]:.1f} s of training and "
            "evaluation")
    tr, st = res["trainers"]["flagship_f32"]
    m = st.module.train()
    xf = x.reshape(-1, x.shape[-1]).contiguous()
    ws = [c.weight for c in m.convs]
    bs = [c.bias for c in m.convs]
    with torch.no_grad():
        k3_ms = time_ms(lambda: conv_stack(xf, ws, bs, 1, "silu",
                                           torch.float32), n=20)
        fwd_ms = time_ms(lambda: m(x), n=10)

    def fwd_bwd():
        tr.loss_fn(m(x), y).backward()

    fb_ms = time_ms(fwd_bwd, n=10)
    rec_ms = time_ms(lambda: conv_stack_reference(xf, ws, bs, 1, "silu",
                                                  torch.float32), n=10)
    opt_ms = time_ms(st.optimizer.step, n=10)
    step_ms = time_ms(lambda: tr.step(st, x, y), n=10)
    flops, t = 0, xf.shape[1]
    for w in ws:
        o, i, kk = w.shape
        t = t + 2 - kk + 1
        flops += 2 * o * i * kk * t * xf.shape[0]
    log(f"5c flagship f32 step split at B = {len(xf)} signals: step "
        f"{step_ms:.3f} ms; K3 forward {k3_ms:.3f} ms (bound "
        f"{1e3 * flops / F32_FLOPS:.3f} ms, {flops / 1e9:.2f} GFLOP); head "
        f"and loss {fwd_ms - k3_ms:.3f} ms; backward with its recompute "
        f"{fb_ms - fwd_ms:.3f} ms (the recompute's forward alone "
        f"{rec_ms:.3f} ms); optimizer {opt_ms:.3f} ms")
    met = cap.bars(res)
    for what, ok in met:
        log(f"5c bar {'met' if ok else 'MISSED'}: {what}")
    check(all(ok for _, ok in met), "5c: a capability bar was missed")
    return fix


# -- phase 6: the player's setup loop ---------------------------------------

#: the JAX journey's fixture (tests/test_journey.py): 3 sensors at 96 kHz
J_SR = 96000
J_SENSORS = [(0.9, 0.0), (0.9, 120.0), (0.9, 240.0)]
#: the constant-arrival-order patch of the arrival journey
J_PATCH = dict(r_range=(0.35, 0.6), phi_range=(12.0, 48.0))
J_MARGS = {"output_size": 2, "hidden_layers": [10, 10, 10],
           "batch_norm": True}
#: phase 6's working directory, inside the checkout (git-ignored)
J_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_journey"
#: 6a: seconds of the realtime stream whose blocks the locate kernel takes
LOC_SECONDS = 2.0


def journey_session(name, n_hits, seed, patch=True):
    """A labeled session of the journey's fixture under ``J_DIR``:
    ``(wav path, onsets, locations cm)``."""
    from onset_fingerprinting_torch.data.synth import synth_location_session

    on, loc = synth_location_session(
        J_DIR / name, name, n_hits=n_hits, sr=J_SR, seed=seed,
        sensors=J_SENSORS, spacing=6000, **(J_PATCH if patch else {}))
    return J_DIR / name / f"{name}.wav", on, loc


def mine_cpu_reference(wav, out):
    """The plain detector on the CPU over the 6b recording (run in a child
    process beside the card phases): ``detect_onsets_amplitude``'s
    channels, onsets and rel, and its seconds."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_onsets_amplitude,
    )

    torch.set_num_threads(1)
    audio, sr = read_wav(wav)
    t0 = time.perf_counter()
    ch, on, rel = detect_onsets_amplitude(audio, sr=sr, device="cpu")
    out.put(dict(channels=np.asarray(ch), onsets=np.asarray(on), rel=rel,
                 seconds=time.perf_counter() - t0))


def start_mine_reference():
    """Write 6b's training recording and start its plain detection on the
    CPU in a child process."""
    import multiprocessing as mp
    import shutil

    shutil.rmtree(J_DIR, ignore_errors=True)
    wav, _, _ = journey_session("train_patch", 48, 3)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=mine_cpu_reference, args=(str(wav), q),
                    daemon=True)
    p.start()
    return p, q


def locate_fcnn(seed, device="cuda", hidden=(10, 10, 10)):
    """A locate-kernel test FCNN (``[10, 10, 10]`` unless ``hidden`` says
    otherwise) with BatchNorm: flax's init from ``seed``, its norms'
    statistics and affine moved off their init, the first Dense scaled by
    1/50 and the last by 1/20 (sample lags of tens to points of a few cm,
    as a trained locator's)."""
    from onset_fingerprinting_torch.models.fcnn import (
        FCNN,
        FCNNBundle,
        init_module,
    )

    net = init_module(FCNN(2, hidden_layers=hidden), seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bn in net.norms:
            w = bn.weight.shape
            bn.running_mean.copy_(0.3 * torch.randn(w, generator=g))
            bn.running_var.copy_(0.5 + torch.rand(w, generator=g))
            bn.weight.copy_(0.8 + 0.4 * torch.rand(w, generator=g))
            bn.bias.copy_(0.1 * torch.randn(w, generator=g))
        net.layers[0].weight /= 50
        net.out.weight /= 20
    return FCNNBundle(net.to(device))


def phase_locate_fcnn(report):
    """6a: the locate kernel with an FCNN, in place, against its plain
    version on the realtime stream's fired and quiet blocks, in both
    model_input modes, and with FCNNs of [32, 32], [128, 128] and 12
    layers of 16 (past the plan's old 64 units and 8 hidden layers); each
    timed per launch in a graph of launches beside the Newton kernel."""
    from onset_fingerprinting_torch.ops.locate_block import (
        LocateBlock,
        locate_block,
        locate_block_reference,
    )
    from onset_fingerprinting_torch.realtime.engine import _clone
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.tools.step_bench import (
        locate_calls,
        locate_times,
    )

    audio, _, _ = sim.synth_stream(LOC_SECONDS + 0.5, 1)
    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    l0, q0, quiet, fired, _ = locate_calls(audio, blocks, LOC_SECONDS)
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )

    _, polar, _, _ = sim._geometry()
    locator = Multilaterate3D(polar, drum_diameter=sim.DIAM,
                              medium="drumhead", sr=sim.SR,
                              feasibility_tols=sim.FEASIBILITY_TOLS)
    model = locate_fcnn(6)

    def held(lb, what):
        """The kernel with ``lb``'s FCNN, in place, against its plain
        version on the fired then the quiet blocks: (points max err, hits,
        the plain version's ms per call)."""
        lk, qk = type(l0)(*_clone(l0)), type(q0)(*_clone(q0))
        lp, qp = l0, q0
        lerr, n_hit = 0.0, 0
        for i, (on, d, count) in enumerate(fired + quiet):
            ck = count.clone()
            was = [v.clone() for v in (*lk, *qk)]
            _, _, hk, _ = locate_block(lb, lk, qk, on, d, ck,
                                       out=(lk, qk, ck))
            lp, qp, hp, cp = locate_block_reference(lb, lp, qp, on, d, count)
            check(all(torch.equal(u, v) for u, v in zip(lk, lp))
                  and torch.equal(hk.emits, hp.emits)
                  and torch.equal(hk.onsets, hp.onsets)
                  and torch.equal(ck, cp)
                  and all(torch.equal(u, v) for u, v in zip(qk[1:], qp[1:])),
                  f"locate kernel with an FCNN ({what}) differs from plain "
                  f"at block {i}")
            if i >= len(fired):
                check(all(torch.equal(u, v)
                          for u, v in zip(was, (*lk, *qk))),
                      f"the FCNN locate kernel ({what}) changed the state on "
                      f"quiet block {i}")
            lerr = max(lerr, max_err(hk.points, hp.points),
                       max_err(qk.points, qp.points))
            n_hit += int(hk.emits.sum())
        check(n_hit >= 2 and lerr <= 1e-3,
              f"FCNN locate kernel ({what}): {n_hit} hits, points max err "
              f"{lerr}")
        on, d, count = fired[-1]
        plain = time_ms(lambda: locate_block_reference(lb, lp, qp, on, d,
                                                       count), n=5)
        return lerr, n_hit, plain

    rows = {}
    for mode in ("arrival", "by_channel"):
        lb = LocateBlock(locator, 3, 128, model=model, model_input=mode,
                         device="cuda")
        lerr, n_hit, plain = held(lb, mode)
        t = locate_times(lb, l0, q0, quiet, fired)
        rows[mode] = dict(err=lerr, hits=n_hit, times=t, plain=plain)
        log(f"6a locate kernel with an FCNN [10, 10, 10] ({mode}), in place "
            f"at the engine's shape: {n_hit} hits in {len(fired)} fired "
            f"blocks of the first {LOC_SECONDS:g} s, then {len(quiet)} quiet "
            f"blocks: state, queue, counter and events identical to plain, "
            f"points max err {lerr:.3g} cm (bound 1e-3); per launch in a "
            f"graph of launches: fired {t['fired']:.5f} ms, quiet "
            f"{t['quiet']:.5f} ms; plain {plain:.3f} ms per call")
    # nets past the plan's old 64 units and 8 hidden layers (the widths on
    # the card, the vectors in dynamic shared memory), beside [32, 32]
    wide = {}
    for hidden in ((32, 32), (128, 128), (16,) * 12):
        lb = LocateBlock(locator, 3, 128, model=locate_fcnn(7, hidden=hidden),
                         device="cuda")
        plan, packed = lb.fcnn
        lerr, n_hit, plain = held(lb, f"hidden {list(hidden)}")
        t = locate_times(lb, l0, q0, quiet, fired)
        wide[hidden] = dict(err=lerr, hits=n_hit, times=t, plain=plain,
                            plan=plan, packed=packed.numel())
        log(f"6a locate kernel with an FCNN {list(hidden)} (arrival): {n_hit} "
            f"hits, events exact, points max err {lerr:.3g} cm; per launch in "
            f"a graph of launches: fired {t['fired']:.5f} ms, quiet "
            f"{t['quiet']:.5f} ms; plain {plain:.3f} ms per call; "
            f"{plan.smem} bytes of dynamic shared memory")
    newton = locate_times(LocateBlock(locator, 3, 128, device="cuda"), l0,
                          q0, quiet, fired)
    log(f"6a the Newton locate kernel on the same blocks: fired "
        f"{newton['fired']:.5f} ms, quiet {newton['quiet']:.5f} ms")
    r = rows["arrival"]
    lb = LocateBlock(locator, 3, 128, model=model, device="cuda")
    plan, packed = lb.fcnn
    state_bytes = sum(v.numel() * v.element_size()
                      for v in (*l0, *q0)) + 3 * (1 + 4 + 4 + 8 + 1)
    # the FCNN's operations on this run's completions, per fired launch
    flops = 2 * sum(a * b for a, b in zip(plan.widths[:-1], plan.widths[1:]))
    report["locate_block_fcnn"] = dict(
        max_abs_err=max(v["err"] for v in rows.values()),
        ms=r["times"]["fired"], plain_ms=r["plain"], library_ms=None,
        bytes=2 * state_bytes + packed.numel() * 4,
        ops=flops * r["hits"] / len(fired), peak=F32_FLOPS)
    w = wide[(128, 128)]
    flops_w = 2 * sum(a * b for a, b in zip(w["plan"].widths[:-1],
                                            w["plan"].widths[1:]))
    report["locate_block_fcnn_wide"] = dict(
        max_abs_err=w["err"], ms=w["times"]["fired"], plain_ms=w["plain"],
        library_ms=None, bytes=2 * state_bytes + w["packed"] * 4,
        ops=flops_w * w["hits"] / len(fired), peak=F32_FLOPS)
    report["_phase6"] = dict(locate=rows, newton=newton, fcnn_wide={
        str(list(h)): dict(fired=v["times"]["fired"],
                           quiet=v["times"]["quiet"], err=v["err"])
        for h, v in wide.items()})


def mined_lags(json_path, true_on, true_loc, order):
    """The journey's helper: mined hits matched to the truth by seed onset
    (within 400 samples) → (sample-lag rows, targets in m)."""
    hits = json.loads(Path(json_path).read_text())["hits"]
    lags, targets = [], []
    for h in hits:
        on = np.asarray(h["onset_start"], np.int64)
        check(on.shape == (3,) and (on >= 0).all(), "a mined hit lacks a "
              "channel")
        d = np.abs(true_on - on.min())
        j = int(np.argmin(d))
        if d[j] > 400:
            continue
        if order == "arrival":
            on = np.sort(on)
            lags.append([on[1] - on[0], on[2] - on[0]])
        else:
            lags.append(list(np.diff(on)))
        targets.append(true_loc[j] / 100.0)
    return np.asarray(lags, np.float32), np.asarray(targets, np.float32)


def serve_errors(found, true_on, true_loc, tol=3000):
    """Located hits ``[(sample, Location)]`` matched to the nearest true
    onset by time: ``(n matched, L1 errors cm)``."""
    errs = []
    for s, loc in found:
        j = int(np.argmin(np.abs(true_on - s)))
        if abs(int(true_on[j]) - s) < tol:
            errs.append(abs(loc.x - float(true_loc[j][0]))
                        + abs(loc.y - float(true_loc[j][1])))
    return len(errs), errs


def mine(wav, name, n_hits, true_on, true_loc, order):
    """mine_file on the card with K1 launched (warmup and detection, one
    launch each) and no plain call; the mined lags and targets."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools.mine_hits import mine_file

    _cuda.reset_counts()
    t0 = time.perf_counter()
    jp = mine_file(wav, J_DIR / name / "mined", min_channels=3, fix=True,
                   backend="scan")
    sec = time.perf_counter() - t0
    check(jp is not None, f"{name}: nothing mined")
    k1 = _cuda.DETECTOR_PIPE_COUPLED
    check(k1.launches == k1.variants["coupled"] == 2, f"{name}: the coupled "
          f"pipe launched {k1.launches} times, want the warmup and the "
          "recording")
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran in mining")
        if k is not k1:
            check(k.launches == 0, f"{k.name} ran in mining")
    lags, targets = mined_lags(jp, true_on, true_loc, order)
    log(f"{name}: mined {len(lags)}/{n_hits} hits in {sec:.2f} s "
        f"(mine_file: K1 on the card, grouping and fix_onsets on the host)")
    check(len(lags) >= 0.9 * n_hits, f"{name}: mined only {len(lags)}")
    return lags, targets


def train(name, lags, targets, epochs):
    from onset_fingerprinting_torch.locate.calibration import (
        train_location_model,
    )

    t0 = time.perf_counter()
    bundle, losses = train_location_model(
        lags, targets, lr=1e-2, num_epochs=epochs, patience=epochs,
        epochs_per_step=50)
    sec = time.perf_counter() - t0
    err = 100 * float(np.abs(bundle(lags).cpu().numpy() - targets)
                      .sum(axis=1).mean())
    log(f"{name}: trained the FCNN [10, 10, 10] on the card, {epochs} "
        f"epochs in {sec:.2f} s ({1e3 * sec / epochs:.3f} ms per epoch, host "
        f"clock); train L1 {err:.4f} cm")
    return bundle, err


def journey_gates(name, found, serve_on, serve_loc, targets, med_bar,
                  base_frac):
    n_matched, errs = serve_errors(found, serve_on, serve_loc)
    check(n_matched >= 0.8 * len(serve_on),
          f"{name}: served {n_matched}/{len(serve_on)}")
    med = float(np.median(errs))
    mean_pred = targets.mean(axis=0) * 100
    base = float(np.median([abs(mean_pred[0] - t[0]) + abs(mean_pred[1] - t[1])
                            for t in serve_loc]))
    log(f"{name}: served {n_matched}/{len(serve_on)} hits, median L1 "
        f"{med:.4f} cm (bar {med_bar}), predict-the-mean {base:.4f} cm "
        f"(bar {base_frac} x)")
    check(med < med_bar, f"{name}: median L1 {med} cm")
    check(med < base_frac * base, f"{name}: {med} cm against predict-the-"
          f"mean {base}")
    return n_matched, med, base


def phase_journey_patch(report, mine_ref):
    """6b: tests/test_journey.py's arrival journey on the card: mine (K1 held
    bit for bit to the plain detector on the CPU over the recording) →
    train → save_setup → build_engine → 8 fresh hits through ``process``;
    the captured step is three kernel nodes, the locate kernel takes the
    model on every step, no plain version; the events held to the plain
    engine on the CPU with the same weights."""
    from onset_fingerprinting_torch.core import posd
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_onsets_amplitude,
        offline_detector,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
    )
    from onset_fingerprinting_torch.realtime.main import build_engine
    from onset_fingerprinting_torch.realtime.setup_io import save_setup
    from onset_fingerprinting_torch.tools.step_bench import graph_nodes

    wav = J_DIR / "train_patch" / "train_patch.wav"
    _, true_on, true_loc = journey_session("train_patch", 48, 3)
    lags, targets = mine(wav, "6b", 48, true_on, true_loc, "arrival")
    add_launches(report, ("detector_pipe_coupled",),
                 {"detector_pipe_coupled": 2})

    # K1 over the whole recording against the plain detector on the CPU
    audio, sr = read_wav(wav)
    ch_k, on_k, rel_k = detect_onsets_amplitude(audio, sr=sr)
    t_wait = time.perf_counter()
    ref = wait_cpu_reference(*mine_ref)
    log(f"6b waited {time.perf_counter() - t_wait:.1f} s for the CPU "
        "detector")
    ev_ok = (np.array_equal(np.asarray(ch_k), ref["channels"])
             and np.array_equal(np.asarray(on_k), ref["onsets"]))
    rel_err = float(np.abs(rel_k - ref["rel"]).max())
    rel_ok = bool(np.allclose(rel_k, ref["rel"], rtol=1e-3, atol=2e-2))
    log(f"6b K1 over the recording against the plain detector on the CPU: "
        f"channels and onsets {'equal' if ev_ok else 'DIFFER'} "
        f"({len(on_k)} onsets on the card, {len(ref['onsets'])} on the "
        f"CPU); rel max |diff| {rel_err:.3g} (bound 2e-2 + 1e-3 |rel|: the "
        "CPU's log2/exp2 and the card's differ in the last bits)")
    check(ev_ok and rel_ok, "K1 over the recording differs from the plain "
          "detector on the CPU")
    # the kernel against the plain version on the same device, bit for bit,
    # in the mining configuration over the recording's first 0.2 s: the
    # warmup launch over 0.1 s (a strike in it), then one detection launch
    # over the next 0.1 s (a strike in it too)
    from onset_fingerprinting_torch.detect.amplitude import (
        detect_offline,
        warmup_minmax,
    )
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_warmup_minmax,
    )

    fst, params, st0 = offline_detector(3, sr=sr)
    warm = J_SR // 10 // 128 * 128
    xs = torch.as_tensor(audio[: 2 * warm], device="cuda").contiguous()
    wk = fused_warmup_minmax(fst, params, st0, xs[:warm])
    wp = warmup_minmax(fst.plain, params, st0, xs[:warm])
    sk, (ok_, dk, rk) = fused_detect_offline(fst, params, wk, xs[warm:])
    sp, (op_, dp, rp) = detect_offline(fst.plain, params, wp, xs[warm:])
    torch.cuda.synchronize()
    check(int(op_.sum()) > 0 and states_equal(wk, wp)
          and torch.equal(ok_, op_) and torch.equal(dk, dp)
          and torch.equal(rk, rp) and states_equal(sk, sp),
          "K1 in the mining configuration differs from the plain detector "
          "on the card")
    log(f"6b K1 against the plain detector on the card over the first "
        f"{2 * warm} samples (warmup {warm}, then {warm} in one launch, "
        f"{int(op_.sum())} onsets): warmup state, on, deltas, rel and state "
        "bit-identical")
    # mining's two K1 launches over the whole recording, the 0.5 s warmup
    # and the recording: the route (the coupled pipe) against
    # detector_warp.cu named, bit for bit, then both timed in turns
    from onset_fingerprinting_torch.ops.fused_detector import _launch

    t = len(audio) // 128 * 128
    w = J_SR // 2 // 128 * 128
    x = torch.as_tensor(audio[:t], device="cuda").contiguous()

    def new():
        st = fused_warmup_minmax(fst, params, st0, x[:w])
        return st, fused_detect_offline(fst, params, st, x)

    def old():
        st = _launch(fst, params, st0, x[:w], False, True,
                     _cuda.DETECTOR_WARP)[0]
        return st, _launch(fst, params, st, x, True, False,
                           _cuda.DETECTOR_WARP)

    (wn, (sn, outn)), (wo, (so, outo)) = new(), old()
    torch.cuda.synchronize()
    check(states_equal(wn, wo) and states_equal(sn, so)
          and all(torch.equal(u, v) for u, v in zip(outn, outo)),
          "6b: the coupled pipe differs from detector_warp.cu over the "
          "recording")
    log(f"6b the coupled pipe against detector_warp.cu over [{w}, 3] + "
        f"[{t}, 3] ({int(outn[0].sum())} onsets): warmup state, on, deltas, "
        "rel and state bit-identical")
    del wn, sn, outn, wo, so, outo
    ms_old = [time_ms(old, n=3)]
    ms_new = [time_ms(new, n=3), time_ms(new, n=3)]
    ms_old.append(time_ms(old, n=3))
    ms, old_ms = sum(ms_new) / 2, sum(ms_old) / 2
    work = detector_work((t + w, 3))
    work["bytes"] += t * 3 * 4  # mining's detection launch writes rel
    log(f"6b K1 as mining launches it, the warmup [{w}, 3] and the "
        f"recording [{t}, 3], one launch each, in turns old, new, new, old: "
        f"the coupled pipe {ms:.3f} ms ({ms_new[0]:.3f}, {ms_new[1]:.3f}), "
        f"detector_warp.cu {old_ms:.3f} ms ({ms_old[0]:.3f}, "
        f"{ms_old[1]:.3f}) for both (one CTA of 3 warps); the plain "
        f"detector {1e3 * ref['seconds']:.0f} ms for both on one CPU "
        f"thread; {bounds_line(work, t + w)}")
    report["detector_pipe_coupled"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=1e3 * ref["seconds"],
        library_ms=None, **work)
    report["detector_warp_mining"] = dict(
        max_abs_err=0.0, ms=old_ms, plain_ms=1e3 * ref["seconds"],
        library_ms=None, **work)

    bundle, err = train("6b", lags, targets, 1500)
    check(err < 1.5, f"6b train L1 {err} cm")
    setup = J_DIR / "setup_patch"
    save_setup([[r, phi, 0.0] for r, phi in J_SENSORS], "air", None, bundle,
               J_MARGS, setup)
    eng = build_engine(setup, sr=J_SR)
    check(eng._graph is not None, "6b: the engine did not capture its step")
    types, names = graph_nodes(eng._graph.graph)
    check(types == {"kernel": 2}, f"6b: the captured step holds {types}")
    serve_wav, serve_on, serve_loc = journey_session("serve_patch", 8, 11)
    audio, _, _ = posd.load_session(J_DIR / "serve_patch"
                                    / "serve_patch.json")
    blocks = [audio[i: i + 128] for i in range(0, len(audio) - 127, 128)]
    _cuda.reset_counts()
    found, card = [], []
    t0 = time.perf_counter()
    for i, blk in enumerate(blocks):
        _, locs = eng.process(blk)
        found.extend((128 * i, loc) for loc in locs)
        card.extend((i, loc.x, loc.y) for loc in locs)
    wall = time.perf_counter() - t0
    n = len(blocks)
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran in 6b's serving")
    check(_cuda.LOCATE_BLOCK.launches == n
          and _cuda.LOCATE_BLOCK.variants["ring+fcnn"] == n
          and _cuda.DETECTOR_WARP.launches == n,
          f"6b: {n} blocks, launches {counts}, locate variants "
          f"{dict(_cuda.LOCATE_BLOCK.variants)}")
    add_launches(report, ("detector_warp", "ring_write"), {
        "detector_warp": counts["detector_warp"][0],
        "ring_write": _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants)})
    report["_launches"]["locate_block_fcnn"] = (
        report["_launches"].get("locate_block_fcnn", 0) + n)
    log(f"6b serving: the captured step {types} ({', '.join(names)}), "
        f"{n} blocks through process() in {wall:.3f} s; the locate kernel "
        f"took the model on all {n} steps; no plain version")
    journey_gates("6b", found, serve_on, serve_loc, targets, 2.5, 1.0)

    # the plain engine on the CPU with the same weights, the same blocks
    cpu = build_engine(setup, sr=J_SR, device="cpu")
    t0 = time.perf_counter()
    plain = []
    for i, blk in enumerate(blocks):
        _, locs = cpu.process(blk)
        plain.extend((i, loc.x, loc.y) for loc in locs)
    check(len(plain) == len(card) and all(
        a[0] == b[0] for a, b in zip(card, plain)),
        f"6b: card events {[c[0] for c in card]} differ from the CPU's "
        f"{[c[0] for c in plain]}")
    perr = max((max(abs(a[1] - b[1]), abs(a[2] - b[2]))
                for a, b in zip(card, plain)), default=0.0)
    check(perr <= 1e-3, f"6b: card and CPU points differ by {perr} cm")
    log(f"6b the plain engine on the CPU ({time.perf_counter() - t0:.1f} s): "
        f"{len(plain)} events in the same blocks, points max err "
        f"{perr:.3g} cm (bound 1e-3)")


def phase_journey_head(report):
    """6c: the full-head journey (``model_input="by_channel"``): 96 hits,
    2500 epochs, served through ``run_wav`` (the native executor and the
    pipelined dispatcher)."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.realtime.main import build_engine, run_wav
    from onset_fingerprinting_torch.realtime.setup_io import save_setup

    wav, true_on, true_loc = journey_session("train_head", 96, 5, False)
    lags, targets = mine(wav, "6c", 96, true_on, true_loc, "by_channel")
    add_launches(report, ("detector_pipe_coupled",),
                 {"detector_pipe_coupled": 2})
    bundle, _ = train("6c", lags, targets, 2500)
    setup = J_DIR / "setup_head"
    save_setup([[r, phi, 0.0] for r, phi in J_SENSORS], "air", None, bundle,
               J_MARGS, setup, model_input="by_channel")
    eng = build_engine(setup, sr=J_SR)
    check(eng.locator.model_input == "by_channel", "6c: not by_channel")
    serve_wav, serve_on, serve_loc = journey_session("serve_head", 10, 17,
                                                     False)
    n = len(read_wav(serve_wav)[0]) // 128
    found = []
    _cuda.reset_counts()
    stats = run_wav(eng, serve_wav,
                    on_hit=lambda onset, loc: found.append((onset, loc)))
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    for k in _cuda.KERNELS:
        check(k.plain_calls == 0, f"plain {k.name} ran in 6c's serving")
    check(stats["blocks"] == n and stats["drops"] == 0
          and _cuda.LOCATE_BLOCK.variants["ring+fcnn"] == n
          and _cuda.DETECTOR_WARP.launches == n,
          f"6c: run_wav {stats}, {n} blocks, launches {counts}")
    add_launches(report, ("detector_warp", "ring_write"), {
        "detector_warp": counts["detector_warp"][0],
        "ring_write": _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants)})
    report["_launches"]["locate_block_fcnn"] += n
    log(f"6c run_wav: {stats['blocks']} blocks through the native executor "
        f"at audio rate, {stats['drops']} drops, {stats['misses']} deadline "
        f"misses of the executor's enqueue, its p50 "
        f"{stats['p50_us'] / 1e3:.4f} ms p99 {stats['p99_us'] / 1e3:.4f} ms; "
        f"{len(found)} hits harvested")
    journey_gates("6c", found, serve_on, serve_loc, targets, 4.0, 0.5)


def phase_calibration(report):
    """6d: stages 1-2 of ``tools.calibration_run`` (examples/
    calibration_demo.py) on the card and on the CPU in this process: the
    TDOA residual, the refined C, the card's positions against the CPU's,
    both timed."""
    from onset_fingerprinting_torch.tools import calibration_run as cal

    fix = cal.make_fixture()
    res = {dev: cal.stages_1_2(fix, dev) for dev in ("cuda", "cpu")}
    card, cpu = res["cuda"], res["cpu"]
    resid, c2 = card["resid"], card["c"]
    (t_cal, t_opt), (c_cal, c_opt) = card["seconds"], cpu["seconds"]
    e_cal = float(np.abs(card["est"] - cpu["est"]).max())
    e_opt = max(float(np.abs(card["sensors"] - cpu["sensors"]).max()),
                float(np.abs(card["sounds"] - cpu["sounds"]).max()))
    log(f"6d calibrate (TNC, float64 autograd on the card): TDOA residual "
        f"{resid:.4f} samples (bar 2), {t_cal:.3f} s (CPU {c_cal:.3f} "
        f"s); positions vs the CPU max |diff| {e_cal:.3g} m (bound 1e-4)")
    log(f"6d optimize_positions (800 adam epochs, float32 on the card): "
        f"refined C {c2:.4f} m/s (true {cal.C_SOUND}; CPU {cpu['c']:.4f}), "
        f"{t_opt:.3f} s (CPU {c_opt:.3f} s); positions vs the CPU "
        f"max |diff| {e_opt:.3g} m (bound 1e-4)")
    check(resid < 2.0, f"6d: TDOA residual {resid} samples")
    check(e_cal <= 1e-4 and e_opt <= 1e-4,
          f"6d: card and CPU positions differ by {e_cal} / {e_opt} m")
    check(abs(c2 - cpu["c"]) <= 1e-3, "6d: card and CPU C differ")
    report["_phase6"]["calibration"] = dict(
        resid=resid, c=c2, seconds=(t_cal, t_opt))


# -- phase 7: the classification pillar and the reference-model migration --

#: 7b: the zone demo's defaults (examples/zone_classifier_demo.py)
Z_HITS, Z_SEED, Z_EPOCHS = 150, 0, 700
#: 7b's gate on the held-out accuracy (chance 1/3; the JAX demo's runs land
#: 0.68-0.78 across seeds)
Z_BAR = 0.60
#: 7c: capability windows through the imported models (the CCCNN's K3 runs
#: MIG_WINDOWS x C signals)
MIG_WINDOWS = 1024
MIG_RNN_WINDOWS = 256


def amp_cpu_reference(wav, out):
    """7a's reference, in a child process beside the card phases: the
    amplitude route of ``detect_onsets`` on the CPU over channel 0 of 6b's
    recording (channels, onsets, seconds)."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.detect import detect_onsets

    torch.set_num_threads(1)
    audio, sr = read_wav(wav)
    t0 = time.perf_counter()
    ch, on, _ = detect_onsets(audio[:, :1], sr=sr, method="amp",
                              device="cpu")
    out.put(dict(channels=np.asarray(ch), onsets=np.asarray(on),
                 seconds=time.perf_counter() - t0))


def start_amp_reference():
    """Start 7a's CPU reference (6b's recording must exist)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=amp_cpu_reference,
                    args=(str(J_DIR / "train_patch" / "train_patch.wav"), q),
                    daemon=True)
    p.start()
    return p, q


def scale_err(card, cpu):
    """max |card - cpu| over max |cpu|."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-30))


def phase_detect7(report, amp_ref):
    """7a: the spectral route of ``detect_onsets`` on the card against the
    CPU over channel 0 of 6b's recording (the same peaks, the normalised
    flux within 1e-5 of its scale), then the amplitude route on the card
    (K1, two launches, no plain call) against the plain detector on the
    CPU (a child process from phase 0): the same channels and onsets."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.detect import detect_onsets
    from onset_fingerprinting_torch.detect.spectral import (
        spectral_flux_envelope,
    )
    from onset_fingerprinting_torch.ops import _cuda

    audio, sr = read_wav(J_DIR / "train_patch" / "train_patch.wav")
    x = np.ascontiguousarray(audio[:, 0])
    detect_onsets(x, sr=sr, method="spectral")  # cuFFT plans, warm
    t0 = time.perf_counter()
    peaks, oe = detect_onsets(x, sr=sr, method="spectral", return_oe=True)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_peaks, cpu_oe = detect_onsets(x, sr=sr, method="spectral",
                                      return_oe=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    err = scale_err(oe, cpu_oe)
    xt = torch.as_tensor(x).cuda()
    flux_ms = time_ms(lambda: spectral_flux_envelope(xt, sr=sr), n=10)
    log(f"7a spectral over {len(x)} samples: {len(peaks)} peaks on the "
        f"card, {len(cpu_peaks)} on the CPU "
        f"({'equal' if np.array_equal(peaks, cpu_peaks) else 'DIFFER'}); "
        f"flux max |diff| {err:.3g} of its scale; detect_onsets "
        f"{1e3 * t_card:.1f} ms on the card (STFT + flux {flux_ms:.3f} ms by "
        f"CUDA events; percentile and peak pick on the host), "
        f"{1e3 * t_cpu:.1f} ms on the CPU (host clock)")
    check(len(peaks) > 0 and np.array_equal(peaks, cpu_peaks),
          "7a: the spectral peaks on the card differ from the CPU's")
    check(err <= 1e-5, f"7a: the spectral flux is {err:.3g} of its scale "
          "from the CPU's")
    _cuda.reset_counts()
    t0 = time.perf_counter()
    ch, on, _ = detect_onsets(audio[:, :1], sr=sr, method="amp")
    torch.cuda.synchronize()
    t_amp = time.perf_counter() - t0
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS
              if k.launches or k.plain_calls}
    log(f"7a amplitude route: K1 launches/plain calls {counts}; "
        f"{len(on)} onsets in {1e3 * t_amp:.1f} ms (host clock, both "
        "launches)")
    k1 = (_cuda.DETECTOR, _cuda.DETECTOR_WARP, _cuda.DETECTOR_PIPE,
          _cuda.DETECTOR_PIPE_COUPLED)
    check(_cuda.DETECTOR_PIPE_COUPLED.variants["coupled"] == 2
          and sum(k.launches for k in k1) == 2 and all(
        k.plain_calls == 0 for k in _cuda.KERNELS),
        f"7a: the amplitude route did not run K1 twice alone ({counts})")
    for k in k1:
        report["_launches"][k.name] = (report["_launches"].get(k.name, 0)
                                       + k.launches)
    ref = wait_cpu_reference(*amp_ref)
    same = (np.array_equal(np.asarray(ch), ref["channels"])
            and np.array_equal(np.asarray(on), ref["onsets"]))
    log(f"7a K1 against the plain detector on the CPU ({ref['seconds']:.1f}"
        f" s there): channels and onsets {'equal' if same else 'DIFFER'} "
        f"({len(on)} on the card, {len(ref['onsets'])} on the CPU)")
    check(same and len(on) > 0, "7a: K1's onsets differ from the plain "
          "detector's")


def phase_zone(report):
    """7b: ``tools.zone_classifier.run`` at the demo's defaults on the card
    (POSD's device half, the modal transform, the CNN trained by the
    Trainer): held-out accuracy >= Z_BAR; no hand-written kernel on this
    loop and no plain call; both transforms on the card against the CPU
    on the same rows (within 1e-4 of their scale); the two augmentation
    recursions timed on one zone's rows."""
    from onset_fingerprinting_torch.data.augment import (
        air_absorption,
        seven_band_eq,
        some_of,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import zone_classifier as zc

    _cuda.reset_counts()
    res = zc.run(Z_HITS, Z_SEED, Z_EPOCHS, log=lambda *a: log("7b", *a))
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS),
          "7b: a plain version ran on the zone-classifier loop")
    zc.report(res, log=lambda *a: log("7b", *a))
    s = res["seconds"]
    log(f"7b seconds (host clock, synchronised): augmentation (POSD's "
        f"rows) {s['augment']:.3f}, modal transform {s['transform']:.3f}, "
        f"training {s['train']:.2f} ({1e3 * s['train'] / res['epochs']:.3f}"
        f" ms per epoch, {res['epochs']} epochs of {res['n_train_rows']} "
        "rows in batches of 32)")
    check(res["accuracy"] >= Z_BAR, f"7b: held-out accuracy "
          f"{res['accuracy']:.3f} < {Z_BAR}")
    ds = res["dataset"]
    rows = ds.audio
    m_card = zc.mfcc_transform(rows, ds)
    m_cpu = zc.mfcc_transform(rows.cpu(), ds)
    e_mfcc = scale_err(m_card.cpu(), m_cpu)
    e_modal = scale_err(res["x"].cpu(), zc.modal_transform(rows.cpu(), ds))
    log(f"7b transforms, card against CPU on the same {len(rows)} rows: "
        f"MFCC {tuple(m_card.shape)} {e_mfcc:.3g} of its scale, modal "
        f"{tuple(res['x'].shape)} {e_modal:.3g}")
    check(e_mfcc <= 1e-4 and e_modal <= 1e-4,
          "7b: a transform on the card differs from the CPU's")
    base = rows[:Z_HITS]
    g = torch.Generator(base.device).manual_seed(0)
    times = {}
    for name, aug in (("seven_band_eq", seven_band_eq),
                      ("air_absorption", air_absorption)):
        d = aug.draws(g, base)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug.apply(base, d, zc.SR)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    some_of(g, base, zc.SR)
    torch.cuda.synchronize()
    times["some_of"] = time.perf_counter() - t0
    log(f"7b augmentation on one zone's {tuple(base.shape)} rows (host "
        "clock): " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
        + f"; POSD runs some_of {3 * zc.ROUNDS} times")


def _ref_module(**children):
    m = torch.nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def _ref_convs(cin, widths, kernels, norm=None, **kw):
    """``conv_layers.conv{i}`` (+ ``bn{i}``), the reference's names."""
    seq = torch.nn.Module()
    for i, (w, k) in enumerate(zip(widths, kernels), start=1):
        setattr(seq, f"conv{i}", torch.nn.Conv1d(cin, w, k, **kw))
        if norm is not None:
            setattr(seq, f"bn{i}", norm(w))
        cin = w
    return seq


def _ref_state_dict(module, seed):
    """``module``'s state_dict drawn from a seeded generator: weights
    normal over sqrt(fan-in), vectors 0.1 x normal, variances positive."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if v.is_floating_point():
            z = torch.randn(v.shape, generator=g)
            v = (z / max(v[0].numel(), 1) ** 0.5 if v.dim() > 1
                 else 0.1 * z)
            if k.endswith("running_var"):
                v = 0.5 + v.abs()
        sd[k] = v
    return sd


def migration_cases(c, length):
    """Reference-layout state_dicts and model_args for the four families
    (``(family, model_args, state_dict)``): the zone demo's CNN widths, the
    flagship CCCNN with ``conv_impl="pallas"``, a bidirectional 2-layer GRU
    RNN and a CNNRNN."""
    nn = torch.nn
    cnn = dict(input_size=140, channels=5, output_size=3,
               layer_sizes=[16, 32], kernel_size=5, dropout_rate=0.4,
               pool=True, batch_norm=True)
    v = 140
    for _ in range(2):
        v = (v + 2 - 4) // 2
    cnn_sd = _ref_state_dict(_ref_module(
        conv_layers=_ref_convs(5, [16, 32], [5, 5], nn.BatchNorm1d,
                               padding=1),
        fc=nn.Linear(32 * v, 3)), 11)
    ks = [1, 33, 64, 15, 15, 15, 1]
    cccnn = dict(input_size=length, channels=c, output_size=2,
                 layer_sizes=[5] * 7, kernel_sizes=ks, batch_norm=False,
                 group=False, cc_norm=False, dropout_rate=0.5,
                 conv_impl="pallas")
    v = length
    for k in ks:
        v = v + 2 - k + 1
    cccnn_sd = _ref_state_dict(_ref_module(
        conv_layers=_ref_convs(1, [5] * 7, ks, padding=1),
        fc=nn.Linear(c * (2 * v - 1), 2)), 12)
    rnn = dict(input_size=length, channels=c, output_size=2, hidden_size=64,
               num_layers=2, num_heads=2, rnn_type="GRU", bidirectional=True,
               dropout_rate=0.5)
    rnn_sd = _ref_state_dict(_ref_module(
        rnn=nn.GRU(c, 64, 2, batch_first=True, bidirectional=True),
        layer_norm=nn.LayerNorm(128),
        attention=nn.MultiheadAttention(128, 2, batch_first=True),
        fc=nn.Linear(128, 2)), 13)
    cnnrnn = dict(input_size=length, channels=c, output_size=2,
                  layer_sizes=[8, 16], kernel_size=3, n_hidden=64,
                  dropout_rate=0.5)
    cnnrnn_sd = _ref_state_dict(_ref_module(
        conv_layers=_ref_convs(c, [8, 16], [3, 3], padding=1),
        rnn=nn.GRU(length, 64, 1, batch_first=True),
        attention=nn.MultiheadAttention(64, 2, batch_first=True),
        fc=nn.Linear(64, 2)), 14)
    return [("cnn", cnn, cnn_sd), ("cccnn", cccnn, cccnn_sd),
            ("rnn", rnn, rnn_sd), ("cnnrnn", cnnrnn, cnnrnn_sd)]


def phase_migration(report, windows):
    """7c: reference-layout checkpoints of the four families through the
    port's maps; each model on the card against the same model on the CPU
    (within 1e-4 of its scale); the imported flagship CCCNN
    (``conv_impl="pallas"``) serving a batch of phase 5's capability
    windows through K3 f32 (one launch, no plain call), K3 at that shape
    held to its plain version at 5e-4/1e-4 and timed beside it and cuDNN's
    f32 chain."""
    import copy

    import torch.nn.functional as F

    from onset_fingerprinting_torch.models import torch_import as ti
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.conv_stack import (
        conv_stack,
        conv_stack_reference,
        kernel_for,
    )

    c, length = windows.shape[1], windows.shape[2]
    g = torch.Generator().manual_seed(15)
    inputs = {
        "cnn": torch.randn(MIG_RNN_WINDOWS, 5, 140, generator=g),
        "cccnn": windows[:MIG_WINDOWS].cpu(),
        "rnn": windows[:MIG_RNN_WINDOWS].cpu(),
        "cnnrnn": windows[:MIG_RNN_WINDOWS].cpu(),
    }
    for family, margs, sd in migration_cases(c, length):
        build = getattr(ti, f"{family}_from_model_args")
        to_port = getattr(ti, f"{family}_state_dict_from_reference")
        cpu_model = build(margs)
        cpu_model.load_state_dict(to_port(sd, cpu_model))
        cpu_model.eval()
        card_model = copy.deepcopy(cpu_model).cuda()
        x = inputs[family]
        with torch.no_grad():
            out_cpu = cpu_model(x)
            _cuda.reset_counts()
            out_card = card_model(x.cuda())
            torch.cuda.synchronize()
        counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS
                  if k.launches or k.plain_calls}
        err = scale_err(out_card.cpu(), out_cpu)
        log(f"7c {family} ({type(cpu_model).__name__}, {tuple(x.shape)} -> "
            f"{tuple(out_card.shape)}): card against CPU {err:.3g} of its "
            f"scale; kernel launches/plain calls {counts}")
        check(bool(torch.isfinite(out_card).all()) and err <= 1e-4,
              f"7c: the imported {family} on the card is {err:.3g} of its "
              "scale from the CPU's")
        if family != "cccnn":
            check(not counts, f"7c {family}: unexpected kernels {counts}")
            continue
        check(card_model.fused and counts == {"conv_stack": (1, 0)},
              f"7c: the imported CCCNN did not serve through K3 f32 alone "
              f"({counts})")
        report["_launches"]["conv_stack_f32_imported"] = (
            _cuda.CONV_STACK.launches)
        xf = x.cuda().reshape(-1, length).contiguous()
        ws = [m.weight.detach() for m in card_model.convs]
        bs = [m.bias.detach() for m in card_model.convs]
        check(kernel_for(length, ws, 1, torch.float32) is _cuda.CONV_STACK,
              "7c: the imported stack is not routed to conv_stack.cu")
        with torch.no_grad():
            k = conv_stack(xf, ws, bs, 1, "silu", torch.float32)
            p = conv_stack_reference(xf, ws, bs, 1, "silu", torch.float32)
            bad = int(((k - p).abs() > 5e-4 + 1e-4 * p.abs()).sum())
            k3_err = max_err(k, p)

            def library(x3=xf[:, None, :]):
                y = x3
                for w, b in zip(ws, bs):
                    y = F.silu(F.conv1d(y, w, b, padding=1))
                return y

            ms = time_ms(lambda: conv_stack(xf, ws, bs, 1, "silu",
                                            torch.float32), n=20)
            plain_ms = time_ms(lambda: conv_stack_reference(
                xf, ws, bs, 1, "silu", torch.float32))
            library_ms = time_ms(library, n=20)
        check(bad == 0, f"7c: K3 f32 at the imported CCCNN's shape: {bad} "
              f"values outside 5e-4 + 1e-4 |plain| (max err {k3_err})")
        flops, t = 0, length
        for w in ws:
            o, i, kk = w.shape
            t = t + 2 - kk + 1
            flops += 2 * o * i * kk * t * len(xf)
        report["conv_stack_f32_imported"] = dict(
            max_abs_err=k3_err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, ops=flops, peak=F32_FLOPS,
            bytes=len(xf) * (length + t * ws[-1].shape[0]) * 4)
        log(f"7c K3 f32 at the imported CCCNN's shape (B = {len(xf)}, L = "
            f"{length}): max err {k3_err:.3g} against plain; kernel {ms:.4f}"
            f" ms, plain {plain_ms:.4f} ms, cuDNN f32 chain (TF32 off) "
            f"{library_ms:.4f} ms; operations bound "
            f"{1e3 * flops / F32_FLOPS:.4f} ms")


def phase_tail(report):
    """7d: the leftover ops on the card against the CPU (``ar_envelope``,
    ``streaming_cc_scan``, ``batch_cross_correlate_dft``) and the 2D host
    locator ``Multilaterate`` on a 16-strike onset stream against the true
    positions."""
    from onset_fingerprinting_torch.core.coords import (
        DIAMETER,
        polar_to_cartesian,
        speed_of_sound,
    )
    from onset_fingerprinting_torch.locate.multilaterate import Multilaterate
    from onset_fingerprinting_torch.ops.envelope import ar_envelope
    from onset_fingerprinting_torch.ops.xcorr import (
        batch_cross_correlate_dft,
        batch_full_correlate,
        streaming_cc_init,
        streaming_cc_scan,
    )

    g = torch.Generator().manual_seed(16)
    x = torch.randn(4000, 64, generator=g).abs()
    y0 = torch.zeros(64)
    e_env = scale_err(ar_envelope(x.cuda(), y0.cuda(), 1 / 3, 1 / 383).cpu(),
                      ar_envelope(x, y0, 1 / 3, 1 / 383))
    blocks = torch.randn(2, 64, 16, 128, generator=g)
    _, ccs = streaming_cc_scan(streaming_cc_init(1024, (16,)),
                               blocks[0].cuda(), blocks[1].cuda())
    _, ccs_cpu = streaming_cc_scan(streaming_cc_init(1024, (16,), "cpu"),
                                   blocks[0], blocks[1])
    e_scc = scale_err(ccs.cpu(), ccs_cpu)
    a, b = torch.randn(2, 512, 4, 256, generator=g)
    cc = batch_cross_correlate_dft(a.cuda(), b.cuda())
    e_dft = scale_err(cc.cpu(), batch_cross_correlate_dft(a, b))
    e_full = scale_err(cc.cpu(), batch_full_correlate(a, b))
    log(f"7d card against CPU, of the scale: ar_envelope [4000, 64] "
        f"{e_env:.3g}; streaming_cc_scan 64 blocks x [16, 128], n = 1024 "
        f"{e_scc:.3g}; batch_cross_correlate_dft [512, 4, 256] {e_dft:.3g} "
        f"(against the rFFT form {e_full:.3g})")
    check(e_env <= 1e-5 and e_scc <= 1e-4 and e_dft <= 1e-4
          and e_full <= 1e-4, "7d: a leftover op on the card differs from "
          "the CPU")
    sensors, sr = [(0.9, 0.0), (0.9, 120.0), (0.9, 240.0)], 96000
    radius = DIAMETER / 2
    locs = [tuple(float(v) for v in polar_to_cartesian(r * radius, p))
            for r, p in sensors]
    c = speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(0)
    m = Multilaterate(sensors, sr=sr)
    errs = []
    for h in range(16):
        r, phi = rng.uniform(0.1, 0.8), rng.uniform(0, 360)
        px, py = (float(v) for v in polar_to_cartesian(r * radius, phi))
        t0 = 5000 + 20000 * h
        got = None
        for on, sensor in sorted(
                (t0 + int(round(np.hypot(px - sx, py - sy) / c * sr)), i)
                for i, (sx, sy) in enumerate(locs)):
            got = m.locate(sensor, on) or got
        if got is not None:
            qx, qy = (float(v) for v in polar_to_cartesian(
                got[0] * radius, got[1]))
            errs.append(float(np.hypot(qx - px, qy - py)))
    log(f"7d Multilaterate (host) on 16 strikes: {len(errs)} located, "
        f"median error {np.median(errs):.4f} cm")
    check(len(errs) >= 14 and np.median(errs) < 1.0,
          "7d: Multilaterate located too few strikes or too far")


def phase7(report, amp_ref, windows, phase):
    phase("phase 7a: spectral and amplitude detection")
    phase_detect7(report, amp_ref)
    phase("phase 7b: the zone-classifier loop")
    phase_zone(report)
    torch.cuda.empty_cache()
    phase("phase 7c: reference checkpoints into the port, K3 f32 serving")
    phase_migration(report, windows)
    phase("phase 7d: the leftover ops and locators")
    phase_tail(report)


#: phase 8: the sharded paths on a world-1 NCCL group
#: 8c: streams of the realtime demo's drum, their seconds, events per stream
SERVE_STREAMS = 1024
SERVE_SECONDS = 2.0
SERVE_EVENTS = 32
#: 8c: streams held to the plain scan on the CPU, and the streams, across
#: K1's grid, whose output of the full-shape launch is held to the plain
#: detector over their first SERVE_PLAIN_SAMPLES samples
SERVE_PLAIN_STREAMS = 8
SERVE_PLAIN_DET_STREAMS = (0, SERVE_STREAMS // 2 - 1, SERVE_STREAMS - 1)
SERVE_PLAIN_SAMPLES = 24064
#: 8c: streams the coupled pipe is held to the plain detector on the card
#: (vmap), over their first SERVE_PLAIN_SAMPLES
SERVE_VMAP_STREAMS = 64
#: 8d: the cc_refine engine's CPU reference prefix
CC_CPU_SECONDS = 2.0
#: 8e: full-batch steps of the meshed trainer
MESH_STEPS = 10


def cc_cpu_reference(seconds, prefix, seed, out):
    """8d's reference, in a child process beside the card phases: the plain
    engine with ``cc_refine=True`` on the CPU over the stream's first
    ``prefix`` seconds, its event queue as numpy arrays."""
    from onset_fingerprinting_torch.tools import realtime_sim as sim

    torch.set_num_threads(1)
    audio, _, _ = sim.synth_stream(seconds, seed)
    eng = sim.build_engine("cpu", cc_refine=True)
    sim.run(eng, audio[: int(prefix * sim.SR)], classify=False)
    st = eng.state
    out.put({k: getattr(st, k).numpy() for k in
             ("ev_count", "ev_points", "ev_onsets", "ev_emits")})


def start_cc_reference():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=cc_cpu_reference,
                    args=(RT_SECONDS, CC_CPU_SECONDS, 0, q), daemon=True)
    p.start()
    return p, q


def nccl_world1():
    """A world-1 NCCL process group on a localhost store, and its mesh."""
    import socket

    import torch.distributed as dist

    from onset_fingerprinting_torch.parallel import make_mesh

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    mesh = make_mesh((1,), ("data",))
    check(mesh.group("data") is not None and dist.get_backend() == "nccl",
          "no NCCL group on the mesh")
    return mesh


def add_launches(report, names, counts):
    """Add a path's launch counts (``counts``: row -> launches)."""
    for name in names:
        report["_launches"][name] = (report["_launches"].get(name, 0)
                                     + counts.get(name, 0))


def phase_sharded_fleet(report, mesh):
    """8a: ``make_detect_fingerprint_sharded`` at bench.py's headline point
    (8192 streams x 4 channels, layout 'wide', one chunk of 32000 samples,
    compact_capacity 32768, the bf16 flagship) against
    ``pipeline.DetectFingerprint``'s stages on the same chunk and state."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import detector_init
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.models.jax_import import (
        cccnn_state_dict_from_flax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.windows import (
        compact_hit_list,
        gather_hit_windows,
        gather_kernel_for,
        top_hit_blocks,
    )
    from onset_fingerprinting_torch.parallel import (
        make_detect_fingerprint_sharded,
    )
    from onset_fingerprinting_torch.pipeline import (
        fleet_detector_config,
        make_detect_fingerprint,
    )
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        PRE,
        WINDOW,
        flagship_flax_params,
        make_audio,
    )

    model = CCCNN(input_size=WINDOW, dtype=torch.bfloat16, **FLAGSHIP)
    model.load_state_dict(cccnn_state_dict_from_flax(
        flagship_flax_params(seed=0)))
    static, params, state = detector_init(DetectorConfig(
        n_channels=4, block_size=128, hipass_freq=2000.0, sr=96000,
        coupled_off_gate=False))
    cap = 16
    run = make_detect_fingerprint_sharded(
        static, params, state, (CHUNK, N_STREAMS * 4), mesh, model,
        window=WINDOW, pre=PRE, capacity=cap, layout="wide",
        channels_per_stream=4, compact_capacity=G)
    x = make_audio(CHUNK, N_STREAMS * 4, seed=10)
    _cuda.reset_counts()
    preds, starts, valid, dropped = run(x)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    log(f"8a sharded fleet ({N_STREAMS} streams x 4, wide, one chunk of "
        f"{CHUNK}, compact {G}): launches {counts}, plain calls "
        f"{ {k.name: k.plain_calls for k in _cuda.KERNELS} }")
    route = gather_kernel_for(4, WINDOW, x.data_ptr())
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS),
          "a plain version ran on the sharded fleet path")
    check(counts["detector_pipe"] == 1 and counts["conv_stack_mma"] == 1
          and route.kernel is _cuda.GATHER_VEC
          and route.kernel.variants[route.variant] == 1
          and sum(counts.values()) == 3,
          "8a: want one launch each of K1's pipe, K2 gather_vec and K3 mma")
    add_launches(report, ("detector_pipe", "gather_vec", "conv_stack_mma"),
                 counts)
    # the same chunk and state through the pipeline's stages; the sharded
    # route's windows are the gather's non-anchored contract at block
    # starts (JAX's sharded function), the pipeline's sample-anchored
    pipe = make_detect_fingerprint(fleet_detector_config(N_STREAMS), model,
                                   N_STREAMS, CHUNK, G)
    _, on, deltas = pipe.detect(pipe.init_state(), x)
    st_ref, v_ref = top_hit_blocks(on, 128, N_STREAMS, cap)
    sts, sids, ok, n_drop, idx = compact_hit_list(st_ref, v_ref, G,
                                                  return_indices=True)
    p = pipe.predict(gather_hit_windows(x, sts, sids, 4, WINDOW, PRE,
                                        anchored=False), ok)
    want = torch.zeros((N_STREAMS * cap, p.shape[-1]), dtype=p.dtype,
                       device=p.device)
    want[idx[ok].long()] = p[ok]
    perr = max_err(preds.reshape(-1, p.shape[-1]), want)
    check(torch.equal(starts, st_ref) and torch.equal(valid, v_ref)
          and int(dropped.sum()) == int(n_drop) == 0 and perr == 0.0
          and bool(torch.isfinite(preds).all()),
          f"8a: sharded fleet differs from the pipeline's stages (pred err "
          f"{perr}, dropped {dropped.tolist()} / {int(n_drop)})")
    _, anch_v = top_hit_blocks(on, 128, N_STREAMS, cap, deltas)
    check(torch.equal(anch_v, v_ref), "8a: hit slots differ by route")
    log(f"8a: starts, valid ({int(valid.sum())} hits) and n_dropped "
        f"{dropped.tolist()} equal the pipeline's stages, predictions equal "
        f"(max err {perr}); the routes differ only in the window start: "
        "block start (JAX's sharded contract) against the pipeline's "
        "sample-anchored start, with the same hit slots")
    ms = time_ms(lambda: run(x), n=5)
    report["_sharded"] = dict(fleet_ms=ms)
    log(f"8a: one sharded chunk {ms:.3f} ms (CUDA events, mean of 5; "
        f"{ms * 3:.3f} ms per second of audio, phase 2's per-chunk sum "
        f"beside it in the same log)")
    del x, pipe, run
    torch.cuda.empty_cache()


def phase_time_sharded(report, mesh):
    """8b: ``detect_offline_time_sharded`` and ``detect_events_time_sharded``
    over 6b's recording against the sequential detector (K1 over the whole
    recording): dense events exactly, the event list equal; the NCCL
    all_gather runs."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import detector_init
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        detector_static,
        fused_detect_offline,
    )
    from onset_fingerprinting_torch.parallel import (
        detect_events_time_sharded,
        detect_offline_time_sharded,
    )
    from onset_fingerprinting_torch.parallel.sharding import (
        events_from_dense,
    )

    audio, sr = read_wav(J_DIR / "train_patch" / "train_patch.wav")
    t = len(audio) // 128 * 128
    x = torch.as_tensor(np.ascontiguousarray(audio[:t]), device="cuda")
    static, params, state = detector_init(DetectorConfig(
        n_channels=3, block_size=128, sr=sr))
    _, (on_s, d_s, _) = fused_detect_offline(
        detector_static(static, params), params, state, x, emit_rel=False)
    _cuda.reset_counts()
    on, d, _ = detect_offline_time_sharded(static, params, state, x, mesh)
    # a segment holds every event of the recording at world size 1
    ch, ons = detect_events_time_sharded(static, params, state, x, mesh,
                                         capacity=1024)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS)
          and counts["detector_pipe_coupled"] == 2
          and _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"] == 2
          and sum(counts.values()) == 2,
          f"8b: want two launches of K1's coupled pipe, no plain: {counts}")
    add_launches(report, ("detector_pipe_coupled",), counts)
    check(torch.equal(on, on_s) and torch.equal(d[on], d_s[on_s]),
          "8b: time-sharded dense events differ from the sequential")
    want = sorted(zip(*events_from_dense(on_s, d_s, 128)))
    got = sorted(zip(ch.tolist(), ons.tolist()))
    check(got == [(int(a), int(b)) for a, b in want] and len(got) > 0,
          "8b: the gathered event list differs from the sequential")
    ms = time_ms(lambda: detect_offline_time_sharded(static, params, state,
                                                     x, mesh), n=3)
    ems = time_ms(lambda: detect_events_time_sharded(
        static, params, state, x, mesh, capacity=1024), n=3)
    log(f"8b: {tuple(x.shape)} recording, time-sharded over the world-1 "
        f"NCCL mesh: {int(on.sum())} dense events equal to the sequential "
        f"K1, the all_gather-ed list of {len(got)} events equal; K1 "
        f"launches {counts['detector_pipe_coupled']} (the coupled pipe); "
        f"detect_offline_time_sharded "
        f"{ms:.3f} ms, detect_events_time_sharded {ems:.3f} ms (CUDA "
        "events, mean of 3, halo and gathers included)")


def phase_sharded_serve(report, mesh):
    """8c: ``make_detect_locate_sharded`` on the realtime demo's drum, the
    bf16 flagship as classifier (window 256): K1 over the batch of streams
    in one launch, the stream-batched locate kernel, K3; the locate held to
    its plain scan on the CPU, K1 to the plain detector on a subset; the
    realtime bars against the synthetic truth."""
    from types import SimpleNamespace

    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import (
        DetectorState,
        detect_offline,
        detector_init,
    )
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.models.jax_import import (
        cccnn_state_dict_from_flax,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from torch.func import vmap

    from onset_fingerprinting_torch.ops.fused_detector import (
        coupled_plan,
        detector_static,
        fused_detect_streams,
        fused_warmup_minmax,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        LocateBlock,
        locate_streams,
        locate_streams_reference,
    )
    from onset_fingerprinting_torch.parallel import (
        make_detect_locate_sharded,
    )
    from onset_fingerprinting_torch.parallel.sharding import stream_events
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        cccnn_flax_params,
    )

    t0 = time.perf_counter()
    n_s = SERVE_STREAMS
    n_t = int(SERVE_SECONDS * sim.SR) // 128 * 128
    streams, truths = [], []
    for s in range(n_s):
        a, _, hits = sim.synth_stream(SERVE_SECONDS, seed=1000 + s)
        streams.append(a[:n_t])
        truths.append(hits)
    x = torch.as_tensor(np.stack(streams), device="cuda")
    del streams
    log(f"8c: {n_s} streams of {n_t} samples x 3 made in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    static, params, state = detector_init(cfg)
    state = fused_warmup_minmax(detector_static(static, params), params,
                                state, x[0, : sim.WARMUP // 128 * 128])
    locator = sim.build_engine("cpu", ring_seconds=0.01).locator
    conf = dict(FLAGSHIP, channels=3, output_size=sim.N_ZONES)
    model = CCCNN(input_size=256, dtype=torch.bfloat16, **conf)
    model.load_state_dict(cccnn_state_dict_from_flax(
        cccnn_flax_params(conf, seed=0, window=256)))
    run = make_detect_locate_sharded(
        static, params, state, tuple(x.shape), mesh, locator, model=model,
        event_capacity=SERVE_EVENTS, window=256, pre=64)
    _cuda.reset_counts()
    points, onsets, emits, preds = run(x)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    variants = {k.name: dict(k.variants) for k in _cuda.KERNELS
                if k.variants}
    log(f"8c: launches {counts}, variants {variants}")
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS),
          "a plain version ran on the sharded serve path")
    check(_cuda.DETECTOR_PIPE_COUPLED.variants["coupled_streams"] == 1
          and counts["detector_pipe_coupled"] == 1
          and counts["detector_warp"] == 0
          and _cuda.LOCATE_BLOCK.variants["streams"] == 1
          and counts["locate_block"] == 1 and counts["conv_stack_mma"] == 1,
          "8c: want one launch each of K1 over the streams (the coupled "
          "pipe), the stream-batched locate kernel and K3")
    report["_launches"]["detector_pipe_coupled_streams"] = 1
    report["_launches"]["locate_streams"] = 1
    add_launches(report, ("conv_stack_mma",), counts)
    check(bool(torch.isfinite(preds).all()) and not bool(
        preds[~emits].any()), "8c: classifier output")

    # the realtime bars against the synthetic truth, over all streams
    pts, ons, ems = (v.cpu().numpy() for v in (points, onsets, emits))
    matched = total = 0
    errs = []
    for s in range(n_s):
        ev = [(int(o), SimpleNamespace(x=float(p[0]), y=float(p[1])))
              for o, p, e in zip(ons[s], pts[s], ems[s]) if e]
        m, _, _ = sim.locate_gates(truths[s], ev)
        matched += m
        total += len(truths[s])
        for base, hx, hy, _ in truths[s]:
            near = [np.hypot(loc.x - hx, loc.y - hy) for o, loc in ev
                    if abs(o - base) < 2400]
            if near:
                errs.append(min(near))
    rate, med = matched / total, float(np.median(errs))
    min_frac, med_cm = sim.LOCATE_BARS["cuda"]
    log(f"8c: {int(ems.sum())} hits located, {matched}/{total} strikes "
        f"matched ({rate:.4f}, bar {min_frac}), median error "
        f"{med:.4f} cm (bar {med_cm})")
    check(rate >= min_frac and med <= med_cm, "8c: realtime bars failed")

    # the locate kernel against its plain scan on the CPU, same events
    lb = LocateBlock(locator, 3, 128, device="cuda")
    k = SERVE_PLAIN_STREAMS
    # the events' channels, from K1 again (run() keeps them inside)
    states = DetectorState(*(v.expand((n_s,) + tuple(v.shape)).contiguous()
                             for v in state))
    fst = detector_static(static, params)
    new_k, (on_k, d_k, rel_k) = fused_detect_streams(fst, params, states, x,
                                                     emit_rel=True)
    # the same launch on detector_warp.cu (named), bit for bit
    new_o, (on_o, d_o, rel_o) = fused_detect_streams(
        fst, params, states, x, emit_rel=True, kernel=_cuda.DETECTOR_WARP)
    torch.cuda.synchronize()
    check(torch.equal(on_k, on_o) and torch.equal(d_k, d_o)
          and torch.equal(rel_k, rel_o) and states_equal(new_k, new_o),
          "8c: the coupled pipe differs from detector_warp.cu over the "
          "streams")
    log(f"8c: K1 over [{n_s}, {n_t}, 3] (the coupled pipe, "
        f"{coupled_plan(n_s, 3, 128).groups_per_cta} streams a CTA) "
        f"against detector_warp.cu's stream batch: on, deltas, rel and "
        f"every state tensor bit-identical ({int(on_k.sum())} onsets)")
    del new_k, rel_k, new_o, on_o, d_o, rel_o
    torch.cuda.empty_cache()
    # and against the plain detector on the card, under vmap (JAX's
    # route, sharding.py:686), on the first SERVE_VMAP_STREAMS streams
    nv, tv = SERVE_VMAP_STREAMS, SERVE_PLAIN_SAMPLES
    sub = DetectorState(*(v[:nv].contiguous() for v in states))
    xv = x[:nv, :tv].contiguous()
    new_v, (on_v, d_v, rel_v) = fused_detect_streams(fst, params, sub, xv,
                                                     emit_rel=True)
    t0 = time.perf_counter()
    new_p, (on_p, d_p, rel_p) = vmap(
        lambda st, xs: detect_offline(static, params, DetectorState(*st),
                                      xs))(tuple(sub), xv)
    torch.cuda.synchronize()
    vmap_ms = 1e3 * (time.perf_counter() - t0)
    check(torch.equal(on_v, on_p) and torch.equal(d_v, d_p)
          and torch.equal(rel_v, rel_p) and states_equal(new_v, new_p),
          "8c: the coupled pipe differs from the plain detector on the card")
    log(f"8c: the coupled pipe over [{nv}, {tv}, 3] against the plain "
        f"detector under vmap on the card ({vmap_ms:.0f} ms): on, deltas, "
        f"rel and every state tensor bit-identical ({int(on_v.sum())} "
        "onsets)")
    ev_on, chs = stream_events(on_k, d_k, 128, SERVE_EVENTS)
    check(torch.equal(ev_on, onsets), "8c: events differ between runs")
    t0 = time.perf_counter()
    pp, ep = locate_streams_reference(
        LocateBlock(locator, 3, 128, device="cpu"), ev_on[:k].cpu(),
        chs[:k].cpu())
    plain_ms = 1e3 * (time.perf_counter() - t0)
    lerr = max_err(points[:k].cpu(), pp)
    check(torch.equal(emits[:k].cpu(), ep) and lerr <= 1e-3,
          f"8c: locate kernel vs plain scan on {k} streams (err {lerr})")
    log(f"8c: the stream-batched locate kernel on {k} streams equal to its "
        f"plain scan on the CPU ({int(ep.sum())} emits, points max err "
        f"{lerr:.3g} cm, the scan {plain_ms:.1f} ms)")
    # K1's full-shape launch above against the plain detector, on streams
    # across its grid over their first td samples (the detector is causal)
    td = SERVE_PLAIN_SAMPLES
    cpu_state = DetectorState(*(v.cpu() for v in state))
    cpu_params = type(params)(*(v.cpu() for v in params))
    det_err = 0.0
    t0 = time.perf_counter()
    for s in SERVE_PLAIN_DET_STREAMS:
        _, (on_p, d_p, _) = detect_offline(static, cpu_params, cpu_state,
                                           x[s, :td].cpu())
        on_s, d_s = on_k[s, : td // 128].cpu(), d_k[s, : td // 128].cpu()
        det_err = max(det_err, float((on_s.int() - on_p.int()).abs().max()),
                      float((d_s - d_p).abs().max()))
        check(torch.equal(on_s, on_p) and torch.equal(d_s, d_p),
              f"8c: K1 over streams differs from plain, stream {s}")
    det_plain_ms = 1e3 * (time.perf_counter() - t0)
    log(f"8c: K1 (the coupled pipe) at the full shape "
        f"equal to the plain detector on the CPU on streams "
        f"{SERVE_PLAIN_DET_STREAMS} over their first {td} samples (max err "
        f"{det_err:g}; {det_plain_ms:.0f} ms plain)")

    # times: K1 over the streams in turns (old, new, new, old), the locate
    # kernel, at 8c's shape
    def k1_new():
        fused_detect_streams(fst, params, states, x)

    def k1_old():
        fused_detect_streams(fst, params, states, x,
                             kernel=_cuda.DETECTOR_WARP)

    old_t = [time_ms(k1_old, n=3)]
    new_t = [time_ms(k1_new, n=3), time_ms(k1_new, n=3)]
    old_t.append(time_ms(k1_old, n=3))
    det_ms, old_ms = sum(new_t) / 2, sum(old_t) / 2
    loc_ms = time_ms(lambda: locate_streams(lb, onsets, chs), n=20)
    run_ms = time_ms(lambda: run(x), n=3)
    work = detector_work((n_t, n_s * 3))
    log(f"8c: K1 over {n_s} streams x {n_t} x 3 in turns old, new, new, "
        f"old: the coupled pipe {det_ms:.3f} ms ({new_t[0]:.3f}, "
        f"{new_t[1]:.3f}), detector_warp.cu {old_ms:.3f} ms "
        f"({old_t[0]:.3f}, {old_t[1]:.3f}); {bounds_line(work, n_t)}; the "
        f"stream-batched locate kernel {loc_ms:.4f} ms ({n_s} x "
        f"{SERVE_EVENTS} events); run() {run_ms:.3f} ms for "
        f"{SERVE_SECONDS:g} s of {n_s} streams")
    report["detector_pipe_coupled_streams"] = dict(
        max_abs_err=det_err, ms=det_ms, plain_ms=det_plain_ms,
        library_ms=None, **work)
    report["detector_warp_streams"] = dict(
        max_abs_err=det_err, ms=old_ms, plain_ms=det_plain_ms,
        library_ms=None, **work)
    ev_bytes = n_s * SERVE_EVENTS * (4 + 4 + 8 + 1)
    report["locate_streams"] = dict(
        max_abs_err=lerr, ms=loc_ms, plain_ms=plain_ms, library_ms=None,
        bytes=ev_bytes + sum(v.numel() * 4 for v in lb.tables), ops=0,
        peak=F32_FLOPS)
    report["_sharded"].update(serve_ms=run_ms, serve_rate=rate,
                              serve_median_cm=med)
    del x, states
    torch.cuda.empty_cache()


def phase_cc_refine(report, cc_ref):
    """8d: the realtime engine with ``cc_refine=True`` over phase 4's 20 s
    stream on the card: two kernel nodes, phase 4's bars, the first 2 s
    equal to the plain engine on the CPU (a child process from phase 0),
    the locate kernel with the ring write in place against its plain
    version (the plain ring write, then the plain step) on fired and quiet
    blocks: ring, state and queue, each refinement held to the plain one
    (a differing argmax only at a float32 tie) and its argmax to the
    kernel's schedule on the CPU (``cc_schedule_reference``); its launch
    timed on fired and on quiet blocks beside the Newton kernel's."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.core.ring_buffer import (
        RingBuffer,
        ring_init,
        ring_read_last,
        ring_write,
    )
    from onset_fingerprinting_torch.detect.refine import cc_refine_terms
    from onset_fingerprinting_torch.locate.multilaterate import (
        locator_init,
    )
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import (
        fused_detect_offline,
        fused_warmup_minmax,
        make_fused_detector,
    )
    from onset_fingerprinting_torch.ops.locate_block import (
        LOG_W,
        EventQueue,
        LOG_FIELDS,
        LocateBlock,
        cc_schedule_reference,
        check_refinements,
        locate_block,
        locate_block_reference,
    )
    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.tools.step_bench import (
        graph_ms,
        graph_nodes,
        small_ring,
    )

    audio, _, hits = sim.synth_stream(RT_SECONDS, 0)
    eng = sim.build_engine(None, cc_refine=True)
    types, names = graph_nodes(eng._graph.graph)
    check(types == {"kernel": 2}, f"8d: the captured step holds {types}")
    n_blocks = len(sim.blocks_of(audio))
    _cuda.reset_counts()
    events, _, wall = sim.run(eng, audio, classify=False)
    counts = {k.name: k.launches for k in _cuda.KERNELS}
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS)
          and _cuda.LOCATE_BLOCK.variants["ring+cc_refine"] == n_blocks
          and counts["locate_block"] == n_blocks
          and counts["detector_warp"] == n_blocks
          and counts["detector_pipe_coupled"] == 1,
          f"8d: want {n_blocks} refining locate launches and K1 steps, one "
          f"K1 warmup (the coupled pipe): {counts}")
    add_launches(report, ("detector_warp", "ring_write",
                          "detector_pipe_coupled"), {
        **counts, "ring_write": _cuda.ring_writes(
            _cuda.LOCATE_BLOCK.variants)})
    report["_launches"]["locate_block_cc_refine"] = n_blocks
    matched, med, ok = sim.locate_gates(hits, events)
    log(f"8d: captured step {types} {names}; {len(events)} hits, "
        f"{matched}/{len(hits)} strikes matched, median error {med:.4f} cm "
        f"(bars {sim.LOCATE_BARS['cuda']}); {n_blocks} blocks "
        f"in {wall:.3f} s host wall")
    check(ok, "8d: realtime bars failed with cc_refine")

    # the first CC_CPU_SECONDS against the plain engine on the CPU
    ref = wait_cpu_reference(*cc_ref)
    n_ref = int(ref["ev_count"])
    cpu_end = 128 * len(sim.blocks_of(audio[: int(CC_CPU_SECONDS * sim.SR)]))
    st = eng.state
    emits = st.ev_emits.cpu().numpy()[: int(st.ev_count)]
    check(n_ref > 0 and int((emits < cpu_end).sum()) == n_ref
          and np.array_equal(st.ev_onsets.cpu().numpy()[:n_ref],
                             ref["ev_onsets"][:n_ref])
          and np.array_equal(emits[:n_ref], ref["ev_emits"][:n_ref]),
          "8d: card and CPU cc_refine engines' events differ")
    perr = max_err(st.ev_points[:n_ref].cpu(),
                   torch.as_tensor(ref["ev_points"][:n_ref]))
    check(perr <= 1e-3, f"8d: card and CPU points differ by {perr} cm")
    log(f"8d: first {CC_CPU_SECONDS:g} s: {n_ref} events equal to the plain "
        f"cc_refine engine on the CPU, points max err {perr:.3g} cm")

    # the kernel in place against its plain version, block by block from
    # the plain version's state, over the first CC_CPU_SECONDS
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=sim.SR)
    fst, params, det, _ = make_fused_detector(cfg, emit_rel=False)
    det = fused_warmup_minmax(fst, params, det, torch.as_tensor(
        audio[: sim.WARMUP // 128 * 128], device="cuda"))
    ring = ring_init(int(sim.RING_SECONDS * sim.SR), (3,), device="cuda")
    ring_p = RingBuffer(ring.data.clone(), ring.counter.clone())
    lb = LocateBlock(eng.locator, 3, 128, cc_refine=True, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    lp = locator_init(8, "cuda")
    qp = EventQueue(torch.zeros((sim.EVENT_QUEUE, 2), device="cuda"),
                    torch.zeros(sim.EVENT_QUEUE, **i32),
                    torch.zeros(sim.EVENT_QUEUE, **i32),
                    torch.zeros((), **i32))
    l0 = type(lp)(*(v.clone() for v in lp))
    q0 = type(qp)(*(v.clone() for v in qp))
    blocks = torch.as_tensor(np.stack(sim.blocks_of(audio)), device="cuda")
    fired, quiet, n_checked, ties, lerr = [], [], 0, [], 0.0
    plain_s, n_sched = 0.0, 0
    for i in range(int(CC_CPU_SECONDS * sim.SR) // 128):
        det, (on, d, _) = fused_detect_offline(fst, params, det, blocks[i],
                                               False, out=det)
        ring_p = ring_write(ring_p, blocks[i])
        on, d = on[0], d[0]
        count = torch.tensor(128 * i, **i32)
        is_fired = bool(on.any())
        if not is_fired and len(quiet) >= 64:
            # a quiet block leaves the locator and the queue
            ring = ring_write(ring, blocks[i])
            continue
        lk = type(lp)(*(v.clone() for v in lp))
        qk = type(qp)(*(v.clone() for v in qp))
        ck = count.clone()
        was = [v.clone() for v in (*lk, *qk)]
        log_t = torch.zeros((3, LOG_W), **i32)
        _, _, hk, _ = locate_block(lb, lk, qk, on, d, ck, ring, log_t,
                                   out=(lk, qk, ck), block=blocks[i])
        check(torch.equal(ring.counter, ring_p.counter)
              and torch.equal(ring.data, ring_p.data),
              f"8d: the ring written in the locate launch differs from the "
              f"plain ring write at block {i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp, qp, hp, cp = locate_block_reference(lb, lp, qp, on, d, count,
                                                ring)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        n, t = check_refinements(lb, log_t, ring)
        n_checked += n
        ties += t
        # each refinement's argmax and corrections: the kernel's schedule on
        # the CPU, exactly (the same sums in the same order)
        window = ring_read_last(ring, lb.window_len).cpu()
        for row in log_t.cpu().numpy():
            r = dict(zip(LOG_FIELDS, (int(v) for v in row)))
            if not (r["done"] and r["go"]):
                continue
            tm = cc_refine_terms(
                window[:, [r["ch0"], r["ch1"]]],
                torch.tensor(r["pos0"], dtype=torch.int32),
                torch.tensor(r["pos1"], dtype=torch.int32))
            sched = cc_schedule_reference(tm.x.numpy(), tm.y.numpy(),
                                          r["pos0"], r["pos1"])
            check(sched["arg"] == r["arg"] and sched["ok"] == bool(r["ok"]),
                  f"8d: block {i}: the kernel's argmax {r['arg']} differs "
                  f"from its schedule's on the CPU {sched['arg']}")
            n_sched += 1
        same = (all(torch.equal(u, v) for u, v in zip(
            (*lk, *qk[1:], ck), (*lp, *qp[1:], cp)))
            and torch.equal(hk.emits, hp.emits))
        check(same or t, f"8d: the refining locate kernel differs from "
              f"plain at block {i} without a tie")
        if same:
            lerr = max(lerr, max_err(hk.points, hp.points),
                       max_err(qk.points, qp.points))
        # the stream's last frames as a small ring with the same counter:
        # the refinement reads the same window from it
        (fired if is_fired else quiet).append(
            (on, d, count, small_ring(audio, 128 * (i + 1))))
        if not is_fired:
            check(all(torch.equal(u, v) for u, v in zip(was, (*lk, *qk))),
                  f"8d: the kernel changed the state on quiet block {i}")
    n_quiet = len(quiet)
    check(n_checked >= 10 and lerr <= 1e-3 and n_sched == n_checked,
          f"8d: {n_checked} refinements checked ({n_sched} against the "
          f"schedule), points err {lerr}")
    log(f"8d: the refining locate kernel with the ring write in place over "
        f"the first {CC_CPU_SECONDS:g} s ({len(fired)} fired, {n_quiet} "
        f"quiet blocks): ring, state, queue, counter and emits equal to "
        f"plain, points max err {lerr:.3g} cm; {n_checked} refinements held "
        f"to the plain CC, {len(ties)} float32 ties: {ties}; every argmax "
        f"equal to the kernel's schedule on the CPU")

    # the launch with refinement beside the Newton kernel, per launch in a
    # graph of launches over the fired blocks in stream order (each
    # refining against its own window: a small ring of the stream up to
    # the block's end, written before, so no launch writes a ring) and
    # over the quiet ones; in turns (refining, Newton, Newton, refining)
    lb_n = LocateBlock(eng.locator, 3, 128, device="cuda")

    def calls_ms(b, calls, with_ring):
        work = [v.clone() for v in (*l0, *q0)]
        pristine = [v.clone() for v in work]
        counts_ = [c.clone() for _, _, c, _ in calls]
        lw, qw = type(l0)(*work[:5]), type(q0)(*work[5:9])

        def restore():
            for w, p in zip(work, pristine):
                w.copy_(p)

        def chain():
            for (on, d, _, small), c in zip(calls, counts_):
                locate_block(b, lw, qw, on, d, c,
                             small if with_ring else None, out=(lw, qw, c))

        return graph_ms([chain], before=restore) / len(calls)

    cc_f, newton_f, cc_q, newton_q = [], [], [], []
    for cc_first in (True, False):
        for refining in ((True, False) if cc_first else (False, True)):
            if refining:
                cc_f.append(calls_ms(lb, fired, True))
                cc_q.append(calls_ms(lb, quiet, True))
            else:
                newton_f.append(calls_ms(lb_n, fired, False))
                newton_q.append(calls_ms(lb_n, quiet, False))
    cc_ms, newton_ms = float(np.mean(cc_f)), float(np.mean(newton_f))
    cc_quiet_ms = float(np.mean(cc_q))
    newton_quiet_ms = float(np.mean(newton_q))
    # the learned locator with the refinement (variant "fcnn+cc_refine")
    fcnn_cc_ms = calls_ms(LocateBlock(eng.locator, 3, 128,
                                      model=locate_fcnn(1), cc_refine=True,
                                      device="cuda"), fired, True)
    plain_ms = 1e3 * plain_s / max(len(fired) + n_quiet, 1)
    log(f"8d: locate kernel per launch in a graph, in turns: fired blocks "
        f"with cc_refine {cc_ms:.5f} ms {cc_f}, Newton without "
        f"{newton_ms:.5f} ms {newton_f}; quiet blocks with cc_refine "
        f"{cc_quiet_ms:.5f} ms {cc_q}, Newton {newton_quiet_ms:.5f} ms "
        f"{newton_q}; the FCNN with cc_refine on fired blocks "
        f"{fcnn_cc_ms:.5f} ms; the plain version {plain_ms:.3f} ms per "
        "block (eager, host clock)")
    state_bytes = sum(v.numel() * v.element_size() for v in (*l0, *q0))
    win = lb.window_len
    report["locate_block_cc_refine"] = dict(
        max_abs_err=lerr, ms=cc_ms, plain_ms=plain_ms, library_ms=None,
        bytes=2 * state_bytes + n_checked / max(len(fired), 1) * 2 * win * 4,
        ops=n_checked / max(len(fired), 1) * 2 * ONSET_TOL_2 * win,
        peak=F64_FLOPS)
    report["_sharded"].update(cc_newton_ms=newton_ms, cc_fcnn_ms=fcnn_cc_ms,
                              cc_quiet_ms=cc_quiet_ms,
                              cc_newton_quiet_ms=newton_quiet_ms)


#: the lags the refinement's CC sums (2 * ONSET_TOL)
ONSET_TOL_2 = 100


def phase_trainer_mesh(report, mesh, fix):
    """8e: the capability fixture's float32 flagship for MESH_STEPS
    full-batch steps with ``Trainer(mesh=)`` on the world-1 NCCL mesh
    against the unmeshed trainer (5b's optimizer): the losses within 1e-6
    relative."""
    from onset_fingerprinting_torch.core.config import TrainConfig
    from onset_fingerprinting_torch.models.train import (
        Trainer,
        make_optimizer,
    )
    from onset_fingerprinting_torch.tools.fingerprint_capability import (
        flagship_f32,
    )

    x, y = fix.x_train, fix.y_train
    losses, secs = {}, {}

    def trainer(m=None):
        return Trainer(flagship_f32(), TrainConfig(loss="l1", seed=0),
                       optimizer=make_optimizer("adam", 3e-3, "cosine", 100),
                       mesh=m)

    # a step of each first, untimed: the libraries' lazy set-up, which the
    # first timed trainer would bear when phase 8 runs alone
    for m in (None, mesh):
        warm = trainer(m)
        warm.step(warm.init_state(), x, y)
    for meshed in (False, True):
        tr = trainer(mesh if meshed else None)
        st = tr.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[meshed] = torch.stack(
            [tr.step(st, x, y) for _ in range(MESH_STEPS)]).cpu().numpy()
        secs[meshed] = time.perf_counter() - t0
    rel = float(np.max(np.abs(losses[True] - losses[False])
                       / np.abs(losses[False])))
    check(rel <= 1e-6 and bool(np.isfinite(losses[True]).all()),
          f"8e: meshed and unmeshed losses differ by {rel} relative")
    log(f"8e: the f32 flagship on the fixture's {x.shape[0]} windows, "
        f"{MESH_STEPS} full-batch steps: meshed (world-1 NCCL, gradients "
        f"all_reduce-d) losses {losses[True][[0, -1]].tolist()} equal the "
        f"unmeshed within {rel:.3g} relative; "
        f"{1e3 * secs[True] / MESH_STEPS:.3f} / "
        f"{1e3 * secs[False] / MESH_STEPS:.3f} ms per step meshed / not "
        "(host clock)")


def phase8(report, cc_ref, fix, phase):
    """Phase 8 on a world-1 NCCL process group, destroyed at the end."""
    import torch.distributed as dist

    mesh = nccl_world1()
    try:
        phase("phase 8a: the sharded fleet path")
        phase_sharded_fleet(report, mesh)
        phase("phase 8b: time sharding and the event all_gather")
        phase_time_sharded(report, mesh)
        phase("phase 8c: the sharded serve datapath")
        phase_sharded_serve(report, mesh)
        phase("phase 8d: cc_refine in the locate kernel")
        phase_cc_refine(report, cc_ref)
        phase("phase 8e: the trainer on a mesh")
        phase_trainer_mesh(report, mesh, fix)
    finally:
        dist.destroy_process_group()


#: phase 9: the tuner's slider settings over 6b's recording (the defaults,
#: then two others; hipass_freq 0 turns the high-pass off)
TUNER_SETTINGS = (
    {},
    {"on_threshold": 0.3, "off_threshold": 0.05, "cooldown": 2000.0,
     "max_distance": 500.0},
    {"hipass_freq": 0.0, "floor": -60.0, "fast_attack": 5.0,
     "fast_release": 200.0, "on_threshold": 0.7},
)
#: 9b: the engine steps traced beside the tuner's detect()
TRACE_STEPS = 8
TRACE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trace"
#: 9c: the serve loop's stream (the demo's 60 s cut to 30 s)
SERVE_RT_SECONDS = 30.0


def tuner_cpu_reference(wav, values, out):
    """9a's reference, in a child process beside the card phases: the
    tuner's detect() with the plain detector on the CPU at one slider
    setting over 6b's recording."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.tools.choose_od_settings import (
        DetectorTuner,
    )

    torch.set_num_threads(1)
    audio, sr = read_wav(wav)
    tuner = DetectorTuner(audio, sr, device="cpu")
    tuner.values.update(values)
    t0 = time.perf_counter()
    ch, on, groups = tuner.detect()
    out.put(dict(channels=np.asarray(ch), onsets=np.asarray(on),
                 groups=groups, seconds=time.perf_counter() - t0))


def start_tuner_reference():
    """Start 9a's CPU references, one child process per slider setting (6b's
    recording must exist)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    refs = []
    for values in TUNER_SETTINGS:
        q = ctx.Queue()
        p = ctx.Process(target=tuner_cpu_reference, args=(
            str(J_DIR / "train_patch" / "train_patch.wav"), values, q),
            daemon=True)
        p.start()
        refs.append((p, q))
    return refs


def phase_tuner(report, tuner_ref):
    """9a: ``DetectorTuner`` on the card over 6b's recording at each of
    TUNER_SETTINGS: channels, onsets and groups equal to the tuner on the
    CPU (child processes from phase 0), two K1 launches per detect() and no
    plain call, one detect() timed by the host clock.  Returns the
    tuner."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools.choose_od_settings import (
        DetectorTuner,
    )

    audio, sr = read_wav(J_DIR / "train_patch" / "train_patch.wav")
    tuner = DetectorTuner(audio, sr)
    defaults = dict(tuner.values)
    _cuda.reset_counts()
    secs = []
    for values, ref in zip(TUNER_SETTINGS, tuner_ref):
        tuner.values = dict(defaults, **values)
        before = _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"]
        t0 = time.perf_counter()
        ch, on, groups = tuner.detect()
        secs.append(time.perf_counter() - t0)
        got = _cuda.DETECTOR_PIPE_COUPLED.variants["coupled"] - before
        check(got == 2, f"9a: detect() launched the coupled pipe {got} "
              "times, want 2")
        want = wait_cpu_reference(*ref)
        same = (np.array_equal(np.asarray(ch), want["channels"])
                and np.array_equal(np.asarray(on), want["onsets"])
                and (groups is None) == (want["groups"] is None)
                and (groups is None
                     or np.array_equal(groups, want["groups"])))
        log(f"9a: tuner {values or 'defaults'}: {len(on)} onsets, "
            f"{0 if groups is None else len(groups)} groups on the card; "
            f"the CPU's {len(want['onsets'])} onsets in "
            f"{want['seconds']:.1f} s; equal: {same}")
        check(same, f"9a: the tuner on the card differs from the CPU at "
              f"{values or 'the defaults'}")
    # the slider-change latency, warm, at the defaults
    tuner.values = dict(defaults)
    t0 = time.perf_counter()
    tuner.detect()
    lat = time.perf_counter() - t0
    counts = {k.name: (k.launches, k.plain_calls) for k in _cuda.KERNELS}
    k1 = _cuda.DETECTOR_PIPE_COUPLED
    check(all(k.plain_calls == 0 for k in _cuda.KERNELS)
          and k1.launches == 2 * (len(TUNER_SETTINGS) + 1)
          and all(k.launches == 0 for k in _cuda.KERNELS if k is not k1),
          f"9a: want K1 coupled-pipe launches only, 2 per detect(): "
          f"{counts}")
    add_launches(report, ("detector_pipe_coupled",),
                 {"detector_pipe_coupled": k1.launches})
    log(f"9a: {audio.shape} recording; detect() host time per setting "
        f"{[round(1e3 * s, 3) for s in secs]} ms (the first cold); a slider "
        f"change at the defaults, warm: {1e3 * lat:.3f} ms (host clock, "
        f"two K1 launches on the coupled pipe, onset grouping)")
    return tuner


def phase_trace(tuner):
    """9b: ``utils.metrics.profile_trace`` on the card around one tuner
    detect() under ``trace("tuner.detect", metrics)`` and TRACE_STEPS engine
    steps: the written Chrome trace names the span and K1's kernel, and the
    Metrics hold the span's observation."""
    import shutil

    from onset_fingerprinting_torch.tools import realtime_sim as sim
    from onset_fingerprinting_torch.utils.metrics import (
        Metrics,
        profile_trace,
        trace,
    )

    audio, _, _ = sim.synth_stream(1.0, 0)
    eng = sim.build_engine(None)
    eng.warmup(audio[: sim.WARMUP])
    metrics = Metrics()
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with profile_trace(TRACE_DIR):
        with trace("tuner.detect", metrics):
            tuner.detect()
        for blk in sim.blocks_of(audio)[:TRACE_STEPS]:
            eng.process_nosync(blk)
    files = sorted(TRACE_DIR.glob("*.pt.trace.json"))
    check(len(files) == 1, f"9b: want one trace file, got {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    spans = [e for e in events if e.get("name") == "tuner.detect"]
    k1 = [n for n in kernels if "detector_warp_kernel" in n]
    pipe = [n for n in kernels if "detector_pipe_kernel" in n]
    obs = metrics.summary()["latency"].get("tuner.detect", {})
    log(f"9b: {files[0].name} ({files[0].stat().st_size} B): "
        f"{len(events)} events, {len(kernels)} kernel events "
        f"({sorted(set(kernels))[:6]}), {len(spans)} 'tuner.detect' spans; "
        f"Metrics: {obs}")
    check(kernels, "9b: the trace holds no CUDA kernel event (CUPTI)")
    log(f"9b: K1's kernels in the trace: the steps' warp kernel "
        f"{len(k1)} times, the tuner's coupled pipe {len(pipe)} times "
        "(CUPTI may drop the first launches of a trace)")
    check(spans and k1, "9b: the trace does not name the span and K1")
    check(obs.get("count") == 1, "9b: Metrics did not observe the span")


def phase_serve(report):
    """9c: the serve loop as a user runs it, ``python -m
    onset_fingerprinting_torch.tools.realtime_sim --serve --seconds
    SERVE_RT_SECONDS``, in a child process: realtime pacing over the demo's
    stream with every card gate; K1, the ring write and the locate kernel
    launched on every served block and once more for the engine's first
    step (run on a copy before its graph is captured), K1 once more for the
    warmup, no plain call (the child's counts, from 0 at its start)."""
    proc = subprocess.run(
        [sys.executable, "-m", "onset_fingerprinting_torch.tools.realtime_sim",
         "--serve", "--seconds", str(SERVE_RT_SECONDS)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith('{"serve"'):
            log("9c:", line)
    check(proc.returncode == 0 and lines and lines[-1] == "PASS",
          f"9c: the serve loop failed (exit {proc.returncode}): "
          f"{proc.stderr[-3000:]}")
    res = json.loads(next(ln for ln in lines if ln.startswith('{"serve"')))
    s, counts = res["serve"], res["launches"]
    log("9c: " + json.dumps({k: v for k, v in s.items()
                              if not isinstance(v, list)}))
    n = s["blocks"]
    check(all(plain == 0 for _, plain in counts.values())
          and counts["detector_warp"][0] == n + 1
          and counts["detector_pipe_coupled"][0] == 1
          and res["ring_writes"] == n + 1
          and counts["locate_block"][0] == n + 1,
          f"9c: want {n} served blocks' launches + the first step's (each "
          f"locate launch with the ring write: {res['ring_writes']}), and "
          f"the warmup's on the coupled pipe: {counts}")
    add_launches(report, ("detector_warp", "ring_write", "locate_block",
                          "detector_pipe_coupled"),
                 {"ring_write": res["ring_writes"],
                  **{k: v[0] for k, v in counts.items()}})


def phase9(report, tuner_ref, phase):
    phase("phase 9a: the detector tuner on the card")
    tuner = phase_tuner(report, tuner_ref)
    phase("phase 9b: profile_trace around the tuner and the engine")
    phase_trace(tuner)
    del tuner
    phase("phase 9c: the serve loop at realtime pacing")
    phase_serve(report)


# -- phase 10: the examples' twins -----------------------------------------

#: 10c/10d: located points against the CPU's (cm)
EX_POINT_TOL = 1e-3


def examples_cpu_reference(out):
    """10c's and 10d's references, in a child process beside 10a and 10b:
    ``tools.fleet_detect`` and ``tools.e2e_locate`` at the examples'
    defaults with the plain versions on the CPU."""
    from onset_fingerprinting_torch.tools import e2e_locate, fleet_detect

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    e = e2e_locate.run(device="cpu", log=lambda *a: None)
    t1 = time.perf_counter()
    f = fleet_detect.run(device="cpu", log=lambda *a: None)
    out.put(dict(
        e2e=dict(channels=np.asarray(e["channels"]),
                 onsets=np.asarray(e["onsets"]), groups=e["groups"],
                 results=e["results"], seconds=t1 - t0),
        fleet=dict(on=f["on"], deltas=f["deltas"], located=f["located"],
                   seconds=time.perf_counter() - t1),
        cpu_seconds=time.process_time()))


def start_examples_reference():
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=examples_cpu_reference, args=(q,), daemon=True)
    p.start()
    return p, q


def check_launches(step, want, report):
    """The step's launches are exactly ``want`` (kernel name -> launches)
    with no plain call anywhere; they join the kernels line's counts."""
    from onset_fingerprinting_torch.ops import _cuda

    got = {k.name: k.launches for k in _cuda.KERNELS if k.launches}
    plain = {k.name: k.plain_calls for k in _cuda.KERNELS if k.plain_calls}
    log(f"{step} launches {got}, plain calls {plain}")
    check(got == want and not plain, f"{step}: launches {got} (want "
          f"{want}), plain calls {plain}")
    add_launches(report, got, got)


def points_close(card, cpu):
    """Two lists of ``(onset, x, y, ...)``: the same onsets, the points
    within EX_POINT_TOL cm."""
    return (len(card) == len(cpu)
            and all(a[0] == b[0] for a, b in zip(card, cpu))
            and all(np.abs(np.subtract(a[1:3], b[1:3])).max()
                    <= EX_POINT_TOL for a, b in zip(card, cpu)))


def check_session_k1(fix, anch):
    """10a's K1 output over the session (the coupled pipe's warmup and
    detection launches) against ``detector_warp.cu`` named over the same
    tensor, which phase 1 holds to the plain detector: channels, onsets
    and rel bit for bit, then the anchors taken from both."""
    from onset_fingerprinting_torch.detect.amplitude import offline_detector
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.fused_detector import _launch
    from onset_fingerprinting_torch.tools import serving_window_accuracy as swa

    fst, params, st0 = offline_detector(fix.audio.shape[1], sr=swa.SR)
    x = torch.as_tensor(np.ascontiguousarray(fix.audio, np.float32),
                        device="cuda")
    warm = min(swa.SR // 2, len(x)) // 128 * 128
    t = len(x) // 128 * 128
    st = _launch(fst, params, st0, x[:warm].contiguous(), False, True,
                 _cuda.DETECTOR_WARP)[0]
    _, (on, deltas, rel) = _launch(fst, params, st, x[:t].contiguous(),
                                   True, False, _cuda.DETECTOR_WARP)
    on, deltas = on.cpu().numpy(), deltas.cpu().numpy()
    blocks, chans = np.nonzero(on)
    order = np.argsort(blocks, kind="stable")
    onsets = blocks[order] * 128 + deltas[blocks[order], chans[order]]
    det = anch["detected"]
    same = (np.array_equal(np.asarray(det["channels"]), chans[order])
            and np.array_equal(np.asarray(det["onsets"]), onsets)
            and np.array_equal(det["rel"], rel.cpu().numpy()))
    anchors, missed = swa.anchors_from_onsets(
        onsets, fix.onsets[fix.test_mask])
    log(f"10a K1 over the session [{warm}, {x.shape[1]}] + [{t}, "
        f"{x.shape[1]}] ({len(onsets)} onsets) against detector_warp.cu on "
        f"the same tensor: channels, onsets and rel "
        f"{'bit-identical' if same else 'DIFFER'}; anchors "
        f"{'equal' if np.array_equal(anchors, anch['anchors']) else 'DIFFER'}")
    check(same and np.array_equal(anchors, anch["anchors"])
          and missed == anch["missed"],
          "10a: K1 over the session differs from detector_warp.cu")


def phase_serving_windows(report):
    """10a: ``tools.serving_window_accuracy.run`` at the example's defaults
    (512 hits, 1500 epochs): K1 twice on the coupled pipe (warmup, session)
    and K2 once on ``gather_vec.cu`` at cps 4, nothing else (the CCCNNs'
    GroupNorm stacks are the cuDNN chain, not K3), no plain call; the
    anchored windows exact slices of the session at the anchors; the
    example's gate."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import serving_window_accuracy as swa

    _cuda.reset_counts()
    t0 = time.perf_counter()
    res = swa.run(log=lambda *a: log("10a", *a))
    secs = time.perf_counter() - t0
    check_launches("10a", {"detector_pipe_coupled": 2, "gather_vec": 1},
                   report)
    anch, fix = res["anchored"], res["fixture"]
    route = anch["route"]
    log(f"10a K2 route: {route.kernel.source} ({route.variant}); "
        f"K1 {dict(_cuda.DETECTOR_PIPE_COUPLED.variants)}")
    check(route.kernel is _cuda.GATHER_VEC
          and dict(_cuda.GATHER_VEC.variants) == {"cps4": 1}
          and dict(_cuda.DETECTOR_PIPE_COUPLED.variants) == {"coupled": 2},
          "10a: K1 or K2 took another route")
    check_session_k1(fix, anch)
    rows = np.clip(anch["anchors"] - swa.PRE, 0,
                   fix.audio.shape[0] - swa.W - 8)
    want = np.transpose(fix.audio[rows[:, None] + np.arange(swa.W)],
                        (0, 2, 1))
    check(np.array_equal(anch["windows"].cpu().numpy(), want),
          "10a: the anchored windows are not the session's slices")
    log(f"10a anchored windows {tuple(want.shape)} equal exact slices at "
        f"the anchors; {anch['missed']} test hits undetected; the anchors "
        f"{np.abs(anch['anchors'] - fix.onsets[fix.test_mask]).max()} "
        "samples from the labels at most")
    swa.report(res, log=lambda *a: log("10a", *a))
    s = res["seconds"]
    per_step = 1e3 * (s["train_a"] + s["train_b"]) / res["steps"]
    log(f"10a host seconds (synchronised): detection + anchored gather "
        f"{s['anchored']:.3f}, model A {s['train_a']:.2f}, model B "
        f"{s['train_b']:.2f} ({per_step:.3f} ms per step over "
        f"{res['steps']} steps and the validations), the whole run "
        f"{secs:.1f}")
    anch_ok, legacy_ok = swa.gate(res)
    check(anch_ok, f"10a: anchored {res['a_anch']:.4f} >= 1.1 x exact "
          f"{res['a_exact']:.4f}")
    check(legacy_ok, f"10a: B {res['b_serv']:.4f} misses 2 x A exact or a "
          f"quarter of the floor {res['floor']:.4f}")


def phase_hpo(report):
    """10b: ``tools.location_hpo.run`` at the example's defaults (the modal
    fixture, 48 hits, 2 TPE trials x 300 epochs): no hand-written kernel
    and no plain call; a complete trial and a finite best validation
    L1."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import location_hpo

    _cuda.reset_counts()
    res = location_hpo.run(log=lambda *a: log("10b", *a))
    check_launches("10b", {}, report)
    study = res["study"]
    log(f"10b best val L1 {study.best_value:.4f} cm, the selected trial's "
        f"test L1 {study.best_trial.user_attrs.get('test_l1')}; "
        f"{res['seconds']:.2f} s for the study (host clock)")
    check(location_hpo.gate(res), f"10b: trial states {res['states']}")


def phase_fleet(report, ref):
    """10c: ``tools.fleet_detect.run`` at the example's defaults (8 streams
    of 1 s on ``parallel.default_mesh``, one rank): one K1 launch on the
    pipe (the 8 streams folded into 24 per-channel lanes), nothing else,
    no plain call; dense events equal to the plain detector on the CPU
    and each located point within EX_POINT_TOL of the CPU's
    (``examples_cpu_reference``); the example's gate."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import fleet_detect

    _cuda.reset_counts()
    res = fleet_detect.run(log=lambda *a: log("10c", *a))
    check_launches("10c", {"detector_pipe": 1}, report)
    same = (np.array_equal(res["on"], ref["on"])
            and np.array_equal(res["deltas"], ref["deltas"]))
    close = all(points_close(a, b)
                for a, b in zip(res["located"], ref["located"]))
    s = res["seconds"]
    log(f"10c against the CPU ({ref['seconds']:.1f} s there): on/deltas "
        f"{'equal' if same else 'DIFFER'}, located points "
        f"{'within' if close else 'NOT within'} {EX_POINT_TOL} cm; host "
        f"seconds: detection {s['detect']:.4f}, locate {s['locate']:.4f}, "
        f"POSD save {s['save']:.4f}")
    check(same and close, "10c: the fleet's events differ from the CPU's")
    check(fleet_detect.gate(res), f"10c: {res['matched']}/{res['n_hits']} "
          f"within 2 cm, {res['sessions']} sessions")


def phase_e2e(report, ref):
    """10d: ``tools.e2e_locate.run`` at the example's defaults (8 hits, 3
    sensors): K1 twice on the coupled pipe (warmup, recording), nothing
    else, no plain call; the channels, onsets and groups equal to the
    plain detector's on the CPU (``examples_cpu_reference``), the located
    points within EX_POINT_TOL; the example's gate."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import e2e_locate

    _cuda.reset_counts()
    res = e2e_locate.run(log=lambda *a: log("10d", *a))
    check_launches("10d", {"detector_pipe_coupled": 2}, report)
    check(dict(_cuda.DETECTOR_PIPE_COUPLED.variants) == {"coupled": 2},
          "10d: K1 took another instantiation")
    same = (np.array_equal(np.asarray(res["channels"]), ref["channels"])
            and np.array_equal(np.asarray(res["onsets"]), ref["onsets"])
            and np.array_equal(res["groups"], ref["groups"]))
    close = points_close([(o, *p) for o, p in res["results"]],
                         [(o, *p) for o, p in ref["results"]])
    errs = res["errs"]
    s = res["seconds"]
    log(f"10d matched {len(errs)}/{len(res['truths'])} hits, median error "
        f"{np.median(errs):.4f} cm (max {errs.max():.4f}); against the CPU "
        f"({ref['seconds']:.1f} s there): events and groups "
        f"{'equal' if same else 'DIFFER'}, points "
        f"{'within' if close else 'NOT within'} {EX_POINT_TOL} cm; host "
        f"seconds: detection {s['detect']:.4f}, grouping {s['group']:.4f}, "
        f"locate {s['locate']:.4f}")
    check(same and close, "10d: the events differ from the CPU's")
    check(e2e_locate.gate(res), "10d: the example's gate failed")


def phase_calibration_run(report):
    """10e: ``tools.calibration_run.run``, all four stages at the example's
    defaults on the card: no hand-written kernel and no plain call; the
    residual, the FCNN's train-set error and the reload's bars."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools import calibration_run as cal

    _cuda.reset_counts()
    res = cal.run(log=lambda *a: log("10e", *a))
    check_launches("10e", {}, report)
    s3 = res["stage3"]
    s = res["seconds"]
    log(f"10e host seconds on the card: calibrate {s[0]:.3f}, "
        f"optimize_positions {s[1]:.3f}, FCNN {s3['seconds']:.3f} "
        f"({len(s3['errors'])} epochs, "
        f"{1e3 * s3['seconds'] / len(s3['errors']):.3f} ms each); the FCNN "
        f"{s3['err_mm']:.4f} mm")
    check(cal.gate(res), f"10e: residual {res['resid']:.4f}, FCNN "
          f"{s3['err_mm']:.4f} mm, reload {res['stage4']['diff']:.3g}")


def phase_cc_bench(report):
    """10f: ``tools.cc_bench.run`` at the example's defaults (n 256, blocks
    of 64, 2000 blocks, 64 pairs): no TPU kernel computes it and no
    hand-written kernel runs; |CC - np.correlate| under 1e-3 on every 50th
    block; the scan's CCs within 1e-4 of their scale of the CPU's."""
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.xcorr import (
        streaming_cc_init,
        streaming_cc_scan,
    )
    from onset_fingerprinting_torch.tools import cc_bench

    _cuda.reset_counts()
    res = cc_bench.run(log=lambda *a: log("10f", *a))
    check_launches("10f", {}, report)
    ab, bb = cc_bench.pair_streams(*cc_bench.signals(64 * 2000), 64)
    t0 = time.perf_counter()
    _, ccs = streaming_cc_scan(streaming_cc_init(256, (64,), "cpu"),
                               *cc_bench.blocks(ab, bb, 64))
    t_cpu = time.perf_counter() - t0
    err = scale_err(res["ccs"].cpu(), ccs)
    s = res["seconds"]
    log(f"10f host seconds (plain PyTorch on the card): per-block dispatch "
        f"{s['per_block']:.3f} ({1e3 * s['per_block'] / 2000:.4f} ms a "
        f"block), scan {s['scan']:.3f}; numpy {s['numpy']:.3f}, the scan on "
        f"the CPU {t_cpu:.3f}; the scan against the CPU {err:.3g} of its "
        "scale (bound 1e-4)")
    check(cc_bench.gate(res), f"10f: max |err| {res['max_err']}")
    check(err <= 1e-4, "10f: the scan on the card differs from the CPU")


def phase10(report, phase):
    """10a-10f; 10c's and 10d's CPU references run in a child process
    beside 10a and 10b, so none runs beside 9c's realtime pacing."""
    ex_ref = start_examples_reference()
    phase("phase 10a: serving-window accuracy")
    phase_serving_windows(report)
    torch.cuda.empty_cache()
    phase("phase 10b: the location HPO study")
    phase_hpo(report)
    t_wait = time.perf_counter()
    ex = wait_cpu_reference(*ex_ref)
    log(f"10c waited {time.perf_counter() - t_wait:.1f} s for the CPU "
        f"references ({ex['cpu_seconds']:.1f} s of CPU time in the child)")
    phase("phase 10c: fleet detection")
    phase_fleet(report, ex["fleet"])
    phase("phase 10d: detect, group, locate")
    phase_e2e(report, ex["e2e"])
    phase("phase 10e: calibration, stages 1-4")
    phase_calibration_run(report)
    phase("phase 10f: streaming CC")
    phase_cc_bench(report)
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    """``--only-phase6`` / ``--only-phase7`` / ``--only-phase8`` run the
    build and that phase alone and print their rows of the kernels line,
    ``--only-phase9`` / ``--only-phase10`` that phase's launches, without
    the last line (for iterating on one phase; the smoke run takes no
    arguments); ``--only-head`` the build, 2c and the realtime classify
    call, and the head kernel's row."""
    argv = sys.argv[1:] if argv is None else argv
    only6 = "--only-phase6" in argv
    only7 = "--only-phase7" in argv
    only8 = "--only-phase8" in argv
    only9 = "--only-phase9" in argv
    only10 = "--only-phase10" in argv
    only_head = "--only-head" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.workload import make_audio

    t0 = time.perf_counter()
    last = [t0]

    def phase(name):
        now = time.perf_counter()
        log(f"[{now - t0:.1f} s] {name} (the phase before it: "
            f"{now - last[0]:.1f} s)")
        last[0] = now

    # the plain engine and the plain mining detector on the CPU, beside the
    # card phases
    only = only6 or only7 or only8 or only9 or only10 or only_head
    cpu_ref = None if only else start_cpu_reference()
    cc_ref = (None if (only6 or only7 or only9 or only10 or only_head)
              else start_cc_reference())
    if only8 or only9:  # 8b's and 9a's recording only
        import shutil

        shutil.rmtree(J_DIR, ignore_errors=True)
        journey_session("train_patch", 48, 3)
        mine_ref = None
    elif only10 or only_head:
        mine_ref = None
    else:
        mine_ref = start_mine_reference()
    amp_ref = (None if (only6 or only8 or only9 or only10 or only_head)
               else start_amp_reference())
    tuner_ref = (None if (only6 or only7 or only8 or only10 or only_head)
                 else start_tuner_reference())
    logs = _cuda.build()
    log(f"built {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    report = {"_launches": {}, "_sharded": {}}
    if only_head:
        phase("phase 2c: the head kernel")
        phase_head(report)
        classify_call(report)
        phase("done")
        log(smi)
        log(json.dumps({"kernels": kernel_rows(report, ("cccnn_head",))}))
        return 0
    if only10:
        phase10(report, phase)
        phase("done")
        log(smi)
        log(json.dumps({"phase10_launches": report["_launches"]}))
        return 0
    if only9:
        phase9(report, tuner_ref, phase)
        phase("done")
        log(smi)
        log(json.dumps({"phase9_launches": report["_launches"]}))
        return 0
    if only8:
        from onset_fingerprinting_torch.tools.fingerprint_capability import (
            make_fixture,
        )

        phase8(report, cc_ref, make_fixture(CAP_HITS), phase)
        log(smi)
        log(json.dumps({"kernels": kernel_rows(report, (
            "detector_warp_streams", "locate_streams",
            "locate_block_cc_refine", "detector_pipe_coupled_streams"))}))
        return 0
    if only6:
        phase6(report, mine_ref, phase)
        log(smi)
        log(json.dumps({"kernels": kernel_rows(report, (
            "detector_warp_mining", "locate_block_fcnn",
            "locate_block_fcnn_wide", "detector_pipe_coupled"))}))
        return 0
    if only7:
        from onset_fingerprinting_torch.tools.fingerprint_capability import (
            make_fixture,
        )

        phase7(report, amp_ref, make_fixture(CAP_HITS).x_train, phase)
        log(smi)
        log(json.dumps({"kernels": kernel_rows(report, (
            "conv_stack_f32_imported",))}))
        return 0
    phase("phase 1: kernels against their plain versions")
    phase_detector(report)
    x = make_audio(CHUNK, N_STREAMS * 4, seed=4)
    windows = phase_gather(report, x)
    del x
    phase_conv(report, windows)
    del windows
    torch.cuda.empty_cache()
    phase("phase 2: the fleet path")
    phase_main_path(report)
    torch.cuda.empty_cache()
    phase("phase 2c: the head kernel")
    phase_head(report)
    torch.cuda.empty_cache()
    phase("phase 2b: the fleet path with the float32 flagship")
    phase_main_path(report, torch.float32, ITERS_F32, profile=False)
    torch.cuda.empty_cache()
    phase("phase 3: the fingerprint-stage anatomy")
    phase_anatomy(report)
    torch.cuda.empty_cache()
    phase("phase 4: the realtime engine")
    phase_realtime(report, cpu_ref)
    torch.cuda.empty_cache()
    phase("phase 5a: K3 under autograd at the training shape")
    phase_train_k3(report)
    torch.cuda.empty_cache()
    phase("phase 5c: the fingerprint-capability run")
    fix = phase_capability(report)
    phase("phase 5b: the float32 flagship on the card against the CPU")
    phase_train_parity(fix)
    torch.cuda.empty_cache()
    phase6(report, mine_ref, phase)
    torch.cuda.empty_cache()
    phase7(report, amp_ref, fix.x_train, phase)
    torch.cuda.empty_cache()
    phase8(report, cc_ref, fix, phase)
    torch.cuda.empty_cache()
    phase9(report, tuner_ref, phase)
    torch.cuda.empty_cache()
    phase10(report, phase)
    phase("done")
    log(smi)  # again here: a tool that keeps the output's end keeps it
    log(json.dumps({"kernels": kernel_rows(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def phase6(report, mine_ref, phase):
    phase("phase 6a: the locate kernel with an FCNN")
    phase_locate_fcnn(report)
    phase("phase 6b: the journey on the card, arrival patch")
    phase_journey_patch(report, mine_ref)
    torch.cuda.empty_cache()
    phase("phase 6c: the journey on the card, full head (by_channel)")
    phase_journey_head(report)
    phase("phase 6d: calibration on the card")
    phase_calibration(report)


def kernel_rows(report, names=None):
    """The ``kernels`` line's rows (all, or those in ``names``)."""
    # row: (source, TPU kernel, launch counter)
    sources = {
        "detector": ("onset_fingerprinting_torch/csrc/detector_pipe.cu",
                     "onset_fingerprinting_tpu/ops/pallas_detector.py:85",
                     "detector_pipe"),
        "detector_coupled": ("onset_fingerprinting_torch/csrc/detector.cu",
                             "onset_fingerprinting_tpu/ops/pallas_detector.py"
                             ":85", "detector"),
        "detector_warp": ("onset_fingerprinting_torch/csrc/detector_warp.cu",
                          "onset_fingerprinting_tpu/ops/pallas_detector.py"
                          ":85", "detector_warp"),
        "gather": ("onset_fingerprinting_torch/csrc/gather.cu",
                   "onset_fingerprinting_tpu/ops/windows.py:136", "gather"),
        "gather_vec": ("onset_fingerprinting_torch/csrc/gather_vec.cu",
                       "onset_fingerprinting_tpu/ops/windows.py:136",
                       "gather_vec"),
        "conv_stack_mma": ("onset_fingerprinting_torch/csrc/conv_stack_mma.cu",
                           "onset_fingerprinting_tpu/ops/pallas_conv.py:187",
                           "conv_stack_mma"),
        # the classifier's K3 on the cluster kernel, and the fleet's
        # kernel at that shape, which no path launches
        "conv_stack_mma_classifier": (
            "onset_fingerprinting_torch/csrc/conv_stack_mma_cluster.cu",
            "onset_fingerprinting_tpu/ops/pallas_conv.py:187", "classifier"),
        "conv_stack_mma_classifier_pr3": (
            "onset_fingerprinting_torch/csrc/conv_stack_mma.cu",
            "onset_fingerprinting_tpu/ops/pallas_conv.py:187",
            "classifier_pr3"),
        "conv_stack_f32": ("onset_fingerprinting_torch/csrc/conv_stack.cu",
                           "onset_fingerprinting_tpu/ops/pallas_conv.py:187",
                           "conv_stack"),
        "gather_roll": ("onset_fingerprinting_torch/csrc/gather_roll.cu",
                        "onset_fingerprinting_tpu/ops/windows.py:187",
                        "gather_roll"),
        "gather_roll_vec": ("onset_fingerprinting_torch/csrc/"
                            "gather_roll_vec.cu",
                            "onset_fingerprinting_tpu/ops/windows.py:187",
                            "gather_roll_vec"),
        # no TPU kernel: the JAX engine's locate loop, which XLA fuses
        "locate_block": ("onset_fingerprinting_torch/csrc/locate_block.cu",
                         "onset_fingerprinting_tpu/realtime/engine.py:249",
                         "locate_block"),
        # no TPU kernel either: the JAX engine's ring scatter, inside the
        # locate launch (its time: the launch with it less the launch
        # without it; its launches: the locate launches that wrote the ring)
        "ring_write": ("onset_fingerprinting_torch/csrc/locate_block.cu",
                       "onset_fingerprinting_tpu/core/ring_buffer.py:68",
                       "ring_write"),
        # K1 at the mining shape: one launch over a whole recording
        "detector_warp_mining": (
            "onset_fingerprinting_torch/csrc/detector_warp.cu",
            "onset_fingerprinting_tpu/ops/pallas_detector.py:85",
            "detector_warp_mining"),
        # the locate kernel with the learned locator (phase 6), and with a
        # wide one (128, 128), past the plan's old bounds
        "locate_block_fcnn": ("onset_fingerprinting_torch/csrc/"
                              "locate_block.cu",
                              "onset_fingerprinting_tpu/locate/"
                              "multilaterate.py:789", "locate_block_fcnn"),
        "locate_block_fcnn_wide": ("onset_fingerprinting_torch/csrc/"
                                   "locate_block.cu",
                                   "onset_fingerprinting_tpu/locate/"
                                   "multilaterate.py:789",
                                   "locate_block_fcnn_wide"),
        # K3 f32 serving an imported reference CCCNN (phase 7c)
        "conv_stack_f32_imported": (
            "onset_fingerprinting_torch/csrc/conv_stack.cu",
            "onset_fingerprinting_tpu/ops/pallas_conv.py:187",
            "conv_stack_f32_imported"),
        # K1 over a batch of streams, one CTA each (phase 8c)
        "detector_warp_streams": (
            "onset_fingerprinting_torch/csrc/detector_warp.cu",
            "onset_fingerprinting_tpu/ops/pallas_detector.py:85",
            "detector_warp_streams"),
        # no TPU kernel: the sharded serve path's lax.scan of the locate
        # update (phase 8c)
        "locate_streams": ("onset_fingerprinting_torch/csrc/locate_block.cu",
                           "onset_fingerprinting_tpu/parallel/sharding.py"
                           ":655", "locate_streams"),
        # no TPU kernel: the locate step with CC refinement (phase 8d)
        "locate_block_cc_refine": (
            "onset_fingerprinting_torch/csrc/locate_block.cu",
            "onset_fingerprinting_tpu/locate/multilaterate.py:661",
            "locate_block_cc_refine"),
        # K1 coupled over a long signal: the pipe's coupled instantiation,
        # one recording (mining's shape) and a batch of streams (8c)
        "detector_pipe_coupled": (
            "onset_fingerprinting_torch/csrc/detector_pipe.cu",
            "onset_fingerprinting_tpu/ops/pallas_detector.py:85",
            "detector_pipe_coupled"),
        "detector_pipe_coupled_streams": (
            "onset_fingerprinting_torch/csrc/detector_pipe.cu",
            "onset_fingerprinting_tpu/ops/pallas_detector.py:85",
            "detector_pipe_coupled_streams"),
        # no TPU kernel: XLA runs the JAX package's DFT head
        # (models/cccnn.py:479); timed at the fleet's call (2c)
        "cccnn_head": ("onset_fingerprinting_torch/csrc/cccnn_head.cu",
                       "onset_fingerprinting_tpu/models/cccnn.py:479",
                       "cccnn_head"),
    }
    kernels = []
    for name, (src, replaces, counter) in sources.items():
        if names is not None and name not in names:
            continue
        r = report[name]
        t_bytes = 1e3 * r["bytes"] / HBM_BPS
        t_ops = 1e3 * r["ops"] / r["peak"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=report["_launches"].get(counter, 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=r["library_ms"],
        ))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
