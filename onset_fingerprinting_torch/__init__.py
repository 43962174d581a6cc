"""onset_fingerprinting_torch — the PyTorch/CUDA port of
``onset_fingerprinting_tpu``.

The layout mirrors the JAX package so that each module's counterpart is
found under the same path:

- ``core``     — the configuration tree (a jax-free copy), coordinates,
                 ring buffers, WAV and POSD I/O (copies).
- ``data``     — the modal-drum synthesiser (a copy), onset-window
                 extraction and the MCPOSD location dataset.
- ``ops``      — IIR and median filters, hit lists and window gathers,
                 DFT correlations and lag pickers, and the hand-written
                 Hopper kernels (``ops/_cuda.py`` builds ``csrc/*.cu``
                 with ``nvcc``): the fused detector, the window gather,
                 the fused conv stack (bf16 on the tensor cores, f32 on
                 the CUDA cores), the roll gather, and the realtime
                 engine's locate step.
- ``detect``   — the amplitude onset detector in plain PyTorch (the
                 reference the detector kernel is held against) and its
                 host wrappers, onset grouping, CC onset refinement.
- ``locate``   — lag maps, TDOA trilateration, the online locators (with
                 the learned locator), sensor calibration and the
                 lag-FCNN's training.
- ``realtime`` — the per-block realtime engine (its step captured in a
                 CUDA graph), its classifier, location-triggered actions,
                 the analysis side channel, setup persistence and the
                 serve application (``realtime.main``).
- ``runtime_native`` — the native ring and block executor
                 (``csrc/ofrt.cpp``).
- ``models``   — the CCCNN, FCNN and CNN models, the flax-params and
                 reference-checkpoint importers, the trainer with optax's
                 optimizers, the hyperparameter search (a copy) and the
                 location-model experiment.
- ``workload`` — the injected-hit fleet workload and its recall/precision
                 gate.
- ``pipeline`` — the offline detect → fingerprint fleet path.
- ``tools``    — ``fingerprint_anatomy``: per-component times of the
                 fingerprint stage on the card; ``conv_stack_gate``: the
                 bf16 conv stack's parity gate and its calibration;
                 ``realtime_sim``: the realtime demo's stream through the
                 engine, and its serving stack at realtime pacing;
                 ``fingerprint_capability``: the location models trained
                 on the card against predict-the-mean;
                 ``mine_hits`` and ``train_setup``: recordings → POSD
                 sessions → a trained serve setup; ``choose_od_settings``:
                 the detector tuner; ``modify_hits`` and
                 ``modify_hits_mc``: the hit editors.
- ``utils``    — metrics and tracing (``Metrics``, ``trace``,
                 ``profile_trace``, ``TBWriter``), eval helpers and the
                 plots (matplotlib, imported on first use).

Every entry point takes ``device=None``, which means ``"cuda"``; without a
card it raises instead of running on the CPU.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels (the tests do).  The package
never imports jax.
"""

__version__ = "0.1.0"
