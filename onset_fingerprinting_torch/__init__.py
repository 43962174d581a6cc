"""onset_fingerprinting_torch — the PyTorch/CUDA port of
``onset_fingerprinting_tpu``.

The layout mirrors the JAX package so that each module's counterpart is
found under the same path:

- ``core``     — the configuration tree (a jax-free copy).
- ``ops``      — IIR filters, hit lists and window gathers, DFT
                 correlations, and the five hand-written Hopper kernels
                 (``ops/_cuda.py`` builds ``csrc/*.cu`` with ``nvcc``):
                 the fused detector, the window gather, the fused conv
                 stack (bf16 on the tensor cores, f32 on the CUDA cores)
                 and the roll gather.
- ``detect``   — the amplitude onset detector in plain PyTorch (the
                 reference the detector kernel is held against).
- ``models``   — the CCCNN fingerprint model and the flax-params importer.
- ``workload`` — the injected-hit fleet workload and its recall/precision
                 gate.
- ``pipeline`` — the offline detect → fingerprint fleet path.
- ``tools``    — ``fingerprint_anatomy``: per-component times of the
                 fingerprint stage on the card; ``conv_stack_gate``: the
                 bf16 conv stack's parity gate and its calibration.

Every entry point takes ``device=None``, which means ``"cuda"``; without a
card it raises instead of running on the CPU.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels (the tests do).  The package
never imports jax.
"""

__version__ = "0.1.0"
