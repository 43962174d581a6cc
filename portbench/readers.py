"""Readers that several per-layer metrics share.  A metric whose data file
``portbench/metrics/<name>.json`` names one (``{"reader": ..., ...}``) is
read by it, with the file's other keys but ``about`` as its arguments.
Each returns None where the run has nothing to read."""

from __future__ import annotations

from portbench import flops


def span_ms(ctx, span: str):
    """Mean device time per call of one of the program's stage methods,
    from the CUDA events the benchmark records around it, in ms."""
    return ctx.spans.get(span)


def kernel_ms(ctx, kernel: str):
    """Device time per call of the kernels whose name holds ``kernel``,
    from the profiler's events, in ms."""
    if ctx.trace is None or not ctx.calls:
        return None
    sec, n = ctx.trace.kernel_seconds(kernel)
    return 1e3 * sec / ctx.calls if n else None


def detector_roofline(ctx, kernel: str):
    """The detector kernel's share of its roofline: the least time of the
    detector's algorithm over a call's audio (operations at 67 TFLOP/s
    float32 or bytes at 3.35 TB/s, the larger) over the kernel's device
    time per call, in %."""
    ms = kernel_ms(ctx, kernel)
    if not ms:
        return None
    d = ctx.shapes["detector"]
    bound, _ = flops.roofline_ms(
        flops.detector_work(d["channels"], d["samples"], d["block"],
                            d["hipass"]), flops.F32_FLOPS)
    return 100.0 * bound / ms
