"""The CCCNN's float32 head (the DFT head's products, power and inverse,
``cc_norm``, ``fc``: cuBLAS and ATen on this path) as a share of its
roofline: the head's algorithm for a call's real hits (the forward's
operations less the conv stack's: the self correlation by direct sums,
the lag-0 normalisation, the dense layer) at 67 TFLOP/s float32, or the
float32 features it reads at 3.35 TB/s, the larger, over the head's
time per call: ``DetectFingerprint.predict``'s span (CUDA events) less
K3 f32's kernel time per call (profiler), in %."""

from portbench import flops


def read(ctx):
    if ctx.trace is None or not ctx.calls or "predict" not in ctx.spans:
        return None
    sec, n = ctx.trace.kernel_seconds("conv_stack_kernel")
    if not n:
        return None
    head_ms = ctx.spans["predict"] - 1e3 * sec / ctx.calls
    if head_ms <= 0:
        return None
    m = ctx.shapes["model"]
    pad = m.get("padding", 1)
    conv = flops.conv_stack_work(m["channels"], m["window"],
                                 m["layer_sizes"], m["kernel_sizes"], pad)
    v = flops.out_length(m["window"], m["kernel_sizes"], pad)
    items = ctx.items_per_call
    work = dict(flops=items * (flops.cccnn_forward_flops(m)
                               - conv["flops"]),
                bytes=items * m["channels"] * v * m["layer_sizes"][-1] * 4.0)
    bound, _ = flops.roofline_ms(work, flops.F32_FLOPS)
    return 100.0 * bound / head_ms
