"""K3 f32 (``conv_stack.cu``, the CUDA-core kernel) as a share of its
roofline: the conv stack's operations on the signals that a call's real
items need (every channel of each real hit; not the empty slots of the
capacity that the kernel runs over) at 67 TFLOP/s float32, or their bytes
at 3.35 TB/s, the larger, over the kernel's device time per call, in %.
``conv_stack_kernel`` names neither tensor-core kernel."""

from portbench import flops


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    sec, n = ctx.trace.kernel_seconds("conv_stack_kernel")
    if not n:
        return None
    m = ctx.shapes["model"]
    bound, _ = flops.roofline_ms(
        flops.conv_stack_work(ctx.items_per_call * m["channels"],
                              m["window"], m["layer_sizes"],
                              m["kernel_sizes"], m.get("padding", 1)),
        flops.F32_FLOPS)
    return 100.0 * bound / (1e3 * sec / ctx.calls)
