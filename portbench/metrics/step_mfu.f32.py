"""The whole step's share of the card's float32 peak, the precision the
cell's configuration states: the CCCNN forward's operations (counted from
shapes) for the real hits of every call, over the traced window's wall
time at 67 TFLOP/s, in %."""

from portbench import flops


def read(ctx):
    if not ctx.calls:
        return None
    per = flops.cccnn_forward_flops(ctx.shapes["model"])
    done = per * ctx.items_per_call * ctx.calls
    return 100.0 * done / ctx.window_s / flops.F32_FLOPS
