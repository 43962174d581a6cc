"""The whole step's share of the card's bf16 peak: the CCCNN forward's
operations (counted from shapes) for the real hits (fleet) or the strikes
(drum) of every call, over the traced window's wall time at 989 TFLOP/s,
in %."""

from portbench import flops


def read(ctx):
    if not ctx.calls:
        return None
    per = flops.cccnn_forward_flops(ctx.shapes["model"])
    done = per * ctx.items_per_call * ctx.calls
    return 100.0 * done / ctx.window_s / flops.BF16_FLOPS
