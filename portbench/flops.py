"""Operations and bytes of the algorithms, counted from their shapes and
never from a kernel: a roofline share has to count the same work whatever
implements it.  Rule: every float add, subtract, multiply, divide,
compare, min/max (a clamp is two), absolute value, log2 and exp2 is one
operation; a multiply-add is two.  A selection between two computed
values is not an operation.  Bytes: every input read once, every output
written once.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
700 W).
"""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BPS = 3.35e12

#: one channel-sample of the detector's per-sample chains, from the plain
#: recurrence (reference/detector.py):
#: dB of the rectified sample: + eps, |.|, log2, × k, clamp at the floor
DB_OPS = 5
#: two envelope followers, each (x − y) + eps, > 0, × rate, + y; their
#: difference
ENVELOPE_OPS = 2 * 5 + 1
#: × k, exp2, − eps, clamp to [0, −floor]
REL_OPS = 5
#: min tracker: two compares and an EMA (×, ×, +); max tracker: a compare
#: and an EMA
MINMAX_OPS = 5 + 4
#: per sample of a block: rel > on, prev < on, rel < off
GATE_OPS = 3


def highpass_ops(order: int = 4) -> int:
    """Direct form II transposed, per sample: y = b0 x + z0 (2); each of
    the first order − 1 states b x + z − a y (4); the last b x − a y
    (3)."""
    return 2 + 4 * (order - 1) + 3


def detector_work(channels: int, samples: int, block: int,
                  hipass: bool) -> dict:
    """The detector over ``[samples, channels]``: operations, and bytes
    (float32 audio in; per block and channel a fire flag and an int32
    offset out)."""
    per = (DB_OPS + ENVELOPE_OPS + REL_OPS + MINMAX_OPS + GATE_OPS
           + (highpass_ops() if hipass else 0))
    # per block and channel: the two thresholds (2 multiply-adds)
    per_block = 4
    nb = samples // block
    ops = channels * (samples * per + nb * per_block)
    byt = channels * (samples * 4 + nb * (1 + 4))
    return dict(flops=float(ops), bytes=float(byt))


def out_length(length: int, kernels, padding: int = 1) -> int:
    v = length
    for k in kernels:
        v = v + 2 * padding - (k - 1)
    return v


def conv_stack_work(signals: int, length: int, widths, kernels,
                    padding: int = 1) -> dict:
    """The shared-weight conv stack on ``signals`` signals of ``length``
    samples: multiply-adds of every layer, the bias and the SiLU (x ·
    sigmoid: an exp, an add, a divide, a multiply) counted as 5 per
    output; bytes: float32 signals in, float32 ``[V, K]`` features out."""
    cin, v, ops = 1, length, 0
    for o, k in zip(widths, kernels):
        v = v + 2 * padding - (k - 1)
        ops += 2 * cin * o * k * v + 5 * o * v
        cin = o
    byt = signals * (length * 4 + v * widths[-1] * 4)
    return dict(flops=float(signals) * ops, bytes=float(byt))


def cccnn_forward_flops(model: dict) -> float:
    """One window through the CCCNN: the conv stack on every channel, the
    self correlation of every map at every lag by direct sums (K · V²
    multiply-adds a channel), the lag-0 normalisation, and the dense
    layer."""
    c, w = model["channels"], model["window"]
    kern = model["kernel_sizes"]
    conv = conv_stack_work(c, w, model["layer_sizes"], kern,
                           model.get("padding", 1))["flops"]
    v = out_length(w, kern, model.get("padding", 1))
    k = model["layer_sizes"][-1]
    corr = c * (2 * k * v * v)
    norm = c * (2 * v - 1 + 1)
    dense_in = c * (2 * v - 1) + c
    dense = 2 * dense_in * model["output_size"]
    return float(conv + corr + norm + dense)


def roofline_ms(work: dict, flops_peak: float) -> tuple[float, str]:
    """The least time the chip could take for ``work``, in ms, and which
    bound sets it."""
    t_ops = work["flops"] / flops_peak
    t_bytes = work["bytes"] / HBM_BPS
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
