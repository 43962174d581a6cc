"""K3's bf16 parity gate, its calibration on the card, and its witness.

A bf16 conv stack and its plain version share every rounding point, so
they part only where an f32 sum taken in another order falls on the other
side of a bf16 rounding boundary.  :func:`gate` lists the signals more
than about one bf16 ulp apart (``ops.conv_stack.far_signals``) and, for
each, asks :func:`witness` whether the kernel's output is the float64
emulation of the rounding points with at most one rounding flipped at a
near-tie.  ``chip_smoke.py`` and the card tests hold a bf16 run to
:func:`passes`: at most :func:`far_cap` far signals, at most
:func:`unexplained_limit` of them unexplained.

``main`` reads both sides of that gate at the flagship's shape (1 -> 5 x 7
features, kernels 1, 33, 64, 15, 15, 15, 1, L = 256, padding 1, silu):

- sound: the tensor-core kernel (``csrc/conv_stack_mma.cu``) on 64
  draws of the flagship's random weights (``workload.flagship_flax_params``),
  biases and unit-normal input;
- planted fault: the same source built with each layer's zeroing of the
  next layer's window tail moved in front of the barrier that waits for the
  layer before, a race in which slow warps of that layer may read those
  rows as zeros.  The copy is written to the build directory, never to
  ``csrc/``.

It saves every far signal of the sound kernel (:func:`save_far`) and exits
1 unless the gate passes every sound draw and catches every planted one at
131072 signals (the planted fault also runs at the card tests' 1000).

    python -m onset_fingerprinting_torch.tools.conv_stack_gate
    python -m onset_fingerprinting_torch.tools.conv_stack_gate --witness FILE

The second form runs on the CPU, on a file that this tool or
``chip_smoke.py`` saved (``build/conv_stack_far/``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    _ACTIVATIONS,
    _launch_mma,
    conv_stack,
    conv_stack_reference,
    far_signals,
    far_values,
)

#: where far signals are saved
FAR_DIR = _cuda.BUILD_DIR.parent / "conv_stack_far"
#: signals per draw (the flagship's 131072 windows), sound draws, and
#: draws of the planted fault at each of its batches (the flagship's and
#: the card tests')
BATCH = 131072
SEEDS = 64
RACE_SEEDS = 16
RACE_BATCHES = (BATCH, 1000)

_BARRIER = ("        __syncthreads();  // cur complete; every warp done with "
            "nxt, tsm\n")
_ZERO_FROM = "        // rows the next layer's windows read past"
_ZERO_TO = "        __syncthreads();\n        const int n_og"


def planted_race_source(src: str) -> str:
    """``conv_stack_mma.cu`` with each layer's zeroing of ``nxt`` moved in
    front of the barrier at the top of the layer loop."""
    a = src.index(_ZERO_FROM)
    b = src.index(_ZERO_TO, a)
    block, src = src[a:b], src[:a] + src[b:]
    i = src.index(_BARRIER)
    return src[:i] + block + src[i:]


def planted_race_kernel() -> _cuda.Kernel:
    """A kernel record for the planted race, its source in the build
    directory."""
    mma = _cuda.CONV_STACK_MMA
    path = _cuda.BUILD_DIR / "conv_stack_mma_planted_race.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(planted_race_source((_cuda.CSRC / mma.source).read_text()))
    return _cuda.Kernel("conv_stack_mma_planted_race", str(path), mma.entries)


def flagship_stack(seed: int, device="cuda"):
    """The flagship's conv weights ``[O, I, K]`` from
    ``workload.flagship_flax_params(seed)`` and biases ``0.1 * N(0, 1)``."""
    from onset_fingerprinting_torch.models.jax_import import (
        cccnn_state_dict_from_flax,
    )
    from onset_fingerprinting_torch.workload import (
        FLAGSHIP,
        flagship_flax_params,
    )

    sd = cccnn_state_dict_from_flax(flagship_flax_params(seed=seed))
    n = len(FLAGSHIP["kernel_sizes"])
    ws = [sd[f"convs.{i}.weight"].to(device) for i in range(n)]
    g = torch.Generator().manual_seed(seed)
    bs = [(0.1 * torch.randn(w.shape[0], generator=g)).to(device)
          for w in ws]
    return ws, bs


def save_far(path: Path, signals, x, ws, bs, out, plain, padding=1,
             activation="silu") -> Path:
    """Save the rows ``signals`` of a bf16 stack's input and outputs, with
    its weights and biases, for :func:`witness`."""
    idx = signals.to(x.device)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(
        signals=signals.cpu(), x=x[idx].cpu(), out=out[idx].cpu(),
        plain=plain[idx].cpu(), weights=[w.cpu() for w in ws],
        biases=[b.cpu() for b in bs], padding=padding, activation=activation,
    ), path)
    return path


def emulate64(x, ws, bs, padding=1, activation="silu", flips=()):
    """The bf16 stack's rounding points with float64 sums, on the CPU:
    ``x [n, L]`` → ``(out [n, T, O], pre)``, ``pre[l]`` being layer ``l``'s
    values ``[n, O, T]`` before their bf16 rounding.  Each ``(l, n, o, t)``
    of ``flips`` rounds that one value to its other bf16 neighbour."""
    act = _ACTIVATIONS[activation]
    y = x.cpu().to(torch.bfloat16).double()[:, None, :]
    pre = []
    for li, (w, b) in enumerate(zip(ws, bs)):
        v = act(F.conv1d(y, w.cpu().to(torch.bfloat16).double(),
                         padding=padding) + b.cpu().double()[None, :, None])
        r = round_bf16(v)
        at = [f[1:] for f in flips if f[0] == li]
        if at:
            at = tuple(torch.tensor(c) for c in zip(*at))
            up = v[at] > r[at].double()
            toward = torch.where(up, float("inf"), float("-inf"))
            r[at] = torch.nextafter(r[at], toward.to(torch.bfloat16))
        pre.append(v)
        y = r.double()
    return y.transpose(1, 2), pre


def round_bf16(v: torch.Tensor) -> torch.Tensor:
    """float64 → bfloat16 rounded once to nearest (a plain cast goes through
    float32 and can round twice)."""
    r = v.to(torch.bfloat16)
    side = torch.where(v >= r.double(), float("inf"), float("-inf"))
    nb = torch.nextafter(r, side.to(torch.bfloat16))
    return torch.where((v - nb.double()).abs() < (v - r.double()).abs(), nb,
                       r)


def boundary_margin(v: torch.Tensor) -> torch.Tensor:
    """Distance of each float64 value from the nearest bf16 rounding
    boundary, in ulps of the value it rounds to (0 at a tie, 0.5 on a bf16
    value)."""
    r = round_bf16(v)
    side = torch.where(v >= r.double(), float("inf"), float("-inf"))
    ulp = (torch.nextafter(r, side.to(torch.bfloat16)).double()
           - r.double()).abs()
    return 0.5 - (v - r.double()).abs() / ulp


def _n_far(a, ref) -> torch.Tensor:
    """:func:`far_values` of each row of ``a`` against ``ref``."""
    return far_values(a.double(), ref).flatten(1).sum(1)


#: candidate flips tried per batch of the emulation
_STAGES = (8, 64, 256)


def witness(x, ws, bs, out, padding=1, activation="silu") -> dict:
    """Explain one signal's bf16 output ``out [T, O]`` by the float64
    emulation: its far values against the emulation, and the fewest after
    flipping one of the 256 roundings nearest a boundary (tried in batches,
    nearest first).  An output reached by at most one such flip, at a value
    within f32 sum error of the boundary, is a legitimate rounding of the
    same stack; ``explained`` says whether it was."""
    e, pre = emulate64(x[None], ws, bs, padding, activation)
    res = dict(far=int(_n_far(out[None], e)[0]), flip=None, flip_margin=None,
               flip_far=None)
    res["explained"] = res["far"] == 0
    if res["explained"]:
        return res
    margins = [boundary_margin(v[0]) for v in pre]
    flat = torch.cat([m.flatten() for m in margins])
    sizes = [m.numel() for m in margins]
    cands = []
    for i in flat.argsort()[:_STAGES[-1]].tolist():
        li = 0
        while i >= sizes[li]:
            i -= sizes[li]
            li += 1
        cands.append((li, *map(int, np.unravel_index(i, margins[li].shape))))
    lo = 0
    for hi in _STAGES:
        chunk = cands[lo:hi]
        lo = hi
        if not chunk:
            break
        xs = x[None].expand(len(chunk), -1)
        flips = [(li, j, o, t) for j, (li, o, t) in enumerate(chunk)]
        e2, _ = emulate64(xs, ws, bs, padding, activation, flips)
        n = _n_far(out[None].expand_as(e2), e2)
        j = int(n.argmin())
        if res["flip_far"] is None or int(n[j]) < res["flip_far"]:
            li, o, t = chunk[j]
            res.update(flip=chunk[j], flip_far=int(n[j]),
                       flip_margin=float(margins[li][o, t]))
        if res["flip_far"] == 0:
            break
    res["explained"] = res["flip_far"] == 0
    return res


def unexplained_limit(batch: int) -> int:
    """Most far signals of a sound bf16 run that :func:`witness` may leave
    unexplained: one in 65536, at least 1."""
    return max(1, batch // 65536)


def far_cap(batch: int) -> int:
    """Most far signals a sound bf16 run may have before any is
    witnessed: one in 64, at least 16."""
    return max(16, batch // 64)


def gate(out, plain, x, ws, bs, padding=1, activation="silu",
         stop: int | None = None) -> tuple[torch.Tensor, list[int]]:
    """K3's bf16 parity gate: ``(far, unexplained)``, the
    :func:`~onset_fingerprinting_torch.ops.conv_stack.far_signals` of
    ``out`` against ``plain`` and those whose kernel output :func:`witness`
    does not explain (checked in order until ``stop`` are found, default
    one past :func:`unexplained_limit`; none are checked past
    :func:`far_cap`).  A sound run has ``len(far) <= far_cap`` and
    ``len(unexplained) <= unexplained_limit``."""
    batch = len(out)
    far = far_signals(out, plain)
    if len(far) > far_cap(batch):
        return far, []
    stop = unexplained_limit(batch) + 1 if stop is None else stop
    bad = []
    rows = far.to(out.device)
    xs, os_ = x[rows].cpu(), out[rows].cpu()
    for j, s in enumerate(far.tolist()):
        if not witness(xs[j], ws, bs, os_[j], padding,
                       activation)["explained"]:
            bad.append(s)
            if len(bad) >= stop:
                break
    return far, bad


def passes(far, unexplained, batch: int) -> bool:
    return (len(far) <= far_cap(batch)
            and len(unexplained) <= unexplained_limit(batch))


def explain(path: Path) -> list[dict]:
    """:func:`witness` for the kernel's and the plain version's output of
    every signal saved in ``path``."""
    case = torch.load(path)
    rows = []
    for j, sig in enumerate(case["signals"].tolist()):
        row = {"signal": sig}
        for side in ("out", "plain"):
            row[side] = witness(case["x"][j], case["weights"],
                                case["biases"], case[side][j],
                                case["padding"], case["activation"])
        print(f"signal {sig}: kernel {row['out']}; plain {row['plain']}",
              flush=True)
        rows.append(row)
    return rows


#: per-signal largest |out - plain| steps of the distribution printed
DIFF_STEPS = (1e-3, 2.5e-3, 4e-3, 8e-3, 1.6e-2, 3.2e-2)


def diff_table(out, plain) -> list[int]:
    """Signals whose largest ``|out - plain|`` exceeds each of
    ``DIFF_STEPS``."""
    m = (out - plain).abs().flatten(1).amax(1)
    return [int((m > s).sum()) for s in DIFF_STEPS]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("conv_stack_gate needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0], flush=True)
    planted = planted_race_kernel()
    _cuda.build([_cuda.CONV_STACK_MMA, planted])
    print(f"far_cap {far_cap(BATCH)}, unexplained_limit "
          f"{unexplained_limit(BATCH)} at B={BATCH}; diff table: signals "
          f"whose largest |out - plain| exceeds {DIFF_STEPS}", flush=True)
    sound_ok, race = [], {b: [] for b in RACE_BATCHES}
    n_far = n_bad = 0
    for seed in range(SEEDS):
        ws, bs = flagship_stack(seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(BATCH, 256, generator=gen, device="cuda")
        k = conv_stack(x, ws, bs, 1, "silu", torch.bfloat16)
        p = conv_stack_reference(x, ws, bs, 1, "silu", torch.bfloat16)
        far, bad = gate(k, p, x, ws, bs, stop=BATCH)
        sound_ok.append(passes(far, bad, BATCH))
        n_far, n_bad = n_far + len(far), n_bad + len(bad)
        line = (f"seed {seed}: sound {len(far)} far, {len(bad)} unexplained "
                f"{bad[:8]}, diff table {diff_table(k, p)}")
        if len(far):
            save_far(FAR_DIR / f"gate_seed{seed}.pt", far, x, ws, bs, k, p)
        for b in RACE_BATCHES if seed < RACE_SEEDS else ():
            r = torch.empty_like(k[:b])
            _launch_mma(planted, x[:b].contiguous(), ws, bs, 1, "silu", r)
            rf, rbad = gate(r, p[:b], x[:b], ws, bs)
            race[b].append(not passes(rf, rbad, b))
            line += (f"; planted race B={b}: {len(rf)} far, "
                     f"{len(rbad)}+ unexplained, diff table "
                     f"{diff_table(r, p[:b])}, "
                     f"{'caught' if race[b][-1] else 'MISSED'}")
        print(line, flush=True)
    ok = all(sound_ok) and all(race[BATCH])
    print(f"B={BATCH}: sound passes {sum(sound_ok)} of {SEEDS} draws ({n_far} "
          f"far signals, {n_bad} unexplained); planted race caught in "
          f"{sum(race[BATCH])} of {len(race[BATCH])}", flush=True)
    for b in RACE_BATCHES[1:]:
        print(f"B={b}: planted race caught in {sum(race[b])} of "
              f"{len(race[b])}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--witness", type=Path,
                    help="explain the far signals saved in this file (CPU)")
    args = ap.parse_args()
    if args.witness:
        explain(args.witness)
        sys.exit(0)
    sys.exit(main())
