"""The fleet's detect → fingerprint path: ``DetectFingerprint`` over chunks
of many 4-channel streams, state carried from chunk to chunk.

One call is ``run(state, x)`` on the next chunk of the ring, then the
predictions and the hit count copied to the host.  The check follows the
program from its own state at each checked call (the detector state a call
starts from is the program's); it checks the start (the warm-up from the
detector's initial state) and every checked call's returned state apart.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench import common, generate
from portbench.reference import cccnn as ref_cccnn
from portbench.reference import detector as ref_det
from portbench.reference import hits as ref_hits

STATE_FLOATS = ("zi", "fast", "slow", "min_val", "max_val", "prev_rel")
STATE_EXACT = ("gate", "debounce")


def capacity(cfg: dict, tr: dict) -> int:
    """The global hit list's capacity G: ``headroom`` over the expected
    hits of a chunk, rounded up to 128 (the port's sizing rule)."""
    expected = cfg["streams"] * cfg["chunk_samples"] / tr["hit_period"]
    return int(math.ceil(expected * cfg["capacity_headroom"] / 128)) * 128


def max_hits(cfg: dict) -> int:
    """The per-stream hit list's capacity (16 a second, at least 4)."""
    return max(math.ceil(16 * cfg["chunk_samples"] / cfg["sr"]), 4)


class System:
    """Inputs, weights and the program for one seed."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device,
                 faults=()):
        from onset_fingerprinting_torch.core.config import DetectorConfig
        from onset_fingerprinting_torch.models.cccnn import CCCNN
        from onset_fingerprinting_torch.pipeline import make_detect_fingerprint

        self.cfg, self.tr, self.seed = cfg, tr, seed
        self.device = torch.device(device)
        self.audio = generate.make(tr, cfg, seed, self.device)
        self.g = capacity(cfg, tr)
        m = cfg["model"]
        self.weights = common.cccnn_weights(m, cfg["window"], seed,
                                            self.device)
        model = CCCNN(input_size=cfg["window"],
                      dtype=getattr(torch, cfg["dtype"]),
                      **{k: v for k, v in m.items() if k != "padding"})
        model.load_state_dict(common.state_dict_of(self.weights))
        det = cfg["detector"]
        dcfg = DetectorConfig(
            n_channels=cfg["streams"] * cfg["channels_per_stream"],
            sr=cfg["sr"], **det)
        self.run = make_detect_fingerprint(
            dcfg, model, cfg["streams"], cfg["chunk_samples"], self.g,
            device=self.device)
        self._hits = None
        hit_list = self.run.hit_list

        def keep_hit_list(*a):
            self._hits = hit_list(*a)
            return self._hits
        self.run.hit_list = keep_hit_list
        for f in faults:
            f(self)
        self.state = self.run.warmup(self.run.init_state(),
                                     self.audio.lead_in)
        self.calls = 0
        self.kept = {}
        self.host = common.HostCopy()
        self.stream_seconds = (cfg["streams"] * cfg["chunk_samples"]
                               / cfg["sr"])
        self.spans = None

    # -- the timed path ---------------------------------------------------
    def step(self, keep: bool) -> None:
        i = self.calls
        j = i % self.tr["ring_chunks"]
        before = self.state
        self.state, preds, n_hits, _ = self.run(before,
                                                self.audio.chunk_view(j))
        out, nh = self.host.copy((preds, n_hits), keep)
        if keep:
            self.kept[i] = self._keep(i, j, before, out, int(nh))
        self.calls += 1

    def _keep(self, i, j, before, preds, n_hits) -> SimpleNamespace:
        """A kept call's outputs and its states at the channels of the
        streams drawn for it, copied to the host at once (so that kept
        calls hold no device memory and the window allocates none)."""
        cps = self.cfg["channels_per_stream"]
        rng = np.random.default_rng([self.seed, 2, i])
        n = min(self.tr["check_streams"], self.cfg["streams"])
        streams = np.sort(rng.choice(self.cfg["streams"], n, replace=False))
        lanes = (streams[:, None] * cps + np.arange(cps)).reshape(-1)
        li = torch.as_tensor(lanes, device=self.device)

        def pick(st):
            return {f: getattr(st, f).index_select(-1, li).cpu().numpy()
                    for f in STATE_FLOATS + STATE_EXACT}
        starts, sids, valid = (v.cpu().numpy() for v in self._hits[:3])
        return SimpleNamespace(call=i, chunk=j, streams=streams, lanes=lanes,
                               state_in=pick(before),
                               state_out=pick(self.state),
                               preds=preds.numpy(), n_hits=n_hits,
                               starts=starts, sids=sids, valid=valid)

    def warm(self) -> None:
        """One call on every chunk of the ring: every shape the window
        uses, and the start of the stream the window continues."""
        for _ in range(self.tr["ring_chunks"]):
            self.step(keep=self.calls == 0)

    # -- the traced run's spans -------------------------------------------
    def trace_spans(self) -> None:
        """CUDA events around the pipeline's stage methods, per call."""
        self.spans = {s: [] for s in ("detect", "hit_list", "windows",
                                      "predict")}
        for name, rows in self.spans.items():
            fn = getattr(self.run, name)

            def wrapped(*a, _fn=fn, _rows=rows):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _fn(*a)
                e1.record()
                _rows.append((e0, e1))
                return out
            setattr(self.run, name, wrapped)

    def span_ms(self) -> dict:
        """Each stage's mean device time per call (ms)."""
        return {s: float(np.mean([a.elapsed_time(b) for a, b in rows]))
                for s, rows in (self.spans or {}).items() if rows}

    def layer_shapes(self) -> dict:
        cfg = self.cfg
        c = cfg["streams"] * cfg["channels_per_stream"]
        m = cfg["model"]
        return {
            "detector": dict(channels=c, samples=cfg["chunk_samples"],
                             block=cfg["detector"]["block_size"],
                             hipass=bool(cfg["detector"]["hipass_freq"])),
            "model": dict(m, window=cfg["window"]),
        }

    def model_items_per_call(self) -> float:
        """Real hits a call fingerprints, averaged over the ring."""
        return float(self.audio.counts.sum(axis=1).mean())

    # -- the check ----------------------------------------------------------
    def collect(self, plan: common.KeepPlan) -> dict:
        """Everything the check needs, on the host: the checked calls'
        outputs and states, their sampled streams' audio, the lead-in, the
        weights.  Frees the program."""
        items = [self.kept[c] for c in plan.choose(self.kept)]
        for it in items:
            li = torch.as_tensor(it.lanes, device=self.device)
            it.audio = self.audio.chunk_view(it.chunk).index_select(
                1, li).cpu().numpy()
        lead = self.audio.lead_in.index_select(
            1, torch.as_tensor(items[0].lanes, device=self.device)).cpu()
        data = dict(items=items, lead_in=lead.numpy(),
                    counts=self.audio.counts, weights=common.to_cpu(
                        self.weights))
        del self.run, self.state, self.kept, self.audio, self.weights
        self._hits = None
        return data

    def check(self, data: dict, control: bool = False) -> dict:
        """The compared numbers of the program's (or, with ``control``,
        the lower-precision reference's) outputs against the reference."""
        ref = reference(self.cfg, data)
        if control:
            got = reference(self.cfg, data, q=ref_det.to_bf16, fp8=True,
                            base=ref)
        else:
            got = program_view(data)
        return compare(data, got, ref)


def reference(cfg: dict, data: dict, q=ref_det.ident, fp8: bool = False,
              base: dict | None = None) -> dict:
    """The reference's outputs for the checked calls' sampled streams:
    the warm-up from the initial state, then one detect pass over every
    checked call's chunk (call 0 from the reference's own warm state, the
    others from the program's state), hit lists, windows and the CCCNN.
    ``q`` rounds the detector, ``fp8`` the CCCNN; with ``base`` (the
    float32 reference's outputs) the CCCNN takes ``base``'s windows, so
    that each stage of the control is read on the reference's inputs."""
    det = ref_det.Detector.from_config(dict(cfg["detector"], sr=cfg["sr"]))
    cps = cfg["channels_per_stream"]
    items = data["items"]
    warm = ref_det.warmup(det, ref_det.init_state(det, len(items[0].lanes)),
                          data["lead_in"], q)
    states = [warm if it.call == 0 else it.state_in for it in items]
    st = {f: np.concatenate([s[f] for s in states], axis=-1)
          for f in STATE_FLOATS + STATE_EXACT}
    x = np.concatenate([it.audio for it in items], axis=1)
    new, on, deltas = ref_det.detect(det, st, x, q)
    mh = max_hits(cfg)
    starts_all, lane0 = [], 0
    for it in items:
        per = []
        for k in range(len(it.streams)):
            sl = slice(lane0 + k * cps, lane0 + (k + 1) * cps)
            per.append(ref_hits.stream_hit_starts(on[:, sl], deltas[:, sl],
                                                  det.block, mh))
        starts_all.append(per)
        lane0 += len(it.lanes)
    wins, where = [], []
    for n, it in enumerate(items):
        for k, starts in enumerate((base or {"starts": starts_all})
                                   ["starts"][n]):
            for s0 in starts:
                wins.append(ref_hits.anchored_window(
                    it.audio[:, k * cps:(k + 1) * cps], s0, cfg["window"],
                    cfg["pre"]))
                where.append((n, k))
    w = data["weights"]
    x = torch.as_tensor(np.stack(wins)) if wins else torch.zeros(
        (0, cps, cfg["window"]))
    pad = cfg["model"].get("padding", 1)
    preds = ref_cccnn.forward(x, w, padding=pad, fp8=fp8).numpy()
    # the yardstick: the same windows through the float8 CCCNN
    yard = preds if fp8 else ref_cccnn.forward(x, w, padding=pad,
                                               fp8=True).numpy()
    out = [[[] for _ in it.streams] for it in items]
    ys = [[[] for _ in it.streams] for it in items]
    for (n, k), p, q8 in zip(where, preds, yard):
        out[n][k].append(p)
        ys[n][k].append(q8)
    lane0, states_out = 0, []
    for it in items:
        sl = slice(lane0, lane0 + len(it.lanes))
        states_out.append({f: v[..., sl] for f, v in new.items()})
        lane0 += len(it.lanes)
    def arr(nested):
        return [[np.asarray(p, np.float32).reshape(-1, w["fc_b"].numel())
                 for p in per] for per in nested]
    return dict(warm=warm, starts=starts_all, states=states_out,
                preds=arr(out), yard=arr(ys), n_hits=None)


def program_view(data: dict) -> dict:
    """The program's outputs cut the reference's way: each sampled
    stream's slots of the global hit list (the hit list's stream ids and
    starts, judged too), its hit count, and the empty slots."""
    preds, starts, tails, warm = [], [], [], None
    for it in data["items"]:
        ps, ss = [], []
        for s in it.streams:
            idx = np.flatnonzero(it.valid & (it.sids == s))
            ps.append(it.preds[idx])
            ss.append(it.starts[idx].tolist())
        preds.append(ps)
        starts.append(ss)
        tails.append(int(np.count_nonzero(it.preds[it.n_hits:]))
                     + abs(int(it.valid.sum()) - it.n_hits))
        if it.call == 0:
            warm = it.state_in
    return dict(warm=warm, starts=starts, preds=preds,
                states=[it.state_out for it in data["items"]],
                n_hits=[it.n_hits for it in data["items"]], tails=tails)


def compare(data: dict, got: dict, ref: dict) -> dict:
    """``exact_off``: hits of the generator's truth missing from the hit
    count (every injected burst is found; a burst whose onset straddles a
    block boundary may count twice), non-zero empty slots, hit starts of
    the sampled streams that differ (a missing or extra hit counts one),
    and gate or cooldown values that differ; ``state_gap``: the largest
    gap of a float state value over its field's scale (the warm-up and
    every checked call); ``pred_gap`` and ``pred_rms``: the predictions'
    largest and root mean square gap to the float32 CCCNN's, each over
    the same of the float8 CCCNN's (:func:`common.yard_gap`)."""
    detail = dict(hits_missing=0, empty_slots_nonzero=0, starts_off=0,
                  gate_off=0, debounce_off=0)
    items = data["items"]
    for n, it in enumerate(items):
        truth = data["counts"][it.chunk]
        if got.get("n_hits") is not None:
            detail["hits_missing"] += max(0, int(truth.sum())
                                          - got["n_hits"][n])
            detail["empty_slots_nonzero"] += got["tails"][n]
        for a, b in zip(got["starts"][n], ref["starts"][n]):
            m = min(len(a), len(b))
            detail["starts_off"] += abs(len(a) - len(b)) + int(
                np.count_nonzero(np.asarray(a[:m]) != np.asarray(b[:m])))
    gaps = []
    for a, b in [(got["warm"], ref["warm"])] + list(zip(got["states"],
                                                         ref["states"])):
        for f in STATE_FLOATS:
            if f in a and f in b and np.size(b[f]):
                gaps.append(common.rel_gap(a[f], b[f]))
        for f in STATE_EXACT:
            if f in a and f in b:
                detail[f + "_off"] += int(np.count_nonzero(a[f] != b[f]))
    exact = sum(detail.values())
    pa, pb, py = [], [], []
    for ga, rb, yb in zip(got["preds"], ref["preds"], ref["yard"]):
        for x, y, z in zip(ga, rb, yb):
            m = min(len(x), len(y))
            pa.append(np.asarray(x[:m]))
            pb.append(np.asarray(y[:m]))
            py.append(np.asarray(z[:m]))
    pa, pb, py = (np.concatenate(v) if v else np.zeros((0, 2))
                  for v in (pa, pb, py))
    return dict(exact_off=float(exact), state_gap=max(gaps, default=0.0),
                pred_gap=common.yard_gap(pa, pb, py),
                pred_rms=common.yard_gap(pa, pb, py, rms=True),
                compared=int(len(pb)), detail=detail)
