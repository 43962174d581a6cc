"""The batched drum path: ``make_detect_locate_sharded`` on a one-rank mesh
(no process group, no collective): a batch of 3-sensor streams detected by
the coupled detector, each stream's events located by Newton, a window
around every event classified by the zone CCCNN.

One call is ``run(x)`` on the next batch, then points, onsets, emits and
predictions copied to the host.  Calls are independent: every stream
starts from the detector state warmed on the lead-in.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench import common, generate
from portbench.reference import cccnn as ref_cccnn
from portbench.reference import detector as ref_det
from portbench.reference import hits as ref_hits
from portbench.reference.locator import Locator

STATE_FLOATS = ("fast", "slow", "min_val", "max_val")


class System:
    def __init__(self, cfg: dict, tr: dict, seed: int, device, faults=()):
        from onset_fingerprinting_torch.core.config import DetectorConfig
        from onset_fingerprinting_torch.detect.amplitude import detector_init
        from onset_fingerprinting_torch.locate.multilaterate import (
            Multilaterate3D,
        )
        from onset_fingerprinting_torch.models.cccnn import CCCNN
        from onset_fingerprinting_torch.ops.fused_detector import (
            detector_static,
            fused_warmup_minmax,
        )
        from onset_fingerprinting_torch.parallel import (
            make_detect_locate_sharded,
        )
        from onset_fingerprinting_torch.parallel.mesh import make_mesh

        self.cfg, self.tr, self.seed = cfg, tr, seed
        self.device = torch.device(device)
        self.audio = generate.make(tr, cfg, seed, self.device)
        m = cfg["model"]
        self.weights = common.cccnn_weights(m, cfg["window"], seed,
                                            self.device)
        model = CCCNN(input_size=cfg["window"],
                      dtype=getattr(torch, cfg["dtype"]),
                      **{k: v for k, v in m.items() if k != "padding"})
        model.load_state_dict(common.state_dict_of(self.weights))
        dcfg = DetectorConfig(n_channels=3, sr=cfg["sr"], **cfg["detector"])
        static, params, state = detector_init(dcfg, self.device)
        self.warm_state = fused_warmup_minmax(
            detector_static(static, params), params, state,
            self.audio.lead_in)
        locator = Multilaterate3D(
            [tuple(p) for p in cfg["sensors_polar"]],
            drum_diameter=cfg["diameter_cm"], medium="drumhead",
            sr=cfg["sr"], c=cfg["wave_speed_m_s"],
            feasibility_tols=tuple(cfg["feasibility_tols_cm"]))
        mesh = make_mesh((1,), ("data",), device=self.device)
        shape = tuple(self.audio.batches.shape[1:])
        self.run = make_detect_locate_sharded(
            static, params, self.warm_state, shape, mesh, locator,
            model=model, event_capacity=cfg["event_capacity"],
            locator_capacity=cfg["locator_capacity"], window=cfg["window"],
            pre=cfg["pre"])
        for f in faults:
            f(self)
        self.calls = 0
        self.kept = {}
        self.host = common.HostCopy()
        self.stream_seconds = shape[0] * shape[1] / cfg["sr"]

    def step(self, keep: bool) -> None:
        i = self.calls
        b = i % self.audio.batches.shape[0]
        host = self.host.copy(self.run(self.audio.batches[b]), keep)
        if keep:
            self.kept[i] = SimpleNamespace(batch=b, outs=host)
        self.calls += 1

    def warm(self) -> None:
        """One call on every batch: every shape the window uses."""
        for _ in range(self.audio.batches.shape[0]):
            self.step(keep=self.calls == 0)

    def trace_spans(self) -> None:
        """The stages sit inside the closure: the traced run reads them
        from the kernels' names."""

    def span_ms(self) -> dict:
        return {}

    def layer_shapes(self) -> dict:
        cfg = self.cfg
        s, t, c = self.audio.batches.shape[1:]
        m = cfg["model"]
        return {
            "detector": dict(channels=s * c, samples=t,
                             block=cfg["detector"]["block_size"],
                             hipass=bool(cfg["detector"]["hipass_freq"])),
            "model": dict(m, window=cfg["window"]),
        }

    def model_items_per_call(self) -> float:
        """Strikes a call locates and classifies, averaged over the
        batches (the generator's truth)."""
        return float(np.mean([sum(len(s) for s in b)
                              for b in self.audio.strikes]))

    def collect(self, plan: common.KeepPlan) -> dict:
        cfg = self.cfg
        calls = plan.choose(self.kept)
        rng = np.random.default_rng([self.seed, 2])
        s_all = self.audio.batches.shape[1]
        n = min(self.tr["check_streams"], s_all)
        items = []
        for c in calls:
            k = self.kept[c]
            streams = np.sort(rng.choice(s_all, n, replace=False))
            si = torch.as_tensor(streams, device=self.device)
            x = self.audio.batches[k.batch].index_select(0, si).cpu().numpy()
            pts, ons, ems, prs = (v.numpy()[streams] for v in k.outs)
            items.append(SimpleNamespace(call=c, batch=k.batch,
                                         streams=streams, audio=x,
                                         points=pts, onsets=ons, emits=ems,
                                         preds=prs))
        warm = {f: getattr(self.warm_state, f).cpu().numpy()
                for f in STATE_FLOATS}
        data = dict(items=items, lead_in=self.audio.lead_in.cpu().numpy(),
                    warm=warm, weights=common.to_cpu(self.weights))
        del self.run, self.kept, self.audio, self.weights, self.warm_state
        return data

    def check(self, data: dict, control: bool = False) -> dict:
        ref = reference(self.cfg, data)
        if control:
            got = reference(self.cfg, data, q=ref_det.to_bf16, fp8=True,
                            base=ref)
        else:
            got = dict(warm=data["warm"],
                       items=[dict(onsets=it.onsets, emits=it.emits,
                                   points=it.points, preds=it.preds)
                              for it in data["items"]])
        return compare(got, ref)


def reference(cfg: dict, data: dict, q=ref_det.ident, fp8: bool = False,
              base: dict | None = None) -> dict:
    """The reference's outputs for the checked calls' sampled streams, all
    lanes in one detect pass from the reference's own warm-up.  ``q``
    rounds the detector and the locator, ``fp8`` the CCCNN; with ``base``
    (the float32 reference's outputs) the locator takes ``base``'s events
    and the CCCNN ``base``'s windows, so that each stage of the control is
    read on the reference's inputs."""
    det = ref_det.Detector.from_config(dict(cfg["detector"], sr=cfg["sr"]))
    items = data["items"]
    warm = ref_det.warmup(det, ref_det.init_state(det, 3), data["lead_in"],
                          q)
    lanes = sum(len(it.streams) for it in items) * 3
    st = {f: np.tile(v, (1,) * (np.ndim(v) - 1) + (lanes // 3,))
          for f, v in warm.items()}
    x = np.concatenate([it.audio.transpose(1, 0, 2).reshape(
        it.audio.shape[1], -1) for it in items], axis=1)
    _, on, deltas = ref_det.detect(det, st, x, q, group=3)
    loc = Locator(cfg["sensors_polar"], cfg["diameter_cm"], cfg["sr"],
                  cfg["wave_speed_m_s"] * 100, cfg["feasibility_tols_cm"],
                  q=q)
    e, out_n = cfg["event_capacity"], cfg["model"]["output_size"]
    outs, events, wins, where, lane = [], [], [], [], 0
    for n, it in enumerate(items):
        k = len(it.streams)
        o = dict(onsets=np.full((k, e), common.EV_BIG, np.int64),
                 emits=np.zeros((k, e), bool),
                 points=np.zeros((k, e, 2), np.float32),
                 preds=np.zeros((k, e, out_n), np.float32))
        ev = []
        for j in range(k):
            sl = slice(lane, lane + 3)
            lane += 3
            ons, chs = ref_hits.stream_events(on[:, sl], deltas[:, sl],
                                              det.block, e)
            ev.append((ons, chs))
            o["onsets"][j, :len(ons)] = ons
            ons, chs = base["events"][n][j] if base else (ons, chs)
            pts, ems = loc.run(ons, chs)
            o["emits"][j, :len(ons)] = ems
            o["points"][j, :len(ons)] = pts
            keep = base["items"][n]["emits"][j] if base else o["emits"][j]
            for i in np.flatnonzero(keep):
                wins.append(ref_hits.event_window(it.audio[j], ons[i],
                                                  cfg["window"], cfg["pre"]))
                where.append((n, j, i))
        outs.append(o)
        events.append(ev)
    w = data["weights"]
    x = torch.as_tensor(np.stack(wins)) if wins else torch.zeros(
        (0, 3, cfg["window"]))
    pad = cfg["model"].get("padding", 1)
    preds = ref_cccnn.forward(x, w, padding=pad, fp8=fp8).numpy()
    # the yardstick: the same windows through the float8 CCCNN
    yard = preds if fp8 else ref_cccnn.forward(x, w, padding=pad,
                                               fp8=True).numpy()
    for o in outs:
        o["yard"] = np.zeros_like(o["preds"])
    for (n, j, i), p, q8 in zip(where, preds, yard):
        outs[n]["preds"][j, i] = p
        outs[n]["yard"][j, i] = q8
    return dict(warm=warm, items=outs, events=events)


def compare(got: dict, ref: dict) -> dict:
    """``exact_off``: onsets or emits that differ, and non-zero points or
    predictions in slots not emitted; ``point_gap``: the largest point gap
    in cm over the emitted slots; ``pred_gap`` and ``pred_rms``: the
    predictions' largest and root mean square gap to the float32 CCCNN's,
    each over the same of the float8 CCCNN's; ``state_gap``:
    the warm-up's largest gap over its field's scale."""
    detail = dict(onsets_off=0, emits_off=0, empty_slots_nonzero=0)
    pa, pb, qa, qb, qy = [], [], [], [], []
    for g, r in zip(got["items"], ref["items"]):
        detail["onsets_off"] += int(np.count_nonzero(
            np.asarray(g["onsets"], np.int64) != r["onsets"]))
        detail["emits_off"] += int(np.count_nonzero(g["emits"]
                                                    != r["emits"]))
        both = g["emits"] & r["emits"]
        off = ~g["emits"]
        detail["empty_slots_nonzero"] += int(
            np.count_nonzero(g["points"][off])
            + np.count_nonzero(g["preds"][off]))
        pa.append(g["points"][both])
        pb.append(r["points"][both])
        qa.append(g["preds"][both])
        qb.append(r["preds"][both])
        qy.append(r["yard"][both])
    pa, pb = np.concatenate(pa), np.concatenate(pb)
    gap = float(np.max(np.abs(pa - pb))) if len(pb) else 0.0
    if not np.isfinite(gap):
        gap = float("inf")
    qs = [np.concatenate(v) for v in (qa, qb, qy)]
    sg = max(common.rel_gap(got["warm"][f], ref["warm"][f])
             for f in STATE_FLOATS)
    return dict(exact_off=float(sum(detail.values())), point_gap=gap,
                pred_gap=common.yard_gap(*qs),
                pred_rms=common.yard_gap(*qs, rms=True),
                state_gap=sg, compared=int(len(pb)), detail=detail)
