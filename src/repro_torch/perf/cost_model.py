"""Learned HLO cost model: the zero-probe prediction tier.

Every prediction path so far needs HISTORY: the SurfaceLibrary's
similarity fold-in needs probed points of the target job, and placement
needs either a persisted surface or the job's own calibrated profile.  A
genuinely never-before-seen architecture pays the full probe-climb.  This
module closes that gap with the byteprofile-analysis ``cost_model_xla``
recipe adapted to our stack: extract per-op feature vectors from the
served program (``perf/op_analysis.py`` flops / HBM bytes / collective
bytes / op-class histograms of the aten ops it dispatches, plus
``perf/roofline.py`` bound-time terms),
and fit a small ridge regressor on what the profile store already
accumulates (SurfaceLibrary rows, measured interference pairs).

The structure matters more than the regressor.  Step latency follows the
calibrated pipeline law (device_model.py)::

    lat = bs * (host*rho(bs)*(1 + chi*x) +
                max(steady, gpu1*bs^-amort) * inv_share*mtl*(1 + eps*x)) / 1e3

which is NOT log-linear in any feature basis — a flat ridge on latency
plateaus near 300% median error.  So the model predicts the three
CALIBRATION scalars instead — ``[log host_ms, log gpu1_ms, amort]`` — and
prices surfaces through the exact analytic law every probed row was
generated by.  Held out job families then land ~17% pooled median
relative error (leave-one-job-out over the Table-4 fleet), inside the
30% acceptance envelope; singleton families with no architectural sibling
in the library (deepspeech2, textclassif) remain the honest worst case.

Training targets come from INVERSE PRICING: each persisted surface row is
grid-searched for the (host, amort) pair (gpu1 recovered from the row's
own (1, 1) base point) that reproduces its observed latencies with
minimum log-MSE — the same fit Table 5 calibration uses, run against the
store instead of the paper.

The fitted model persists in a schema-versioned ``cost_model`` section of
the profile store, one record per device class, staleness-gated exactly
like surface rows: a schema or autotune-generation mismatch EVICTS the
record at load (never served stale).  Downstream it is the THIRD
prediction tier — HLO-predicted prior -> similarity fold-in -> probed
truth: ``SurfaceLibrary.predict`` falls back to the model surface with an
all-False support mask (no pins, no jumps, no capacity promises),
``DNNScalerController`` seeds the HybridScaler start point from it when
the library refuses, and ``ClusterEngine`` placement prices
never-before-seen jobs with the predicted profile instead of the generic
fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.perf.op_analysis import OP_CLASSES, analyze_ops
from repro_torch.perf.roofline import bound_time_features
from repro_torch.serving import device_model as dm

COST_MODEL_SECTION = "cost_model"
COST_MODEL_SCHEMA = 1
RIDGE_LAM = 1e-2          # shrinkage; features are standardized first
FEATURE_DIM = 4 + len(OP_CLASSES) + 5
_MS_BOUNDS = (1e-3, 1e4)  # sanity clamp on predicted host/gpu1 (ms)

# ---------------------------------------------------------------------------
# Op signatures for the simulated Table-4 fleet.
#
# On a real backend the op-class histogram comes straight from
# ``analyze_ops(fn, *args)`` (see ``features_from_ops``).  The
# simulator has no compiled module per Table-4 net, so this table carries
# the same fingerprint — approximate op counts and op-class fractions of
# the published architectures (ordered as OP_CLASSES: conv, depthwise,
# dense, rnn, elementwise, reshuffle).  The histogram is what lets ridge
# generalize FAMILY-WISE: a cell-based NAS net is thousands of tiny
# reshuffle-heavy ops (huge host share), an RNN is a while loop, a
# depthwise tower amortizes poorly — exactly the idiosyncrasies raw FLOP
# counts miss.
# ---------------------------------------------------------------------------
OPSIG = {
    "inception_v1":    (900,  0.34, 0.00, 0.01, 0.00, 0.42, 0.12),
    "inception_v2":    (1000, 0.34, 0.02, 0.01, 0.00, 0.42, 0.12),
    "inception_v3":    (1300, 0.35, 0.00, 0.01, 0.00, 0.42, 0.11),
    "inception_v4":    (1800, 0.35, 0.00, 0.01, 0.00, 0.42, 0.11),
    "mobilenet_v1_1":  (420,  0.24, 0.24, 0.01, 0.00, 0.38, 0.02),
    "mobilenet_v1_05": (420,  0.24, 0.24, 0.01, 0.00, 0.38, 0.02),
    "mobilenet_v1_025": (420, 0.24, 0.24, 0.01, 0.00, 0.38, 0.02),
    "mobilenet_v2_1":  (500,  0.22, 0.22, 0.01, 0.00, 0.42, 0.02),
    "mobilenet_v2_14": (500,  0.22, 0.22, 0.01, 0.00, 0.42, 0.02),
    "nasnet_large":    (4200, 0.18, 0.14, 0.00, 0.00, 0.40, 0.16),
    "nasnet_mobile":   (3100, 0.18, 0.14, 0.00, 0.00, 0.40, 0.16),
    "pnasnet_large":   (3900, 0.19, 0.13, 0.00, 0.00, 0.40, 0.15),
    "pnasnet_mobile":  (2900, 0.19, 0.13, 0.00, 0.00, 0.40, 0.15),
    "resnet_v2_50":    (620,  0.36, 0.00, 0.01, 0.00, 0.46, 0.05),
    "resnet_v2_101":   (1100, 0.36, 0.00, 0.01, 0.00, 0.46, 0.05),
    "resnet_v2_152":   (1600, 0.36, 0.00, 0.01, 0.00, 0.46, 0.05),
    "textclassif":     (90,   0.00, 0.00, 0.45, 0.05, 0.35, 0.02),
    "deepvs":          (520,  0.28, 0.00, 0.05, 0.30, 0.30, 0.04),
    "deepspeech2":     (340,  0.08, 0.00, 0.18, 0.48, 0.22, 0.02),
}


@dataclasses.dataclass(frozen=True)
class ModelFeatures:
    """Architecture statics + op-class mix: everything the feature vector
    needs, NONE of it probed (host/gpu1/amort are the prediction target —
    feeding them back in would be circular)."""
    flops: float              # per-item FLOPs
    param_bytes: float
    input_bytes: float
    n_ops: float              # op count (trip-weighted for real HLO)
    op_hist: tuple            # fractions, ordered as OP_CLASSES

    def vector(self, peak_flops: float, hbm_bw: float) -> np.ndarray:
        f = max(self.flops, 1.0)
        w = max(self.param_bytes, 1.0)
        a = max(self.input_bytes, 1.0)
        ops = max(self.n_ops, 1.0)
        # per-item HBM traffic under the steady_ms convention: weights
        # amortized 32x across the batch, plus the input read
        bt = bound_time_features(f, w / 32.0 + a, peak_flops=peak_flops,
                                 hbm_bw=hbm_bw)
        rnn = self.op_hist[OP_CLASSES.index("rnn")]
        return np.array([
            math.log(f), math.log(w), math.log(a), math.log(ops),
            *self.op_hist,
            math.log(f / ops),        # granularity: FLOPs per op
            math.log(w / ops),        # weight per op (dense-kernel size)
            math.log(a) * rnn,        # sequence length x recurrence
            math.log(max(bt["bound_time"], 1e-12)),
            math.log(max(bt["t_compute"], 1e-12)
                     / max(bt["t_memory"], 1e-12)),
        ], np.float64)


def features_from_ops(fn, *args, param_bytes: float,
                      input_bytes: float = 600e3) -> ModelFeatures:
    """Features straight from the program itself (the real-backend
    path): flops / op histogram / op count from ``analyze_ops`` of
    ``fn(*args)`` on meta tensors."""
    h = analyze_ops(fn, *args)
    hist = tuple(float(h["op_hist"].get(c, 0.0)) for c in OP_CLASSES)
    return ModelFeatures(flops=float(h["flops"]),
                         param_bytes=float(param_bytes),
                         input_bytes=float(input_bytes),
                         n_ops=float(max(h["n_ops"], 1.0)),
                         op_hist=hist)


def _llm_opsig(cfg) -> tuple:
    """Dense-dominated transformer/SSM fingerprint scaled by depth."""
    n_ops = 14.0 * float(getattr(cfg, "num_layers", 24))
    return n_ops, (0.0, 0.0, 0.55, 0.0, 0.35, 0.10)


def features_for_profile(prof: dm.JobProfile, dnn: str,
                         cfg=None) -> Optional[ModelFeatures]:
    """Features from a profile's STATICS plus the op-signature table
    (never its probed host/gpu1/amort).  None for architectures with no
    signature — the caller then has no prior, which is the honest
    answer."""
    sig = OPSIG.get(dnn)
    if sig is not None:
        n_ops, hist = float(sig[0]), tuple(float(x) for x in sig[1:])
    elif cfg is not None:
        n_ops, hist = _llm_opsig(cfg)
    else:
        return None
    return ModelFeatures(flops=float(prof.flops),
                         param_bytes=float(prof.param_bytes),
                         input_bytes=float(prof.input_bytes),
                         n_ops=n_ops, op_hist=hist)


# served-module feature memo: one trace per (arch, phase) per process
# (a failed trace memoizes None so the static fallback is also cheap)
_MODULE_FEATURES: dict = {}


def features_for_served_module(cfg, dataset: str,
                               prof: dm.JobProfile
                               ) -> Optional[ModelFeatures]:
    """OPSIG from the served module's OWN ops: run the decode step (or
    prefill) the engine actually serves on meta tensors at bs=1 specs,
    under the config's own ``kernel_impl`` (the plain path by default:
    the CUDA kernels launch through ``ctypes`` and dispatch no aten op),
    and read the op-class histogram of what it dispatches
    (``op_analysis.analyze_ops``).  None on any failure — the caller falls
    back to the static `_llm_opsig` fingerprint."""
    key = (getattr(cfg, "name", repr(cfg)), dataset)
    if key in _MODULE_FEATURES:
        return _MODULE_FEATURES[key]
    feat = None
    try:
        import torch
        from repro_torch.configs.base import InputShape
        from repro_torch.models import api
        shape = InputShape("opsig_probe", 1024, 1, dataset)
        if dataset == "decode":
            specs = (api.param_specs(cfg), api.cache_specs(cfg, shape),
                     api.batch_specs(cfg, shape)["tokens"],
                     torch.empty((), dtype=torch.int32, device="meta"))
            fn = lambda p, c, t, q: api.decode_step(p, c, t, q, cfg)
        else:
            specs = (api.param_specs(cfg),
                     api.batch_specs(cfg, shape))
            fn = lambda p, b: api.prefill(p, b, cfg, shape.seq_len)
        feat = features_from_ops(fn, *specs,
                                 param_bytes=prof.param_bytes,
                                 input_bytes=prof.input_bytes)
        if feat.n_ops <= 1.0 or feat.flops <= 0.0:
            feat = None
    except Exception:  # noqa: BLE001 — no live ops, static table instead
        feat = None
    _MODULE_FEATURES[key] = feat
    return feat


def features_for_signature(signature: str) -> Optional[ModelFeatures]:
    """Features for a persisted surface's architecture signature
    ("dnn/dataset"): Table-4 nets via their public statics, LLM
    decode/prefill jobs via their own served module's ops (static
    `_llm_opsig` fingerprint when tracing is unavailable)."""
    if "/" not in signature:
        return None
    dnn, dataset = signature.split("/", 1)
    if dnn in dm.NET_SPECS:
        return features_for_profile(dm.paper_profile(dnn, dataset), dnn)
    if dataset in ("decode", "prefill"):
        try:
            from repro_torch.configs.base import get_config
            cfg = get_config(dnn)
        except (ImportError, KeyError):
            return None
        prof = dm.llm_profile(cfg, dataset)
        feat = features_for_served_module(cfg, dataset, prof)
        if feat is not None:
            return feat
        return features_for_profile(prof, dnn, cfg=cfg)
    return None


def features_for_job(job) -> Optional[ModelFeatures]:
    """Features for a workload ``Job``: the signature lookup, falling
    back to a profile-override's statics (LLM / synthetic jobs)."""
    feat = features_for_signature(f"{job.dnn}/{job.dataset}")
    if feat is not None:
        return feat
    prof = getattr(job, "profile_override", None)
    if prof is not None:
        return features_for_profile(prof, job.dnn)
    return None


# ---------------------------------------------------------------------------
# Inverse pricing: surface row -> calibration triple (the training target)
# ---------------------------------------------------------------------------
def _fit_calibration(mean_lat_s: np.ndarray, cnt: np.ndarray,
                     bs_values, mtl_values, share_values,
                     feat: ModelFeatures,
                     device: dm.Device) -> Optional[tuple]:
    """(host_ms, gpu1_ms, amort) whose analytic pricing best reproduces
    the row's observed mean latencies (cnt-weighted log-MSE grid search —
    the Table-5 `_fit_profile` recipe run against the store).  None when
    the row lacks its (1, 1) base point at the largest observed rung."""
    mean = np.asarray(mean_lat_s, np.float64)
    cnt = np.asarray(cnt, np.float64)
    if mean.ndim == 2:
        mean = mean[:, :, None]
        cnt = cnt[:, :, None]
    bs_values = [int(b) for b in bs_values]
    mtl_values = [int(m) for m in mtl_values]
    share_values = [float(s) for s in share_values]
    if bs_values[0] != 1 or mtl_values[0] != 1:
        return None
    base_s = None
    base_inv = 1.0
    for s, sh in enumerate(share_values):   # largest rung first (desc)
        if cnt[0, 0, s] > 0:
            base_s = float(mean[0, 0, s])
            base_inv = 1.0 / sh
            break
    if base_s is None or base_s <= 0:
        return None
    base_ms = base_s * 1e3
    steady = dm.JobProfile("fit", 1.0, 1.0, 0.0, feat.flops,
                           feat.param_bytes).steady_ms(device)
    r1 = float(dm.rho(1))
    host = base_ms / r1 * np.linspace(0.02, 0.95, 48)[:, None]   # (H, 1)
    # gpu1 from the base point itself: lat(1,1) = host*rho(1) + gpu_img*inv
    gpu1 = np.maximum((base_ms - host * r1) / base_inv, 1e-4)
    amort = np.linspace(0.0, 0.95, 40)[None, :]                  # (1, A)
    err = np.zeros((host.shape[0], amort.shape[1]))
    wsum = 0.0
    for i, bs in enumerate(bs_values):
        for j, mtl in enumerate(mtl_values):
            for s, sh in enumerate(share_values):
                w = cnt[i, j, s]
                if w <= 0:
                    continue
                x = mtl - 1.0
                gpu_img = np.maximum(steady, gpu1 * bs ** (-amort))
                lat = bs * (host * dm.rho(bs) * (1.0 + dm.CHI_HOST * x)
                            + gpu_img * (mtl / sh)
                            * (1.0 + dm.EPS_MT * x)) / 1e3
                err += w * np.log(lat / float(mean[i, j, s])) ** 2
                wsum += w
    if wsum <= 0:
        return None
    i, j = np.unravel_index(int(np.argmin(err)), err.shape)
    g = float(np.maximum(gpu1[i, 0], 1e-4))
    return float(host[i, 0]), g, float(amort[0, j])


# ---------------------------------------------------------------------------
# The fitted model
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostModel:
    device_class: str
    device: dm.Device
    mu: np.ndarray            # feature standardization
    sd: np.ndarray
    W: np.ndarray             # (FEATURE_DIM, 3) ridge weights
    ym: np.ndarray            # target means (centered-Y ridge)
    n_rows: int = 0
    train_signatures: tuple = ()
    rung_factors: Optional[dict] = None   # share rung -> measured inflation
    autotune_generation: int = 0
    tile_dependent: bool = False

    def predict_calibration(self, feat: ModelFeatures) -> tuple:
        """(host_ms, gpu1_ms, amort) for an unseen architecture."""
        z = (feat.vector(self.device.peak_flops, self.device.hbm_bw)
             - self.mu) / self.sd
        y = z @ self.W + self.ym
        lo, hi = _MS_BOUNDS
        host = float(np.clip(np.exp(y[0]), lo, hi))
        gpu1 = float(np.clip(np.exp(y[1]), lo, hi))
        amort = float(np.clip(y[2], 0.0, 0.95))
        return host, gpu1, amort

    def predict_profile(self, feat: ModelFeatures,
                        name: str = "predicted") -> dm.JobProfile:
        host, gpu1, amort = self.predict_calibration(feat)
        return dm.JobProfile(name=name, host_ms=host, gpu1_ms=gpu1,
                             amort=amort, flops=feat.flops,
                             param_bytes=feat.param_bytes,
                             input_bytes=feat.input_bytes)

    def predict_surface(self, feat: ModelFeatures, bs_values, mtl_values,
                        share_values=(1.0,)) -> np.ndarray:
        """Mean step-latency prior over the library grid (seconds) —
        2-D on a single-rung grid, else (bs, mtl, share).  Rungs are
        priced by the partition law at tenants=1 and then scaled by the
        store's MEASURED inflation factor when one exists (the cross-rung
        transfer: ladder geometry + model features, no row similarity
        needed)."""
        prof = self.predict_profile(feat)
        share_values = [float(s) for s in share_values]
        planes = []
        for sh in share_values:
            lat = dm.part_latency_grid(self.device, prof, bs_values,
                                       mtl_values, inv_share=1.0 / sh)
            factor = (self.rung_factors or {}).get(f"{sh:.4f}")
            if isinstance(factor, (int, float)) and factor > 0:
                lat = lat * float(factor)
            planes.append(lat)
        if len(planes) == 1:
            return planes[0]
        return np.stack(planes, axis=2)

    def to_record(self) -> dict:
        d = self.device
        return {
            "schema": COST_MODEL_SCHEMA,
            "device_class": self.device_class,
            "device": {"name": d.name, "peak_flops": d.peak_flops,
                       "hbm_bw": d.hbm_bw, "hbm_bytes": d.hbm_bytes,
                       "idle_w": d.idle_w, "peak_w": d.peak_w},
            "feature_dim": FEATURE_DIM,
            "mu": self.mu.tolist(), "sd": self.sd.tolist(),
            "W": self.W.tolist(), "ym": self.ym.tolist(),
            "n_rows": int(self.n_rows),
            "train_signatures": list(self.train_signatures),
            "rung_factors": dict(self.rung_factors or {}),
            "autotune_generation": int(self.autotune_generation),
            "tile_dependent": bool(self.tile_dependent),
        }

    @classmethod
    def from_record(cls, rec: dict) -> "CostModel":
        d = rec["device"]
        mu = np.asarray(rec["mu"], np.float64)
        sd = np.asarray(rec["sd"], np.float64)
        W = np.asarray(rec["W"], np.float64)
        ym = np.asarray(rec["ym"], np.float64)
        if (rec.get("schema") != COST_MODEL_SCHEMA
                or rec.get("feature_dim") != FEATURE_DIM
                or mu.shape != (FEATURE_DIM,) or sd.shape != (FEATURE_DIM,)
                or W.shape != (FEATURE_DIM, 3) or ym.shape != (3,)
                or not np.isfinite(mu).all() or not np.isfinite(sd).all()
                or not np.isfinite(W).all() or not np.isfinite(ym).all()
                or (sd <= 0).any()):
            raise ValueError("malformed cost_model record")
        return cls(
            device_class=str(rec.get("device_class", d["name"])),
            device=dm.Device(str(d["name"]), float(d["peak_flops"]),
                             float(d["hbm_bw"]), float(d["hbm_bytes"]),
                             float(d["idle_w"]), float(d["peak_w"])),
            mu=mu, sd=sd, W=W, ym=ym,
            n_rows=int(rec.get("n_rows", 0)),
            train_signatures=tuple(rec.get("train_signatures", ())),
            rung_factors=dict(rec.get("rung_factors", {})),
            autotune_generation=int(rec.get("autotune_generation", 0)),
            tile_dependent=bool(rec.get("tile_dependent", False)))


# ---------------------------------------------------------------------------
# Training on what the store accumulates
# ---------------------------------------------------------------------------
def _gather_training_rows(store, device_class: str,
                          device: dm.Device) -> tuple:
    X, Y, sigs = [], [], []
    for rec in store.section("surfaces").values():
        if not isinstance(rec, dict) \
                or rec.get("device_class") != device_class:
            continue
        sig = rec.get("signature", "")
        feat = features_for_signature(sig)
        if feat is None:
            continue
        try:
            sum_ = np.asarray(rec["sum"], np.float64)
            cnt = np.asarray(rec["cnt"], np.float64)
        except (KeyError, TypeError, ValueError):
            continue
        if sum_.shape != cnt.shape or not (cnt > 0).any():
            continue
        mean = np.where(cnt > 0, sum_ / np.maximum(cnt, 1.0), 0.0)
        cal = _fit_calibration(mean, cnt, rec.get("bs_values", []),
                               rec.get("mtl_values", []),
                               rec.get("share_values", [1.0]),
                               feat, device)
        if cal is None:
            continue
        host, gpu1, amort = cal
        X.append(feat.vector(device.peak_flops, device.hbm_bw))
        Y.append([math.log(host), math.log(gpu1), amort])
        sigs.append(sig)
    return X, Y, sigs


def _gather_rung_factors(store, device_class: str) -> dict:
    """Median measured slice inflation per share rung, pooled across
    signatures (interference keys: 'sig|device_class|share=S')."""
    per_rung: dict = {}
    suffix_marker = f"|{device_class}|share="
    for key, rec in store.section("interference").items():
        if suffix_marker not in key or not isinstance(rec, dict):
            continue
        try:
            share = float(key.rsplit("share=", 1)[1])
        except (IndexError, ValueError):
            continue
        ratios = [i / w for w, i in rec.get("samples", [])
                  if isinstance(w, (int, float)) and w > 0
                  and isinstance(i, (int, float)) and i > 0]
        if ratios:
            per_rung.setdefault(f"{share:.4f}", []).extend(ratios)
    return {r: float(np.median(np.asarray(v)))
            for r, v in per_rung.items()}


def train_cost_model(store, device_class: str, *,
                     device: Optional[dm.Device] = None,
                     min_rows: int = 4,
                     autotune_generation: int = 0,
                     tile_dependent: bool = False
                     ) -> Optional[CostModel]:
    """Fit the ridge on every usable surface row the store holds for
    `device_class`.  None below `min_rows` usable rows — too little
    history to regress three targets on ~15 features without the prior
    being noise."""
    if device is None:
        device = {"tesla-p40": dm.TESLA_P40,
                  "tpu-v5e": dm.TPU_V5E}.get(device_class)
    if device is None:
        return None
    X, Y, sigs = _gather_training_rows(store, device_class, device)
    if len(X) < min_rows:
        return None
    X = np.vstack(X)
    Y = np.asarray(Y, np.float64)
    mu = X.mean(0)
    sd = X.std(0)
    sd = np.where(sd > 1e-12, sd, 1.0)
    Z = (X - mu) / sd
    ym = Y.mean(0)
    n = Z.shape[0]
    W = np.linalg.solve(Z.T @ Z + RIDGE_LAM * n * np.eye(FEATURE_DIM),
                        Z.T @ (Y - ym))
    return CostModel(device_class=device_class, device=device,
                     mu=mu, sd=sd, W=W, ym=ym, n_rows=n,
                     train_signatures=tuple(sigs),
                     rung_factors=_gather_rung_factors(store, device_class),
                     autotune_generation=int(autotune_generation),
                     tile_dependent=bool(tile_dependent))


# ---------------------------------------------------------------------------
# Store persistence (schema-versioned, staleness-evicted like surfaces)
# ---------------------------------------------------------------------------
def save_cost_model(store, model: CostModel) -> None:
    store.put(COST_MODEL_SECTION, model.device_class, model.to_record())
    store.save()


def load_cost_model(store, device_class: str, *,
                    autotune_generation: int = 0) -> Optional[CostModel]:
    """Load the persisted model for one device class, or None.

    Mirrors ``load_surfaces``: a record that fails the schema check or
    was trained under a different autotune generation (when its training
    latencies came from tuned kernels) is EVICTED from the store — a
    stale prior would fail again on every future load, and must never be
    served in the meantime."""
    rec = store.get(COST_MODEL_SECTION, device_class)
    if rec is None:
        return None
    try:
        model = CostModel.from_record(rec)
    except (KeyError, TypeError, ValueError):
        model = None
    if model is not None and model.tile_dependent \
            and model.autotune_generation != int(autotune_generation):
        model = None                     # stale: tiles changed underneath
    if model is None:
        store.delete(COST_MODEL_SECTION, device_class)
        store.evictions += 1
        store.save()
        return None
    return model
