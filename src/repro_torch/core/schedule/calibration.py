"""Measured calibration of the port: compression compute and the
collective fabric itself — a copy of ``repro/core/schedule/calibration.py``
with its timers rewritten for torch, held to it by
``tests/test_torch_calibration.py``.

The α-β cost model prices the wire from link parameters, but hand-written
``LINK_PRESETS`` are exactly the unvalidated constants Zhang et al. ("Is
Network the Bottleneck?") show diverging from measured collective behavior
at real message sizes.  This module closes the modeled↔measured loop twice:

  * :func:`measure_compression_costs` times each compressor's encode and
    decode on the device given (the fused wires' hooks launch the
    ``quantize_ef``, ``dequant_accum`` and ``topk_ef`` kernels on the
    card), fits ``seconds = n_bytes / bw + c0`` per stage, and hands the
    planner a :class:`~repro_torch.core.schedule.cost.CompressionCostTable`
    — the measured COMPUTE term.
  * :func:`calibrate_topology` times the actual collectives (per algorithm
    × payload size × tier, ``collectives.api.allreduce`` over each tier's
    process group, the edge training executes) and fits per-tier
    ``LinkParams`` (α, β) WITH confidence bounds — the measured WIRE term.
    The result, a :class:`CalibratedTopology`, drops into every ``net``
    argument of ``cost.py`` (``as_topology`` unwraps it), so
    ``plan_auto(calibration=...)`` prices every arm on the fabric it will
    run on.

Timing policy (the reference's): wall clock, the first call discarded,
the MINIMUM of N per point — the best estimate of the uncontended cost
that the α-β model defines — with ``torch.cuda.synchronize()`` around
each call whose inputs or outputs lie on the card.  No new CUDA stream is
made (every stream that runs a matmul keeps a cuBLAS workspace).  Fits
are least squares over ≥3 sizes; every fit records its residual and
confidence bounds, so a noisy calibration is visible instead of silently
wrong.

Drift accounting: :func:`drift_fraction` (measured/modeled − 1) and
:func:`modeled_wall_step_s` define the modeled-vs-measured comparison the
plan records carry and ``--replan-drift-pct`` gates on.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.schedule.cost import CompressionCostTable, LinkParams
from repro_torch.core.schedule.topology import Tier, Topology

# (compressor, args) pairs calibrated by default — the compressed members
# of planner.DEFAULT_CANDIDATES (keys in the table are compressor NAMES:
# the cost model does not distinguish arg variants of one compressor).
CALIBRATION_SET: Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...] = (
    ("int8", ()),
    ("qsgd", (("levels", 127),)),
    ("topk", (("ratio", 0.01),)),
    ("sign", ()),
    ("int8_fused", ()),
    ("topk_fused", (("ratio", 0.01),)),
)

# Buffer sizes (f32 elements) the compression fit is anchored on: 1, 2 and
# 8 MiB dense — ≥3 sizes so the least-squares fit has a residual to report
# (the old two-point secant could not distinguish noise from signal).
CAL_SIZES: Tuple[int, ...] = (1 << 18, 1 << 19, 1 << 21)

CAL_WORLD = 8

# Payload sizes (f32 elements) the LINK fit is anchored on — spanning the
# α-dominated (16 KiB) through β-dominated (8 MiB) regimes so both
# coefficients are identified.
CAL_LINK_SIZES: Tuple[int, ...] = (1 << 12, 1 << 15, 1 << 18, 1 << 21)

# Algorithms timed per tier: psum (the all-reduce training actually runs)
# and the explicit ring share one phase formula, giving the joint fit
# algorithm diversity at no formula risk; tree is opt-in (power-of-two
# tiers only).
CAL_LINK_ALGOS: Tuple[str, ...] = ("psum", "ring")

CAL_LINK_REPEATS = 5


def _on_card(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in tree_leaves(tree))


def _block(tree) -> None:
    """Wait for the card when ``tree`` holds a CUDA tensor (the
    reference's ``block_until_ready``)."""
    if _on_card(tree):
        torch.cuda.synchronize()


def _time_best_s(fn, *args, repeats: int = 3) -> float:
    """min-of-N wall time of ``fn(*args)``; the first call (kernel builds,
    allocator warm-up) is discarded."""
    _block(args)
    _block(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# Least-squares fitting with confidence bounds
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AffineFit:
    """Least-squares ``t = intercept + slope·x`` with standard errors.

    ``slope_err``/``intercept_err`` are the 1-σ standard errors from the
    residual variance (``inf`` with <3 points: two points leave zero
    degrees of freedom, which is exactly the blindness the old two-point
    fit hid).  ``degenerate`` flags a non-increasing fit — timing noise
    swamping the size signal."""
    slope: float
    intercept: float
    slope_err: float
    intercept_err: float
    r2: float
    rms_s: float
    n: int
    degenerate: bool = False


def fit_affine(points: Sequence[Tuple[float, float]]) -> AffineFit:
    """Fit ``t = intercept + slope·x`` to ``(x, t)`` samples by least
    squares; see :class:`AffineFit` for what is reported."""
    pts = sorted((float(x), float(t)) for x, t in points)
    if len(pts) < 2:
        raise ValueError(f"need >= 2 points to fit a line, got {len(pts)}")
    x = np.asarray([p[0] for p in pts])
    t = np.asarray([p[1] for p in pts])
    X = np.stack([x, np.ones_like(x)], axis=1)
    coef, _, _, _ = np.linalg.lstsq(X, t, rcond=None)
    slope, intercept = float(coef[0]), float(coef[1])
    resid = t - X @ coef
    rss = float(resid @ resid)
    m = len(pts)
    tss = float(((t - t.mean()) ** 2).sum())
    r2 = 1.0 - rss / tss if tss > 0 else 1.0
    if m > 2:
        sigma2 = rss / (m - 2)
        try:
            cov = sigma2 * np.linalg.inv(X.T @ X)
            slope_err = math.sqrt(max(float(cov[0, 0]), 0.0))
            intercept_err = math.sqrt(max(float(cov[1, 1]), 0.0))
        except np.linalg.LinAlgError:
            slope_err = intercept_err = float("inf")
    else:
        slope_err = intercept_err = float("inf")
    return AffineFit(slope=slope, intercept=intercept, slope_err=slope_err,
                     intercept_err=intercept_err, r2=r2,
                     rms_s=math.sqrt(rss / m), n=m,
                     degenerate=slope <= 0.0)


def _fit(points: Sequence[Tuple[float, float]]
         ) -> Tuple[float, float, AffineFit]:
    """(bw_bytes_per_s, overhead_s, fit) from (n_bytes, seconds) samples:
    a least-squares affine fit over all sizes.  A non-increasing fit still
    degenerates to the through-origin secant (the planner needs SOME
    positive bandwidth), but now WARNS and flags the fit so the recorded
    table carries the degradation instead of silently reporting
    ``overhead_s = 0`` as measured."""
    fit = fit_affine(points)
    if fit.degenerate:
        b_max, t_max = max(points)
        warnings.warn(
            f"calibration fit degenerated: seconds non-increasing over "
            f"{fit.n} sizes (slope {fit.slope:.3e} s/B) — timing noise "
            f"swamps the size signal; clamping to a through-origin model",
            stacklevel=2)
        slope = max(t_max / b_max, 1e-15)
        return 1.0 / slope, 0.0, fit
    return 1.0 / fit.slope, max(fit.intercept, 0.0), fit


def measure_compression_costs(
        compressors: Sequence[Tuple[str, Tuple[Tuple[str, Any], ...]]]
        = CALIBRATION_SET,
        sizes: Sequence[int] = CAL_SIZES,
        cal_world: int = CAL_WORLD,
        repeats: int = 3,
        seed: int = 0,
        device=None) -> CompressionCostTable:
    """Time encode/decode per compressor at each size on ``device``
    (default: the card, raising without one) and fit the linear per-stage
    model.  Returns the table ``bucket_sync_phases`` consumes; each entry
    carries its fit quality (rms residual, R², degeneracy).  Inputs come
    from a ``torch.Generator`` seeded ``seed + i`` at the i-th size (the
    stochastic compressors draw from it too); the encode of a fused wire
    is its error-feedback hook on a zero residual, its decode the fused
    decode-and-sum of the payload stacked ``cal_world`` times."""
    from repro_torch.core.compression import get_compressor
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    entries = []
    quality = []
    for name, args in compressors:
        comp = get_compressor(name, **dict(args))
        enc_pts, dec_pts = [], []
        for i, n in enumerate(sizes):
            rng = torch.Generator(device).manual_seed(seed + i)
            g = torch.randn(int(n), generator=rng, dtype=torch.float32,
                            device=device)
            e = torch.zeros_like(g)
            n_bytes = float(n) * 4.0

            if comp.fused_ef_compress is not None:
                payload, meta, _ = comp.fused_ef_compress(g, e, 1.0)
                enc_pts.append((n_bytes, _time_best_s(
                    lambda g, e, c=comp: c.fused_ef_compress(g, e, 1.0),
                    g, e, repeats=repeats)))
            else:
                payload, meta = comp.compress(g, rng)
                enc_pts.append((n_bytes, _time_best_s(
                    lambda g, c=comp: c.compress(g, rng), g,
                    repeats=repeats)))

            if comp.fused_decode_sum is not None:
                gathered = tree_map(
                    lambda a: torch.stack([a] * int(cal_world)), payload)
                dec_pts.append((n_bytes, _time_best_s(
                    lambda p, c=comp, m=meta: c.fused_decode_sum(p, m),
                    gathered, repeats=repeats)))
            else:
                dec_pts.append((n_bytes, _time_best_s(
                    lambda p, c=comp, m=meta: c.decompress(p, m), payload,
                    repeats=repeats)))
        for stage, pts in (("encode", enc_pts), ("decode", dec_pts)):
            bw, c0, fit = _fit(pts)
            entries.append((f"{name}/{stage}", bw, c0))
            quality.append((f"{name}/{stage}", fit.rms_s, fit.r2,
                            fit.degenerate))
    return CompressionCostTable(entries=tuple(entries),
                                cal_world=int(cal_world),
                                quality=tuple(quality))


# ---------------------------------------------------------------------------
# Collective calibration: fitted per-tier LinkParams (DESIGN.md §13)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkFit:
    """Fitted (α, β) of ONE tier's fabric, with 1-σ confidence bounds and
    the fit residual.  ``degenerate`` marks fits with no wire signal: a
    1-rank tier (collectives are no-ops; the fit is raw dispatch
    overhead) or a negative coefficient clamped to zero."""
    alpha_s: float
    beta_s_per_byte: float
    alpha_err_s: float
    beta_err_s_per_byte: float
    r2: float
    rms_s: float
    n_samples: int
    degenerate: bool = False

    @property
    def link(self) -> LinkParams:
        return LinkParams(alpha_s=self.alpha_s,
                          beta_s_per_byte=self.beta_s_per_byte)

    def describe(self) -> str:
        bw = (1.0 / self.beta_s_per_byte / 1e9
              if self.beta_s_per_byte > 0 else float("inf"))
        return (f"α={self.alpha_s:.3e}±{self.alpha_err_s:.1e} s, "
                f"β⁻¹={bw:.2f} GB/s, rms={self.rms_s:.2e} s, "
                f"R²={self.r2:.3f}, n={self.n_samples}"
                + (" [degenerate]" if self.degenerate else ""))


def _phase_coeffs(algo: str, p: int, n_bytes: float
                  ) -> Optional[Tuple[float, float]]:
    """(∂t/∂α, ∂t/∂β) of one single-axis collective of ``n_bytes`` over
    ``p`` ranks — the design-matrix row linking a timed sample to the
    tier's (α, β).  Must mirror ``cost.allreduce_phases`` exactly: the
    fit is only as honest as the formula it inverts."""
    if p <= 1:
        return None
    if algo in ("ring", "psum"):
        return 2.0 * (p - 1), 2.0 * (p - 1) * n_bytes / p
    if algo == "tree":
        if p & (p - 1):
            return None          # tree needs a power-of-two axis
        return 2.0 * math.log2(p), 2.0 * math.log2(p) * n_bytes
    return None


def _fit_link(rows: Sequence[Tuple[float, float, float]]) -> LinkFit:
    """Joint least squares ``t = a·α + b·β`` over ``(a, b, t)`` rows from
    :func:`_phase_coeffs` — one fit per tier, pooling every (algo × size)
    sample.  Negative coefficients (noise) are clamped to 0 and flagged."""
    A = np.asarray([[r[0], r[1]] for r in rows])
    t = np.asarray([r[2] for r in rows])
    coef, _, _, _ = np.linalg.lstsq(A, t, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])
    resid = t - A @ coef
    rss = float(resid @ resid)
    m = len(rows)
    tss = float(((t - t.mean()) ** 2).sum())
    r2 = 1.0 - rss / tss if tss > 0 else 1.0
    if m > 2:
        sigma2 = rss / (m - 2)
        try:
            cov = sigma2 * np.linalg.inv(A.T @ A)
            a_err = math.sqrt(max(float(cov[0, 0]), 0.0))
            b_err = math.sqrt(max(float(cov[1, 1]), 0.0))
        except np.linalg.LinAlgError:
            a_err = b_err = float("inf")
    else:
        a_err = b_err = float("inf")
    degenerate = alpha < 0.0 or beta < 0.0
    if degenerate:
        warnings.warn(
            f"link fit degenerated (α={alpha:.3e}, β={beta:.3e}); "
            f"clamping negative coefficients to 0 — the measured fabric "
            f"is faster than the timing floor resolves", stacklevel=2)
    return LinkFit(alpha_s=max(alpha, 0.0),
                   beta_s_per_byte=max(beta, 0.0),
                   alpha_err_s=a_err, beta_err_s_per_byte=b_err,
                   r2=r2, rms_s=math.sqrt(rss / m), n_samples=m,
                   degenerate=degenerate)


def _fit_degenerate_tier(samples: Sequence[Tuple[float, float]]) -> LinkFit:
    """A 1-rank tier: the collective is a no-op, so the timings are pure
    dispatch overhead.  Fit ``t = α + n·β`` directly and flag it — the
    resulting near-zero link is the honest price of communication on a
    fabric with one member."""
    fit = fit_affine(samples)
    return LinkFit(alpha_s=max(fit.intercept, 0.0),
                   beta_s_per_byte=max(fit.slope, 0.0),
                   alpha_err_s=fit.intercept_err,
                   beta_err_s_per_byte=fit.slope_err,
                   r2=fit.r2, rms_s=fit.rms_s, n_samples=fit.n,
                   degenerate=True)


@dataclasses.dataclass(frozen=True)
class CalibratedTopology:
    """A :class:`Topology` whose links are FITTED from measured
    collectives, with per-tier fit residuals and confidence bounds.

    ``topology`` carries the fitted :class:`LinkParams` (each tier's
    ``link_name`` is ``"calibrated"`` and its ``fit`` field holds the
    :class:`LinkFit`), so it drops into every ``net`` argument of the
    cost model — ``as_topology`` unwraps this wrapper too, making a
    ``CalibratedTopology`` itself a valid ``net``.  ``samples`` keeps the
    raw ``(tier, algo, p, n_bytes, seconds)`` timings for offline refits
    (the deterministic CI calibration suite replays exactly such records).
    """
    topology: Topology
    fits: Tuple[Tuple[str, LinkFit], ...]      # (tier_name, fit), outer first
    samples: Tuple[Tuple[str, str, int, float, float], ...] = ()

    @property
    def world(self) -> int:
        return self.topology.world

    def fit_for(self, tier_name: str) -> Optional[LinkFit]:
        for name, fit in self.fits:
            if name == tier_name:
                return fit
        return None

    def describe(self) -> str:
        lines = [f"calibrated topology: {self.topology.spec()} "
                 f"({len(self.samples)} timed collectives)"]
        for name, fit in self.fits:
            lines.append(f"  {name}: {fit.describe()}")
        return "\n".join(lines)

    def allreduce_error_s(self, n_bytes: float, p: int) -> float:
        """1-σ propagated fit error of one ring allreduce of ``n_bytes``
        over ``p`` ranks, priced like the cost model prices it: the ring
        formula on the bottleneck tier, with that tier's coefficient
        errors in place of its coefficients."""
        if p <= 1:
            return 0.0
        t = self.topology.bottleneck(n_bytes / p)
        fit = self.fit_for(t.name)
        if fit is None or not math.isfinite(fit.alpha_err_s):
            return 0.0
        return 2.0 * (p - 1) * (fit.alpha_err_s
                                + (n_bytes / p) * fit.beta_err_s_per_byte)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "world": self.world,
            "tiers": [{
                "name": t.name, "size": t.size,
                "alpha_s": f.alpha_s,
                "beta_s_per_byte": f.beta_s_per_byte,
                "alpha_err_s": f.alpha_err_s,
                "beta_err_s_per_byte": f.beta_err_s_per_byte,
                "r2": f.r2, "rms_s": f.rms_s,
                "n_samples": f.n_samples, "degenerate": f.degenerate,
            } for t, (_, f) in zip(self.topology.tiers, self.fits)],
            "samples": [{"tier": tn, "algo": al, "p": p,
                         "n_bytes": nb, "seconds": s}
                        for tn, al, p, nb, s in self.samples],
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "CalibratedTopology":
        tiers, fits = [], []
        for e in obj["tiers"]:
            fit = LinkFit(
                alpha_s=float(e["alpha_s"]),
                beta_s_per_byte=float(e["beta_s_per_byte"]),
                alpha_err_s=float(e["alpha_err_s"]),
                beta_err_s_per_byte=float(e["beta_err_s_per_byte"]),
                r2=float(e["r2"]), rms_s=float(e["rms_s"]),
                n_samples=int(e["n_samples"]),
                degenerate=bool(e["degenerate"]))
            tiers.append(Tier(e["name"], int(e["size"]), fit.link,
                              link_name="calibrated", fit=fit))
            fits.append((e["name"], fit))
        samples = tuple((s["tier"], s["algo"], int(s["p"]),
                         float(s["n_bytes"]), float(s["seconds"]))
                        for s in obj.get("samples", []))
        return cls(topology=Topology(tuple(tiers)), fits=tuple(fits),
                   samples=samples)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CalibratedTopology":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _collective_timer(groups: Dict[str, Any], device: torch.device,
                      repeats: int) -> Callable[..., float]:
    """The default ``timer``: min-of-N wall time of one
    ``collectives.api.allreduce`` over ONE tier's process group
    (``groups[tier name]``), every rank holding the full payload, the
    edge training runs.  ``psum`` sums in place; the repeated sums of one
    buffer stay finite at these sizes."""
    from repro_torch.core.collectives.api import allreduce

    def timer(algo: str, axis: str, p: int, n_bytes: float) -> float:
        n_elems = max(int(n_bytes // 4), 1)
        x = torch.arange(n_elems, dtype=torch.float32, device=device)
        group = groups[axis]
        return _time_best_s(lambda v: allreduce(v, algo, (group,)), x,
                            repeats=repeats)

    return timer


def calibrate_topology(topology: Optional[Topology] = None, *,
                       axes=None,
                       sizes: Sequence[int] = CAL_LINK_SIZES,
                       algos: Sequence[str] = CAL_LINK_ALGOS,
                       repeats: int = CAL_LINK_REPEATS,
                       timer: Optional[Callable[..., float]] = None,
                       device=None) -> CalibratedTopology:
    """Time real collectives per (tier × algorithm × payload size) and fit
    per-tier (α, β) by joint least squares over the phase formulas of
    ``cost.allreduce_phases``.

    ``topology`` names the tiers to calibrate (default: the flat
    single-tier fabric over every rank of the default process group, tier
    ``"data"``).  With the default timer the topology's world must be the
    process world — calibration measures the fabric it runs on, not a
    model of another one — and every rank of the default process group
    must call this function (the timed collectives run on every rank).
    Each tier's process group comes from ``axes`` (one group per tier,
    innermost first, as ``collectives.axes_for_topology`` returns them;
    made by it when None), and the payloads lie on ``device`` (default:
    the card for an NCCL group, the CPU for gloo).  ``timer(algo, axis, p, n_bytes) -> seconds``
    injects a fake fabric for tests and for replaying recorded samples;
    injected timers need no process group, so any topology can be refitted
    offline.  A one-rank tier (NCCL world 1 on one card) times the
    dispatch alone and fits it flagged degenerate.
    """
    import torch.distributed as dist

    if topology is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        topology = Topology.flat(world, LinkParams(), name="data")
    if timer is None:
        from repro_torch.core.collectives.api import axes_for_topology
        n_ranks = dist.get_world_size()
        if topology.world != n_ranks:
            raise ValueError(
                f"cannot calibrate {topology.spec()} (world "
                f"{topology.world}) on {n_ranks} rank(s): "
                f"calibration times the fabric it runs on — pass a "
                f"topology matching the process group, or inject a timer")
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend() == "nccl"
                      else torch.device("cpu"))
        if axes is None:
            axes = axes_for_topology(topology)
        groups = {t.name: g for t, g in zip(topology.tiers,
                                            reversed(tuple(axes)))}
        timer = _collective_timer(groups, torch.device(device), repeats)

    fits: List[Tuple[str, LinkFit]] = []
    tiers: List[Tier] = []
    samples: List[Tuple[str, str, int, float, float]] = []
    for tier in topology.tiers:
        p = int(tier.size)
        rows: List[Tuple[float, float, float]] = []
        raw: List[Tuple[float, float]] = []
        for algo in algos:
            for n in sizes:
                n_bytes = float(int(n) * 4)
                coeffs = _phase_coeffs(algo, p, n_bytes)
                if p > 1 and coeffs is None:
                    continue          # algo unusable on this axis (tree)
                t = float(timer(algo, tier.name, p, n_bytes))
                samples.append((tier.name, algo, p, n_bytes, t))
                raw.append((n_bytes, t))
                if coeffs is not None:
                    rows.append((coeffs[0], coeffs[1], t))
        fit = _fit_link(rows) if rows else _fit_degenerate_tier(raw)
        fits.append((tier.name, fit))
        tiers.append(Tier(tier.name, p, fit.link, link_name="calibrated",
                          fit=fit))
    return CalibratedTopology(topology=Topology(tuple(tiers)),
                              fits=tuple(fits), samples=tuple(samples))


def resolve_calibration(spec) -> Optional[CalibratedTopology]:
    """Coerce a ``calibration`` argument — ``None``, an existing
    :class:`CalibratedTopology`, or a path to a saved one — into the
    object ``plan_auto`` consumes."""
    if spec is None or isinstance(spec, CalibratedTopology):
        return spec
    return CalibratedTopology.load(spec)


# ---------------------------------------------------------------------------
# Modeled-vs-measured drift (plan records, --replan-drift-pct)
# ---------------------------------------------------------------------------

def drift_fraction(modeled_s: float, measured_s: float) -> float:
    """measured/modeled − 1: +0.25 means the measured step ran 25% slower
    than the model predicted.  The drift-report quantity and the
    re-planning trigger."""
    if not modeled_s > 0.0:
        raise ValueError(f"modeled time must be > 0, got {modeled_s}")
    return measured_s / modeled_s - 1.0


def modeled_wall_step_s(modeled_step_s: float, t_backward_s: float) -> float:
    """The plan's prediction of one WALL-CLOCK step.  ``modeled_step_s``
    prices the backward+sync window only (the overlap objective); the
    forward pass runs outside it and costs half the backward under the
    standard bwd = 2·fwd ratio ``profile_backward`` assumes — so the
    wall-step prediction adds ``t_backward_s / 2``.  Optimizer update and
    host dispatch stay unmodeled; they land in the drift number, which is
    the point of reporting it."""
    return float(modeled_step_s) + 0.5 * float(t_backward_s)


def plan_comm_error_s(plan, calibration: Optional[CalibratedTopology]
                      ) -> float:
    """1-σ propagated link-fit error of a ``CommPlan``'s wire time: the
    per-bucket ring-formula error (``allreduce_error_s``) summed over
    buckets.  0 without a calibration (preset links carry no error
    model)."""
    if calibration is None:
        return 0.0
    return sum(calibration.allreduce_error_s(b.bucket_bytes, plan.world)
               for b in plan.buckets)
