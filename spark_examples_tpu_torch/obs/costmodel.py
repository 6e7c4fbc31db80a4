"""Per-job cost predictions: the admission-time estimate the fleet audits.

The port's copy of ``spark_examples_tpu/obs/costmodel.py``: the formulas
are the reference's, the rates are the port's own, measured on an H100.
:class:`CostPrediction` is a small, JSON-round-trippable envelope stamped
at admission into the job doc, the journal's ``accepted`` record (so it
survives compaction, restart, and replica steal exactly like the trace
id), and the per-job manifest (``obs/manifest.py:cost_block``).

The prediction combines two sources:

- **link transfer** — a schedule simulator's critical-path seconds, when
  the configuration proves a ring schedule on a declared topology (the
  reference's ``graftcheck sched``; the port's plan does not take a
  topology yet, so this term is ``None`` there);
- **compute throughput** — a coarse sites-per-second model
  (:data:`SITES_PER_SECOND`) plus fixed dispatch overhead and a cold
  penalty. Coarse is fine: the calibration ledger
  (``obs/calibration.py``) learns the per-geometry measured/predicted
  ratio, so the model only has to be *monotone and positive* — the
  learned ratio absorbs the constant.

The floor (:data:`MIN_PREDICTED_SECONDS`) keeps every prediction
strictly positive, which makes deadline-feasibility deterministic: a
submitted ``deadline_seconds`` below the floor is infeasible for ANY
job.

The four rates come from ``python -m
spark_examples_tpu_torch.experiments.cost_rates`` on one NVIDIA H100 80GB
HBM3 at its 700.00 W power limit, in a process whose kernel libraries
were already built (``chip_smoke.py`` prints the same measurement on
every run). No imports from ``check/`` or ``serve/`` here — this module
sits below both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

#: Candidate sites per second of the device-generation Gramian: chr17's
#: 811,953 sites (2,504 samples, 16,384-site blocks) over the median of
#: three warm ``ingest+similarity`` stages, 0.0102 s (NVIDIA H100 80GB
#: HBM3, 700.00 W; ``experiments/cost_rates.py``). The rest of a run's wall
#: does not grow with the sites: it is :data:`DISPATCH_OVERHEAD_SECONDS`.
SITES_PER_SECOND: float = 79_305_853.89

#: Bytes per second of the fallback when the site count has no static
#: bound (file/REST cohorts): the host-memory bound
#: (``check/hostmem.py:conf_host_peak_bytes``) of the host-fed packed arm
#: over 2 Mb of chr17 at 2,504 samples, 4,310,351,872 bytes, over that
#: arm's median warm wall less the overhead, 2.5624 - 0.0638 s (NVIDIA
#: H100 80GB HBM3, 700.00 W; ``experiments/cost_rates.py``). The wall is
#: the host's block building.
HOST_BYTES_PER_SECOND: float = 1_725_110_154.44

#: Fixed per-job overhead: the median wall of three warm runs over 1 kb
#: (11 candidate sites) at 2,504 samples — the driver's set-up, the
#: centering and eigensolve of the N×N Gramian, the printed rows (NVIDIA
#: H100 80GB HBM3, 700.00 W; ``experiments/cost_rates.py``).
DISPATCH_OVERHEAD_SECONDS: float = 0.0638

#: One-time penalty when the geometry ledger says this compile fingerprint
#: has never been built: what a never-built geometry's first run costs over
#: its warm runs in a process whose libraries are already warm (the
#: reference's meaning). Chr17 at 2,000, 2,200 and 2,400 samples after the
#: warm 2,504-sample runs, each first run less the median of its next
#: three: 0.0037, 0.1161 and -0.0036 s, the median 0.0037 s — the port
#: builds nothing per geometry (NVIDIA H100 80GB HBM3, 700.00 W;
#: ``experiments/cost_rates.py``). A fresh process's own first-run cost
#: (0.8130 s there: the libraries' load, cuSOLVER's set-up) is no part of
#: it; the serve daemon pays that at start-up.
COLD_COMPILE_SECONDS: float = 0.0037

#: Hard positive floor on every prediction (see module docstring).
MIN_PREDICTED_SECONDS: float = 0.05

#: The two compile expectations a prediction can carry.
COMPILE_WARM = "warm"
COMPILE_COLD = "cold"


@dataclass
class CostPrediction:
    """One job's admission-time cost estimate, JSON-round-trippable.

    ``predicted_seconds`` is the headline number (floored, penalty
    included); the remaining fields are its provenance, kept so the
    post-mortem report and the calibration fold can attribute error to
    the right term instead of a single opaque scalar.
    """

    predicted_seconds: float
    kind: str = "pca"
    fingerprint: Optional[str] = None
    compile: str = COMPILE_COLD
    compute_seconds: float = 0.0
    sched_seconds: Optional[float] = None
    sites: Optional[int] = None
    host_peak_bytes: Optional[int] = None
    ring_bytes_per_flush: Optional[int] = None
    calibrated_seconds: Optional[float] = None
    calibration_ratio: Optional[float] = None
    calibration_samples: int = 0

    def to_dict(self) -> Dict[str, object]:
        """The additive envelope block (job doc / journal / manifest)."""
        out: Dict[str, object] = {
            "predicted_seconds": float(self.predicted_seconds),
            "kind": self.kind,
            "compile": self.compile,
            "compute_seconds": float(self.compute_seconds),
        }
        if self.fingerprint is not None:
            out["fingerprint"] = self.fingerprint
        if self.sched_seconds is not None:
            out["sched_seconds"] = float(self.sched_seconds)
        if self.sites is not None:
            out["sites"] = int(self.sites)
        if self.host_peak_bytes is not None:
            out["host_peak_bytes"] = int(self.host_peak_bytes)
        if self.ring_bytes_per_flush is not None:
            out["ring_bytes_per_flush"] = int(self.ring_bytes_per_flush)
        if self.calibrated_seconds is not None:
            out["calibrated_seconds"] = float(self.calibrated_seconds)
        if self.calibration_ratio is not None:
            out["calibration_ratio"] = float(self.calibration_ratio)
        if self.calibration_samples:
            out["calibration_samples"] = int(self.calibration_samples)
        return out

    @classmethod
    def from_dict(cls, doc: Mapping) -> Optional["CostPrediction"]:
        """Parse a stamped prediction back; ``None`` on junk — a torn or
        foreign ``cost`` block must never kill a journal replay."""
        try:
            predicted = float(doc["predicted_seconds"])
        except (KeyError, TypeError, ValueError):
            return None
        if not (predicted == predicted and predicted >= 0):
            return None

        def _opt_float(key):
            value = doc.get(key)
            return None if value is None else float(value)

        def _opt_int(key):
            value = doc.get(key)
            return None if value is None else int(value)

        try:
            return cls(
                predicted_seconds=predicted,
                kind=str(doc.get("kind") or "pca"),
                fingerprint=(
                    str(doc["fingerprint"])
                    if doc.get("fingerprint") is not None
                    else None
                ),
                compile=(
                    COMPILE_WARM
                    if doc.get("compile") == COMPILE_WARM
                    else COMPILE_COLD
                ),
                compute_seconds=float(doc.get("compute_seconds") or 0.0),
                sched_seconds=_opt_float("sched_seconds"),
                sites=_opt_int("sites"),
                host_peak_bytes=_opt_int("host_peak_bytes"),
                ring_bytes_per_flush=_opt_int("ring_bytes_per_flush"),
                calibrated_seconds=_opt_float("calibrated_seconds"),
                calibration_ratio=_opt_float("calibration_ratio"),
                calibration_samples=int(doc.get("calibration_samples") or 0),
            )
        except (TypeError, ValueError):
            return None

    @property
    def best_estimate_seconds(self) -> float:
        """The number deadline feasibility compares against: the
        calibrated estimate when the ledger has seen this geometry, the
        raw model otherwise."""
        if self.calibrated_seconds is not None:
            return self.calibrated_seconds
        return self.predicted_seconds


def estimate_seconds(
    *,
    sites: Optional[int],
    host_peak_bytes: Optional[int],
    sched_seconds: Optional[float],
    cold: bool,
) -> Dict[str, float]:
    """The model itself, pure arithmetic over geometry facts: compute
    term from the static site count (bytes-proxy fallback), max'd with
    the schedule simulator's link term (compute and transfer overlap —
    the double-buffered feed), plus overhead and the cold penalty.
    Returns ``{"compute_seconds", "predicted_seconds"}``."""
    if sites is not None and sites > 0:
        compute = float(sites) / SITES_PER_SECOND
    elif host_peak_bytes is not None and host_peak_bytes > 0:
        compute = float(host_peak_bytes) / HOST_BYTES_PER_SECOND
    else:
        compute = 0.0
    body = max(compute, float(sched_seconds or 0.0))
    predicted = DISPATCH_OVERHEAD_SECONDS + body
    if cold:
        predicted += COLD_COMPILE_SECONDS
    return {
        "compute_seconds": compute,
        "predicted_seconds": max(predicted, MIN_PREDICTED_SECONDS),
    }


__all__ = [
    "COLD_COMPILE_SECONDS",
    "COMPILE_COLD",
    "COMPILE_WARM",
    "CostPrediction",
    "DISPATCH_OVERHEAD_SECONDS",
    "HOST_BYTES_PER_SECOND",
    "MIN_PREDICTED_SECONDS",
    "SITES_PER_SECOND",
    "estimate_seconds",
]
