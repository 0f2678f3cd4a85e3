"""Bucket-cap search: replay the timing model through the bucket
pipeline simulator and pick the collective schedule.

Counterpart: ``mxnet_tpu/autotune/search.py``.  The right cap is a
trade-off once each collective has a launch cost:

  * caps too large → the last buckets' collectives run past the end of
    backward (exposed; the one monolithic all-reduce is the limit);
  * caps too small → B launch costs dominate.

The sweep walks caps of 1–32 MiB with first/last-bucket asymmetry (a
small first bucket starts the exchange early in backward, a large last
bucket folds the tail, whose collectives overlap nothing, into fewer
launches) and scores each candidate by
``parallel.scaling.simulate_bucketed_overlap`` under byte-weighted
readiness at the target rank count: eff = t_step / (t_step + exposed).
The 4 MiB default is scored under the same model and returned in the
plan's ``score`` block, so "tuned beats default" is a claim with its
assumptions beside it.

The link bandwidth comes from the evidence (``measured_GBps``: a
trace's collective occupancy, a flight dump's wire durations) or from
the caller (``ici_GBps``, the name kept for parity with the JAX
package; here it is the bandwidth of whatever link the ranks share, in
GB/s).  With neither, :func:`tune` raises: the port assumes no figure.
The launch cost ``DEFAULT_COLL_LATENCY_S`` is the JAX package's stated
assumption, named in every plan's ``assumptions``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .timing import TimingModel

__all__ = ["CAPS_MIB", "DEFAULT_COLL_LATENCY_S", "FIRST_FRACS",
           "LAST_MULTS", "plan_bucket_bytes", "resolve_bandwidth", "tune"]

#: the 1–32 MiB cap ladder (ROADMAP item 3's stated sweep range)
CAPS_MIB: Tuple[int, ...] = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)

#: per-collective launch cost assumption (the JAX package's; ring setup
#: and dispatch), stated in every emitted plan, overridable per tune()
DEFAULT_COLL_LATENCY_S = 5e-6

_MIB = 1024 * 1024

#: first-bucket cap as a fraction of the mid cap (1.0 = symmetric)
FIRST_FRACS: Tuple[float, ...] = (1.0, 0.5, 0.25)

#: last-bucket cap as a multiple of the mid cap (1 = symmetric)
LAST_MULTS: Tuple[int, ...] = (1, 2, 4)


def _virtual_partition(units: Sequence[Tuple[int, str]], cap: int,
                       first_cap: Optional[int] = None,
                       last_cap: Optional[int] = None) -> List[int]:
    """Repartition recorded bucket atoms under new caps: greedy fill in
    issue order (same contract as buckets.partition — dtype never mixes,
    bucket 0 honors the first cap), except an atom LARGER than its cap
    splits into equal chunks (the recorded granularity hides the leaf
    boundaries, so an even split is the honest approximation)."""
    cap = max(int(cap), 1)
    fcap = cap if first_cap is None else max(int(first_cap), 1)
    out: List[Tuple[int, str]] = []  # (bytes, dtype) per bucket
    cur, cur_dtype = 0, None
    for nbytes, dtype in units:
        nbytes = int(nbytes)
        active = fcap if not out else cap
        if cur and (cur_dtype != dtype or cur + nbytes > active):
            out.append((cur, cur_dtype))
            cur, cur_dtype = 0, None
            active = fcap if not out else cap
        if nbytes > active and not cur:
            # split the oversized atom across ceil(n/cap) buckets
            n_chunks = -(-nbytes // active)
            chunk = nbytes // n_chunks
            sizes = [chunk] * n_chunks
            sizes[-1] += nbytes - chunk * n_chunks
            out.extend((s, dtype) for s in sizes)
            continue
        cur += nbytes
        cur_dtype = dtype
    if cur:
        out.append((cur, cur_dtype))
    if last_cap is not None and int(last_cap) > cap:
        lcap = int(last_cap)
        # fold trailing buckets together — never into bucket 0 (that
        # would undo the first-bucket asymmetry) and never across a
        # dtype boundary (the same contract buckets.partition enforces;
        # a cross-dtype fold would score a schedule the runtime
        # partitioner can never build)
        while len(out) > 2 and out[-2][1] == out[-1][1] \
                and out[-2][0] + out[-1][0] <= lcap:
            tail = out.pop()
            prev = out.pop()
            out.append((prev[0] + tail[0], prev[1]))
    return [b for b, _dt in out]


def plan_bucket_bytes(model: TimingModel, cap: int,
                      first_cap: Optional[int] = None,
                      last_cap: Optional[int] = None) -> List[int]:
    """Candidate bucket payloads under (cap, first, last).  Leaf
    granularity repartitions through buckets.partition itself — the
    plan the search scores IS the plan dp.py will build when the caps
    are applied; bucket granularity approximates over the recorded
    atoms (_virtual_partition)."""
    if model.granularity == "leaf":
        from ..parallel import buckets as _buckets

        entries = []
        # model.units are in issue order; partition() reverses its
        # (layer-order) input, so hand it the layer-order flip
        for i, (nbytes, dtype) in enumerate(reversed(model.units)):
            # itemsize via the partitioner's own dtype resolution (ONE
            # fallback table for extension dtypes, never two)
            item = _buckets._nbytes((1,), dtype)
            if nbytes % item:
                item, dtype = 1, "uint8"  # odd payload: count raw bytes
            entries.append((i, (nbytes // item,), dtype))
        plan = _buckets.partition(entries, cap,
                                  first_cap_bytes=first_cap,
                                  last_cap_bytes=last_cap)
        return [int(b.nbytes) for b in plan]
    return _virtual_partition(model.units, cap, first_cap, last_cap)


def resolve_bandwidth(model: TimingModel, ici_GBps: Optional[float] = None
                      ) -> Tuple[float, str, str]:
    """``(GB/s, ici_GBps_source, bandwidth_source)``: the caller's
    ``ici_GBps``, else the model's measured bandwidth; raises when there
    is neither (the port assumes no link's figure)."""
    if ici_GBps is not None:
        if not ici_GBps > 0:
            raise ValueError("ici_GBps must be positive, got %r"
                             % (ici_GBps,))
        return float(ici_GBps), "explicit", "explicit"
    if model.measured_GBps:
        if (model.source or {}).get("kind") == "trace":
            return (model.measured_GBps,
                    "measured (device-trace collective occupancy)",
                    "trace")
        return (model.measured_GBps,
                "measured (flight-dump wire durations)", "flight")
    raise ValueError(
        "no link bandwidth: the evidence (%s) measured none, so pass "
        "ici_GBps= (GB/s of the link the ranks share; --ici-gbps on the "
        "command line)" % ((model.source or {}).get("kind") or "model"))


def tune(model: TimingModel, *, chips: int = 256,
         step_time_s: Optional[float] = None,
         ici_GBps: Optional[float] = None,
         backward_frac: float = 2.0 / 3.0,
         coll_latency_s: float = DEFAULT_COLL_LATENCY_S,
         caps_mib: Sequence[int] = CAPS_MIB,
         first_fracs: Sequence[float] = FIRST_FRACS,
         last_mults: Sequence[int] = LAST_MULTS,
         accum_steps: Optional[int] = None) -> Dict:
    """Sweep the cap ladder and return the tuned-plan dict (the JSON
    ``plan.save_plan`` persists and ``buckets.plan_with_tuning``
    consumes).  ``ici_GBps``: the link bandwidth in GB/s; without it the
    model's measured one, and without either this raises
    (:func:`resolve_bandwidth`).

    ``accum_steps`` (default: the MXNET_GRAD_ACCUM_STEPS env, via
    remat.grad_accum_steps) makes the scoring accum-aware: under
    microbatch accumulation every bucket is only issueable during the
    LAST microbatch's backward (((A-1)+share)/A readiness), so the
    sweep stops rewarding small early buckets for overlap windows the
    accumulated schedule does not have."""
    from ..parallel import buckets as _buckets
    from ..parallel import scaling as _scaling
    from ..remat import grad_accum_steps as _accum

    accum = _accum(accum_steps)

    step = step_time_s if step_time_s is not None else model.step_time_s
    if step is None or step <= 0:
        raise ValueError(
            "no step time: the overlap model pivots on the measured "
            "single-chip step time — pass step_time_s/--step-time, or "
            "tune from a SCALING report (which carries it)")
    bw, bw_source, bandwidth_source = resolve_bandwidth(model, ici_GBps)

    # measured-overlap calibration: when the model came from a device
    # trace, the simulator's analytic overlap is checked against the
    # MEASURED compute/comm overlap of the recorded layout and every
    # candidate's exposed time is scaled by the resulting factor — a
    # simulator that is optimistic about this fabric (e.g. a serial
    # executor that overlaps nothing) stops ranking candidates by an
    # overlap it cannot deliver.
    o_meas = getattr(model, "measured_overlap_frac", None)
    exposure_scale = None
    if o_meas is not None:
        rec_sim = _scaling.simulate_bucketed_overlap(
            [b for b, _dt in model.units], step, chips, bw,
            backward_frac, coll_latency_s=coll_latency_s,
            readiness="bytes", accum_steps=accum)
        o_sim = rec_sim["overlap"]
        if o_sim < 1.0:
            exposure_scale = (1.0 - float(o_meas)) / (1.0 - o_sim)
            exposure_scale = min(max(exposure_scale, 0.25), 4.0)

    def score(bucket_bytes):
        sim = _scaling.simulate_bucketed_overlap(
            bucket_bytes, step, chips, bw, backward_frac,
            coll_latency_s=coll_latency_s, readiness="bytes",
            accum_steps=accum)
        exposed = sim["exposed_s"]
        if exposure_scale is not None:
            exposed = exposed * exposure_scale
        eff = step / (step + exposed)
        return eff, sim

    default_bb = plan_bucket_bytes(model, _buckets.DEFAULT_BUCKET_BYTES)
    default_eff, default_sim = score(default_bb)

    best = None
    n_candidates = 0
    for cap_mib in caps_mib:
        cap = int(cap_mib * _MIB)
        for ff in first_fracs:
            first = max(int(cap * ff), 1)
            for lm in last_mults:
                last = cap * int(lm)
                bb = plan_bucket_bytes(model, cap, first, last)
                eff, sim = score(bb)
                n_candidates += 1
                # tie-break toward fewer buckets (less launch-schedule
                # surface for the same modeled efficiency)
                key = (round(eff, 6), -len(bb))
                if best is None or key > best["key"]:
                    best = {"key": key, "eff": eff, "sim": sim,
                            "cap": cap, "first": first, "last": last,
                            "bucket_bytes": bb}
    assert best is not None

    assumptions = {
        "ici_GBps": bw, "ici_GBps_source": bw_source,
        "bandwidth_source": bandwidth_source,
        "backward_frac": backward_frac,
        "coll_latency_s": coll_latency_s,
        "readiness": "bytes",
        "step_time_s": step,
        "grad_accum_steps": accum,
    }
    if exposure_scale is not None:
        assumptions["overlap_calibration"] = {
            "measured_overlap_frac": float(o_meas),
            "simulated_overlap_recorded_layout": o_sim,
            "exposure_scale": exposure_scale,
        }
    projection = _scaling.project_efficiency_bucketed(
        best["bucket_bytes"], step, ici_GBps=bw,
        backward_frac=backward_frac, coll_latency_s=coll_latency_s,
        readiness="bytes", accum_steps=accum)
    return {
        "format": "mxnet-tpu-autotune-plan",
        "version": 1,
        "cap_bytes": best["cap"],
        "first_cap_bytes": best["first"],
        "last_cap_bytes": best["last"],
        "n_buckets": len(best["bucket_bytes"]),
        "bucket_bytes": [int(b) for b in best["bucket_bytes"]],
        "fingerprint": model.fingerprint(),
        "score": {
            "chips": int(chips),
            "eff": round(best["eff"], 4),
            "exposed_s": best["sim"]["exposed_s"],
            "overlap": best["sim"]["overlap"],
            "default_cap_bytes": _buckets.DEFAULT_BUCKET_BYTES,
            "default_eff": round(default_eff, 4),
            "default_exposed_s": default_sim["exposed_s"],
            "default_n_buckets": len(default_bb),
            "beats_default": bool(best["eff"] >= default_eff),
            "n_candidates": n_candidates,
            **({"measured": {
                "overlap_frac": float(o_meas),
                "bucket_occupancy": getattr(model, "bucket_occupancy",
                                            None),
                "source": "trace",
            }} if o_meas is not None else {}),
        },
        "assumptions": assumptions,
        "projection": projection,
        "source": model.source,
    }
