"""Tuned-plan persistence and resolution: the loop's closing half.

Counterpart: ``mxnet_tpu/autotune/plan.py`` (the same file format,
``mxnet-tpu-autotune-plan`` v1, so a plan written by either package is
applied by the other).  ``search.tune`` emits a plan dict; this module
writes and reads it as JSON and answers the one question
``parallel/buckets.plan_with_tuning`` asks at a step's build: which caps
should this gradient exchange use?

  1. ``MXNET_AUTOTUNE_PLAN`` — an explicit plan file, applied whatever
     its fingerprint (a mismatch logs a warning); an unreadable or
     invalid file raises.
  2. ``MXNET_AUTOTUNE_DIR`` — a directory of ``*.json`` plans, scanned
     for one whose fingerprint (total gradient bytes and, at leaf
     granularity, the unit count) matches; other files are skipped.
  3. Neither → ``(None, None)``: ``MXNET_KVSTORE_BUCKET_BYTES`` applies.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Tuple

from .. import env as _env

__all__ = ["PLAN_FORMAT", "PLAN_VERSION", "save_plan", "load_plan",
           "default_plan_path", "resolve_caps"]

PLAN_FORMAT = "mxnet-tpu-autotune-plan"
PLAN_VERSION = 1

_log = logging.getLogger(__name__)


def save_plan(plan: Dict, path: str) -> str:
    """Atomic plan write (write-temp + os.replace — the checkpoint
    layer's crash-consistency idiom)."""
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(plan, f, indent=1)
    os.replace(tmp, path)
    return path


def load_plan(path: str) -> Dict:
    """Read + validate one tuned-plan JSON; raises ValueError on
    anything that is not a current-format plan."""
    with open(path) as f:
        plan = json.load(f)
    if not isinstance(plan, dict) or plan.get("format") != PLAN_FORMAT:
        raise ValueError("%r is not a tuned-plan file (format %r)"
                         % (path, PLAN_FORMAT))
    if int(plan.get("version", -1)) > PLAN_VERSION:
        raise ValueError(
            "tuned plan %r is format version %s, newer than this "
            "build's %d — refusing to guess at its semantics"
            % (path, plan.get("version"), PLAN_VERSION))
    if not isinstance(plan.get("cap_bytes"), int) or plan["cap_bytes"] < 1:
        raise ValueError("tuned plan %r has no positive cap_bytes" % path)
    return plan


def default_plan_path(plan: Dict, directory: str) -> str:
    """Canonical filename inside MXNET_AUTOTUNE_DIR: fingerprinted so
    plans for different models/dtypes coexist."""
    fp = plan.get("fingerprint") or {}
    return os.path.join(
        directory, "autotune_plan_%s_%s.json"
        % (fp.get("total_bytes", "unknown"),
           (fp.get("dtype") or "any").replace("/", "_")))


def _caps(plan: Dict, path: str) -> Dict:
    return {"cap_bytes": int(plan["cap_bytes"]),
            "first_cap_bytes": plan.get("first_cap_bytes"),
            "last_cap_bytes": plan.get("last_cap_bytes"),
            "plan_path": path,
            "score": plan.get("score"),
            "fingerprint": plan.get("fingerprint")}


def _fingerprint_matches(plan: Dict, total_bytes: Optional[int],
                         n_grads: Optional[int]) -> bool:
    fp = plan.get("fingerprint") or {}
    if total_bytes is not None and fp.get("total_bytes") is not None \
            and int(fp["total_bytes"]) != int(total_bytes):
        return False
    # unit counts only comparable at matching granularity: a
    # bucket-granularity plan legitimately has far fewer units than
    # the model has gradient leaves
    if n_grads is not None and fp.get("granularity") == "leaf" \
            and fp.get("n_units") is not None \
            and int(fp["n_units"]) != int(n_grads):
        return False
    return True


def resolve_caps(total_bytes: Optional[int] = None,
                 n_grads: Optional[int] = None
                 ) -> Tuple[Optional[Dict], Optional[str]]:
    """The caps the gradient exchange being built should use, or
    ``(None, None)`` when no tuned plan applies (see module docstring
    for the precedence + failure semantics)."""
    explicit = _env.get_str("MXNET_AUTOTUNE_PLAN")
    if explicit:
        plan = load_plan(explicit)  # unreadable/invalid: raise loudly
        if not _fingerprint_matches(plan, total_bytes, n_grads):
            _log.warning(
                "MXNET_AUTOTUNE_PLAN %s was tuned for fingerprint %s "
                "but this exchange is %s bytes / %s grads — applying "
                "anyway (explicit plan wins); retune if this is not "
                "the model you meant", explicit, plan.get("fingerprint"),
                total_bytes, n_grads)
        return _caps(plan, explicit), explicit

    directory = _env.get_str("MXNET_AUTOTUNE_DIR")
    if directory and os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".json"):
                continue
            path = os.path.join(directory, name)
            try:
                plan = load_plan(path)
            except (OSError, ValueError, json.JSONDecodeError):
                continue  # the dir is a cache: skip non-plans
            if _fingerprint_matches(plan, total_bytes, n_grads):
                return _caps(plan, path), path
    return None, None
