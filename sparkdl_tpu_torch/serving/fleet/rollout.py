"""Rollout reports (port of ``sparkdl_tpu/serving/fleet/rollout.py``), in
part: :func:`head_swap_report`, the head fan-out's proof that a per-tenant
head mutation never recompiled the backbone.  The canary ``Rollout``
itself is ROADMAP.md queue A item 5.2."""

from __future__ import annotations

from typing import Any, Dict


def head_swap_report(name: str, tenant: str, op: str,
                     exec_before: Dict[int, Dict[str, Any]],
                     exec_now: Dict[int, Dict[str, Any]],
                     bank_before: Dict[str, Any],
                     bank_now: Dict[str, Any],
                     fingerprint_before: Any,
                     fingerprint_now: Any) -> Dict[str, Any]:
    """The no-backbone-recompile report of one head mutation, with the JAX
    package's keys and formula.  Three witnesses:

    * per backbone bucket, the captured graph after the mutation is the
      SAME object as before (``shared_jit``; ``Server.executable_state``'s
      ``jit_id``) and the bucket's capture count did not grow
      (``executables``);
    * the head bank's fan-out callable is the same object
      (``head_jit_shared``);
    * the backbone's committed program fingerprint is equal before and
      after (``fingerprint_pinned``).  The port has no program lockfile
      yet, so the fingerprint is None: ``fingerprint_pinned`` is False and
      ``no_backbone_recompile`` rests on the first two, as the JAX package
      treats an unaudited backbone.

    ``no_backbone_recompile`` is their conjunction."""
    buckets: Dict[int, Dict[str, Any]] = {}
    compared = False
    reused = True
    for b in sorted(set(exec_before) | set(exec_now)):
        before = exec_before.get(b)
        cur = exec_now.get(b)
        shared = (before is not None and cur is not None
                  and before["jit_id"] == cur["jit_id"])
        buckets[b] = {
            "shared_jit": shared,
            "executables_before": (before or {}).get("executables"),
            "executables_now": (cur or {}).get("executables"),
        }
        if before is not None and cur is not None:
            compared = True
            reused = reused and shared
            eb = before.get("executables")
            en = cur.get("executables")
            if eb is not None and en is not None and en > eb:
                reused = False  # a new capture = a recompile
    fp_pinned = (fingerprint_before is not None
                 and fingerprint_before == fingerprint_now)
    return {
        "name": name,
        "tenant": tenant,
        "op": op,
        "buckets": buckets,
        "head_jit_shared": bank_before.get("jit_id") == bank_now.get(
            "jit_id"),
        "head_executables_before": bank_before.get("executables"),
        "head_executables_now": bank_now.get("executables"),
        "bank_mode": bank_now.get("mode"),
        "fingerprint_before": fingerprint_before,
        "fingerprint_now": fingerprint_now,
        "fingerprint_pinned": fp_pinned,
        "no_backbone_recompile": bool(
            compared and reused
            and bank_before.get("jit_id") == bank_now.get("jit_id")
            and (fingerprint_before is None or fp_pinned)),
    }
