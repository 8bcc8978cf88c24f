"""Zero-downtime version rollout, canary -> promote | rollback, and the
head fan-out's swap report (port of
``sparkdl_tpu/serving/fleet/rollout.py``).

The TensorFlow-Serving shape on this stack's primitives: the NEW
version's :class:`~sparkdl_tpu_torch.serving.server.Server` is built
ALONGSIDE the stable one (both alive, both admitting), a deterministic
counter routes a configurable traffic fraction to the canary, and the swap
itself is a phase flip: after ``promote()`` every new request routes to
the canary server while the old server drains gracefully
(``close(drain=True)``), so a request ALWAYS completes on the version that
admitted it.  ``rollback()`` is the mirror image.

No-recompile contract, the port's form.  The JAX package compares one
shared ``jax.jit`` object and its executable count.  In the port each
version has its own module copy and its own captured engines (a captured
CUDA graph reads its weights from fixed addresses, so two versions that
answer at once cannot share one), so :meth:`Rollout.report` keeps the JAX
report's keys and defines them over ``Server.program_state``:

* ``shared_jit`` (per bucket): the canary's bucket runs the SAME entry fn
  object on the same input shapes and dtypes under the same
  ``precision_flags()`` as the stable one did at rollout start;
* ``no_recompile``: every compared bucket shares, and no bucket of either
  server was captured again between rollout start and the report, beyond
  one first capture of a bucket new since the start (the JAX package's
  allowance for a bucket compiled for the first time).

Fault sites: ``fleet.canary`` fires at each canary routing decision;
``fleet.swap`` fires at the promote/rollback attempt, before the phase
flip, so an injected fault leaves both servers serving and the operator
retries.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PHASE_CANARY = "canary"
PHASE_PROMOTED = "promoted"
PHASE_ROLLED_BACK = "rolled_back"


def _recaptured(before: Dict[int, Dict[str, Any]],
                now: Dict[int, Dict[str, Any]], b: int) -> bool:
    """Whether bucket ``b`` of one server captured beyond what the
    no-recompile contract allows since ``before``: any capture of a bucket
    that existed then, more than one of a bucket new since."""
    cur = now.get(b)
    if cur is None:
        return False
    old = before.get(b)
    if old is None:
        return cur["captures"] > 1
    return cur["captures"] > old["captures"]


class Rollout:
    """One in-progress version transition for one fleet entry.

    Built by :meth:`Fleet.start_rollout` once the canary server is warm;
    routing goes through :meth:`route` (deterministic fraction: request
    ``n`` rides the canary iff ``floor(n*f)`` advanced, so fraction 0.25
    sends exactly every 4th request, 0.0 none, 1.0 all).  The phase flip
    methods only change THIS object's phase: the owning fleet swaps its
    own state and drains the losing server after the flip succeeds, so a
    fault injected at ``fleet.swap`` leaves the world exactly as it was.

    ``exec_before`` is the stable server's ``program_state()`` at rollout
    start; the canary's is read here."""

    def __init__(self, name: str, stable_version: int, stable_server,
                 canary_version: int, canary_server, fraction: float,
                 exec_before: Dict[int, Dict[str, Any]]):
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"canary fraction must be in [0, 1], got "
                             f"{fraction}")
        self.name = name
        self.stable_version = int(stable_version)
        self.stable_server = stable_server
        self.canary_version = int(canary_version)
        self.canary_server = canary_server
        self._fraction = float(fraction)
        self._exec_before = dict(exec_before)
        self._canary_before = canary_server.program_state()
        self._lock = named_lock("fleet.rollout")
        self._phase = PHASE_CANARY
        self._n = 0
        self._canary_n = 0

    # -- state -------------------------------------------------------------
    @property
    def phase(self) -> str:
        with self._lock:
            return self._phase

    @property
    def active(self) -> bool:
        return self.phase == PHASE_CANARY

    @property
    def fraction(self) -> float:
        with self._lock:
            return self._fraction

    def set_fraction(self, fraction: float) -> None:
        """Shift canary traffic mid-rollout (0.0 pauses it, 1.0 is a full
        dark launch before the promote)."""
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError(f"canary fraction must be in [0, 1], got "
                             f"{fraction}")
        with self._lock:
            self._fraction = float(fraction)

    # -- routing -----------------------------------------------------------
    def route(self) -> Tuple[int, Any, bool]:
        """(version, server, is_canary) for the next request.  After a
        phase flip, stale callers holding this object keep routing
        CORRECTLY: promoted -> canary server, rolled back -> stable."""
        with self._lock:
            phase = self._phase
            f = self._fraction
        if phase == PHASE_PROMOTED:
            return self.canary_version, self.canary_server, False
        if phase == PHASE_ROLLED_BACK:
            return self.stable_version, self.stable_server, False
        inject("fleet.canary")
        with self._lock:
            self._n += 1
            take = math.floor(self._n * f) > math.floor((self._n - 1) * f)
            if take:
                self._canary_n += 1
        if take:
            return self.canary_version, self.canary_server, True
        return self.stable_version, self.stable_server, False

    # -- phase flips -------------------------------------------------------
    def promote(self) -> Dict[str, Any]:
        """Make the canary the stable version.  The ``fleet.swap`` fault
        site fires BEFORE any state changes; on an injected failure both
        versions keep serving and promote() can simply be retried.
        Returns :meth:`report`."""
        inject("fleet.swap")
        with self._lock:
            if self._phase != PHASE_CANARY:
                raise RuntimeError(
                    f"cannot promote {self.name!r}: rollout already "
                    f"{self._phase}")
            self._phase = PHASE_PROMOTED
        logger.info("%s: promoted v%d over v%d", self.name,
                    self.canary_version, self.stable_version)
        return self.report()

    def rollback(self) -> Dict[str, Any]:
        """Abandon the canary; the stable version keeps serving.  Same
        ``fleet.swap`` fault-site semantics as :meth:`promote`."""
        inject("fleet.swap")
        with self._lock:
            if self._phase != PHASE_CANARY:
                raise RuntimeError(
                    f"cannot roll back {self.name!r}: rollout already "
                    f"{self._phase}")
            self._phase = PHASE_ROLLED_BACK
        logger.info("%s: rolled back v%d, staying on v%d", self.name,
                    self.canary_version, self.stable_version)
        return self.report()

    # -- introspection -----------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """JSON-serializable swap report with the no-recompile proof (the
        module docstring): per bucket ``shared_jit``, the stable server's
        captures at rollout start (``executables_before``), the canary's
        now (``executables_now``) and ``recaptured`` (either server
        captured it beyond the contract's allowance); then
        ``no_recompile``."""
        stable_now = self.stable_server.program_state()
        canary_now = self.canary_server.program_state()
        buckets: Dict[int, Dict[str, Any]] = {}
        compared = False
        reused = True
        for b in sorted(set(self._exec_before) | set(canary_now)):
            before = self._exec_before.get(b)
            cur = canary_now.get(b)
            shared = (before is not None and cur is not None
                      and all(before[k] == cur[k]
                              for k in ("fn_id", "signature", "precision")))
            recaptured = (_recaptured(self._exec_before, stable_now, b)
                          or _recaptured(self._canary_before, canary_now, b))
            buckets[b] = {
                "shared_jit": shared,
                "executables_before": (before or {}).get("captures"),
                "executables_now": (cur or {}).get("captures"),
                "recaptured": recaptured,
            }
            if before is not None and cur is not None:
                compared = True
                reused = reused and shared
            reused = reused and not recaptured
        for b in set(stable_now) - set(buckets):
            # a bucket only the stable server dispatched since the start
            reused = reused and not _recaptured(self._exec_before,
                                                stable_now, b)
        with self._lock:
            status = {
                "name": self.name,
                "phase": self._phase,
                "stable_version": self.stable_version,
                "canary_version": self.canary_version,
                "fraction": self._fraction,
                "requests": self._n,
                "canary_requests": self._canary_n,
            }
        status["buckets"] = buckets
        status["no_recompile"] = bool(compared and reused)
        return status

    def status(self) -> Dict[str, Any]:
        """The light form ``Fleet.varz`` embeds per model."""
        with self._lock:
            return {
                "canary_version": self.canary_version,
                "stable_version": self.stable_version,
                "fraction": self._fraction,
                "phase": self._phase,
                "requests": self._n,
                "canary_requests": self._canary_n,
            }


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
      after (``fingerprint_pinned``), read from the port's program
      lockfile (``serving.cache.lockfile_model_fingerprint``).  A backbone
      the lockfile does not audit has no fingerprint: ``fingerprint_pinned``
      is then False and ``no_backbone_recompile`` rests on the first two,
      as the JAX package treats an unaudited backbone.

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
