"""Deterministic, seeded fault-injection plans and the ``inject`` hook
(port of ``sparkdl_tpu/faults/plan.py``).

Hot paths call :func:`inject` at named sites; with no plan active that is
one module-global read and a ``None`` check.  With a plan active the site's
rules decide, from the plan seed and the site's call counter, whether to
raise, stall or mark the site dead.

Determinism: given the same ``(seed, spec)`` and the same per-site call
order, a plan fires the same sequence as the JAX package's plan does.
Probabilistic rules (``p=``) draw from a per-rule ``random.Random`` seeded
with ``f"{seed}:{site}:{rule index}"``, as there.

Differences from the JAX package: the locks are plain ``threading.Lock``s,
and no flight-recorder event is emitted (``obs/flight.py`` is not ported).
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from sparkdl_tpu_torch.faults.errors import (InjectedDeadDeviceError,
                                             InjectedDecodeError,
                                             InjectedFatalError,
                                             InjectedTransientError)
from sparkdl_tpu_torch.faults.sites import validate_site
from sparkdl_tpu_torch.faults.spec import (FaultRule, faults_from_env,
                                           format_spec, parse_spec)

_EXC_BY_KIND = {
    "transient": InjectedTransientError,
    "fatal": InjectedFatalError,
    "dead": InjectedDeadDeviceError,
    "decode": InjectedDecodeError,
}


def _make_exc(kind: str, message: str, site: str, rule: str,
              retry_after_s: float) -> BaseException:
    if kind == "queue_full":
        # imported here: the serving layer imports faults, not the reverse
        from sparkdl_tpu_torch.serving.errors import QueueFullError

        exc = QueueFullError(message, retry_after_s=retry_after_s)
        exc.site = site  # type: ignore[attr-defined]
        exc.rule = rule  # type: ignore[attr-defined]
        return exc
    return _EXC_BY_KIND[kind](message, site=site, rule=rule)


class FaultPlan:
    """A seeded set of :class:`FaultRule` s with per-rule firing state.

    Build it directly (``FaultPlan([FaultRule(...)], seed=7)``) or from a
    spec string (``FaultPlan.parse("seed=7;engine.dispatch:error:at=2")``),
    then :func:`configure` it or scope it with :func:`active`."""

    def __init__(self, rules: Sequence[Union[FaultRule, str]] = (),
                 seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = []
        for r in rules:
            if isinstance(r, str):
                embedded_seed, parsed = parse_spec(r)
                if embedded_seed:
                    # a "seed=N;..." clause in a rule string means what it
                    # means in parse()
                    self.seed = embedded_seed
                self.rules.extend(parsed)
            else:
                validate_site(r.site)
                self.rules.append(r)
        self._lock = threading.Lock()
        self._site_calls: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}       # rule index -> firings
        self._sticky_dead: Dict[str, str] = {}  # site -> clause that died
        self._rngs = [random.Random(f"{self.seed}:{r.site}:{i}")
                      for i, r in enumerate(self.rules)]

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        seed, rules = parse_spec(spec)
        return cls(rules, seed=seed)

    @property
    def spec(self) -> str:
        """Canonical spec string (round-trips through :meth:`parse`)."""
        return format_spec(self.seed, self.rules)

    def sites(self) -> set:
        return {r.site for r in self.rules}

    def has_rules(self, site: str) -> bool:
        return any(r.site == site for r in self.rules)

    def stats(self) -> Dict[str, Dict[str, int]]:
        """Per-site ``{"calls": N, "fired": N}``."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for site, calls in self._site_calls.items():
                out[site] = {"calls": calls, "fired": 0}
            for i, r in enumerate(self.rules):
                if self._fired.get(i):
                    out.setdefault(r.site, {"calls": 0, "fired": 0})
                    out[r.site]["fired"] += self._fired[i]
            return out

    def fired(self, site: Optional[str] = None) -> int:
        """Total rule firings (optionally for one site)."""
        with self._lock:
            return sum(n for i, n in self._fired.items()
                       if site is None or self.rules[i].site == site)

    def fire(self, site: str, ctx: Dict[str, Any]) -> None:
        """Advance ``site``'s call counter and run any due rules: raise
        (``error``/``dead``), stall (``sleep``, then keep evaluating) or
        pass."""
        sleep_s = 0.0
        raise_exc: Optional[BaseException] = None
        with self._lock:
            n = self._site_calls.get(site, 0) + 1
            self._site_calls[site] = n
            dead_clause = self._sticky_dead.get(site)
            if dead_clause is not None:
                raise_exc = InjectedDeadDeviceError(
                    f"injected dead device at {site} (sticky since rule "
                    f"[{dead_clause}] fired; call #{n})",
                    site=site, rule=dead_clause)
            else:
                for i, r in enumerate(self.rules):
                    if r.site != site or not self._due(i, r, n):
                        continue
                    self._fired[i] = self._fired.get(i, 0) + 1
                    msg = (f"injected {r.action} fault at {site} "
                           f"(rule [{r.clause}], call #{n})")
                    if r.action == "sleep":
                        sleep_s += float(r.params.get("ms", 100.0)) / 1e3
                        continue
                    if r.action == "dead":
                        self._sticky_dead[site] = r.clause
                        raise_exc = InjectedDeadDeviceError(
                            msg, site=site, rule=r.clause)
                        break
                    raise_exc = _make_exc(
                        r.params.get("exc", "transient"), msg, site,
                        r.clause, retry_after_s=float(
                            r.params.get("retry_after", 0.05)))
                    break
        if sleep_s:
            time.sleep(sleep_s)
        if raise_exc is not None:
            raise raise_exc

    def _due(self, i: int, r: FaultRule, n: int) -> bool:
        """Schedule of rule ``i`` at site call ``n``; the caller holds the
        lock."""
        times = r.params.get("times")
        if times is not None and self._fired.get(i, 0) >= int(times):
            return False
        at = r.params.get("at")
        if at is not None and n != int(at):
            return False
        every = r.params.get("every")
        if every is not None and n % max(1, int(every)) != 0:
            return False
        p = r.params.get("p")
        if p is not None and self._rngs[i].random() >= float(p):
            return False
        return True


# -- module singleton ------------------------------------------------------
_UNSET = object()   # before the first inject() consults SPARKDL_FAULTS
_PLAN: Any = _UNSET
_PLAN_LOCK = threading.Lock()


def inject(site: str, **ctx: Any) -> None:
    """The hook hot paths call at a named site.  Disabled path: one global
    read and an identity check; ``SPARKDL_FAULTS`` is read once, at the
    first call."""
    plan = _PLAN
    if plan is None:
        return
    if plan is _UNSET:
        plan = configure_from_env()
        if plan is None:
            return
    plan.fire(site, ctx)


def get_plan() -> Optional[FaultPlan]:
    """The active plan (resolving the env on first ask), or None."""
    plan = _PLAN
    if plan is _UNSET:
        return configure_from_env()
    return plan


def has_rules(site: str) -> bool:
    """True iff an active plan has rules for ``site``."""
    plan = get_plan()
    return plan is not None and plan.has_rules(site)


def configure(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process fault plan (None disables)."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = plan
    return plan


def clear() -> None:
    """Disable injection (and stop consulting the env until
    :func:`configure_from_env` is called again)."""
    configure(None)


def configure_from_env() -> Optional[FaultPlan]:
    """(Re-)configure from ``SPARKDL_FAULTS``; the plan, or None when the
    variable is unset or empty."""
    raw = faults_from_env()
    return configure(FaultPlan.parse(raw) if raw else None)


def current_spec() -> Optional[str]:
    """Canonical spec of the active plan, or None when injection is off."""
    plan = get_plan()
    return plan.spec if plan is not None else None


@contextlib.contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Scope ``plan`` to a ``with`` block, restoring the previous plan."""
    global _PLAN
    with _PLAN_LOCK:
        prev = _PLAN
        _PLAN = plan
    try:
        yield plan
    finally:
        with _PLAN_LOCK:
            _PLAN = prev
