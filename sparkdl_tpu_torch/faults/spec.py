"""``SPARKDL_FAULTS`` spec grammar: parse and canonical form (port of
``sparkdl_tpu/faults/spec.py``, the same grammar and the same refusals).

Grammar::

    spec    := clause (";" clause)*
    clause  := "seed=" INT | rule
    rule    := SITE ":" ACTION [":" param ("," param)*]
    param   := KEY "=" VALUE

* ``SITE`` — a registered injection point (:data:`SITES`); an unknown site
  is a parse error.
* ``ACTION`` — ``error`` (raise), ``sleep`` (stall ``ms`` then continue),
  ``dead`` (raise once scheduled, then on every later call at the site).
* schedule params (optional, AND-combined): ``at=N`` fires on exactly the
  Nth call to the site (1-based); ``every=N`` on every Nth call; ``p=F``
  with probability F per call, drawn from the rule's own seeded RNG;
  ``times=K`` caps the firings.  With none the rule fires on every call.
* action params: ``ms=F`` (sleep, default 100);
  ``exc=transient|fatal|dead|decode|queue_full`` picks the raised type of
  ``error`` rules (default ``transient``; ``queue_full`` only at
  ``serving.*`` / ``fleet.*`` sites); ``retry_after=F``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from sparkdl_tpu_torch.faults.sites import SITES, validate_site  # noqa: F401

ACTIONS = ("error", "sleep", "dead")
EXC_KINDS = ("transient", "fatal", "dead", "decode", "queue_full")

_INT_PARAMS = ("at", "every", "times")
_FLOAT_PARAMS = ("p", "ms", "retry_after")


@dataclass
class FaultRule:
    """One parsed rule clause.  Plain data — firing counters live in the
    :class:`~sparkdl_tpu_torch.faults.plan.FaultPlan` so a rule list can be
    reused across plans/replays."""

    site: str
    action: str
    params: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self):
        validate_site(self.site)
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r} (site {self.site}); "
                f"known actions: {', '.join(ACTIONS)}")
        exc = self.params.get("exc")
        if exc is not None and exc not in EXC_KINDS:
            raise ValueError(
                f"unknown exc kind {exc!r} (site {self.site}); known: "
                f"{', '.join(EXC_KINDS)}")
        if exc == "queue_full" and not self.site.startswith(("serving.",
                                                             "fleet.")):
            # QueueFullError is not an InjectedFault: outside the serving
            # and fleet admission layers it would escape every `except
            # InjectedFault` site handler and crash the host path
            # instead of testing it
            raise ValueError(
                f"exc=queue_full is only meaningful at serving.*/fleet.* "
                f"sites, not {self.site!r}")
        for k in self.params:
            if k != "exc" and k not in _INT_PARAMS + _FLOAT_PARAMS:
                raise ValueError(
                    f"unknown fault param {k!r} (site {self.site}); known: "
                    f"{', '.join(_INT_PARAMS + _FLOAT_PARAMS + ('exc',))}")

    @property
    def clause(self) -> str:
        """Canonical spec text for this rule (the round-trippable form
        error messages and ``format_spec`` use)."""
        if not self.params:
            return f"{self.site}:{self.action}"
        parts = []
        for k in sorted(self.params):
            v = self.params[k]
            if isinstance(v, float) and v == int(v) and k not in ("p",):
                v = int(v)
            parts.append(f"{k}={v}")
        return f"{self.site}:{self.action}:{','.join(parts)}"


def parse_spec(text: str) -> Tuple[int, List[FaultRule]]:
    """Parse a ``SPARKDL_FAULTS`` spec string into ``(seed, rules)``.

    Raises ``ValueError`` with the offending clause on any grammar
    error — a malformed chaos spec must fail loudly at configure time,
    never degrade into a no-fault run.
    """
    seed = 0
    rules: List[FaultRule] = []
    for raw in (text or "").split(";"):
        clause = raw.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            try:
                seed = int(clause[len("seed="):])
            except ValueError:
                raise ValueError(f"bad seed clause {clause!r}") from None
            continue
        bits = clause.split(":", 2)
        if len(bits) < 2:
            raise ValueError(
                f"bad fault clause {clause!r}: expected "
                f"'site:action[:k=v,...]' or 'seed=N'")
        site, action = bits[0].strip(), bits[1].strip()
        params: Dict[str, float] = {}
        if len(bits) == 3 and bits[2].strip():
            for pair in bits[2].split(","):
                if "=" not in pair:
                    raise ValueError(
                        f"bad fault param {pair!r} in clause {clause!r}")
                k, v = (s.strip() for s in pair.split("=", 1))
                try:
                    if k == "exc":
                        params[k] = v  # type: ignore[assignment]
                    elif k in _INT_PARAMS:
                        params[k] = int(v)
                    else:
                        # floats, plus unknown keys coerced so FaultRule
                        # validation can name them
                        params[k] = float(v)
                except ValueError:
                    # the env is parsed lazily at the first inject(), so
                    # a bare int()/float() error would surface from deep
                    # inside a hot path with no hint WHAT failed
                    raise ValueError(
                        f"bad fault param value {pair!r} in clause "
                        f"{clause!r}") from None
        rules.append(FaultRule(site=site, action=action, params=params))
    return seed, rules


def format_spec(seed: int, rules: List[FaultRule]) -> str:
    """Canonical spec string for ``(seed, rules)`` — what bench lines
    stamp as ``faults: <spec>`` so an injected-chaos run is
    self-describing."""
    clauses = [f"seed={seed}"] if seed else []
    clauses.extend(r.clause for r in rules)
    return ";".join(clauses)


def faults_from_env() -> Optional[str]:
    """The raw ``SPARKDL_FAULTS`` value, or None when unset/empty — the
    one env read every gate shares."""
    import os

    raw = os.environ.get("SPARKDL_FAULTS", "").strip()
    return raw or None
