"""sparkdl_tpu_torch.analysis — graftlint: project-native static
analysis + runtime concurrency checking (port of
``sparkdl_tpu/analysis``).

The port's serving stack is as concurrent as the JAX package's
(batcher, dispatcher, worker and pipeline threads, the fleet's
admission and rollouts, the stream scorer, some 45 lock sites, named
fault sites, paired spans); this package keeps those invariants
machine-checked for the port's own code, by ``tools/port_graftlint.py``
and the tests:

====== ==================================================================
code   invariant
====== ==================================================================
SDL000 every allow pragma carries a ``reason=`` (meta-rule)
SDL001 started threads are daemonized or joined (the wedged-queue
       lesson)
SDL002 an attribute ever written under ``with self._lock:`` is never
       written without it (Eraser-style lockset, per class)
SDL003 broad/bare ``except`` re-raises, logs via ``utils.logging``, or
       carries an allow pragma
SDL004 fault-site strings exist in ``faults/sites.py`` (no typo'd
       chaos sites)
SDL005 metric/span names match ``dotted.lowercase``; opened spans are
       closable on every path
SDL006 ``time.time()`` never feeds a latency subtraction
       (``perf_counter``/``monotonic`` only)
SDL007 every CUDA-graph capture site (``torch.cuda.graph(...)``,
       ``CUDAGraph.capture_begin(...)``) passes an explicit ``pool=``
       (``None`` = decided "a private pool"): the port's residency
       decision where the JAX rule asks ``jax.jit`` sites to decide
       donation
SDL008 flight-event strings exist in ``obs/flight.py`` ``EVENT_HELP``
       (no typo'd black-box events — the SDL004 pattern for the
       incident recorder)
====== ==================================================================

Suppress with ``# graftlint: allow=SDLxxx reason=<why>`` on the
offending line or the line above.  The runtime half —
:mod:`~sparkdl_tpu_torch.analysis.lockcheck`, gated by
``SPARKDL_LOCKCHECK=1`` — wraps the stack's locks and fails on
acquisition-order cycles.  The compiled-program half is
:mod:`~sparkdl_tpu_torch.analysis.program` (graftcheck).

Everything here is stdlib-only and nothing here imports the code under
analysis: linting the whole port takes well under a second beyond the
package's own import.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Set

from sparkdl_tpu_torch.analysis.core import (Finding, LintContext, Module,
                                       collect_files, load_module,
                                       run_rules)
from sparkdl_tpu_torch.analysis.rules_flight import (load_event_registry,
                                               load_event_registry_file,
                                               rule_sdl008)
from sparkdl_tpu_torch.analysis.rules_hygiene import rule_sdl003, rule_sdl006
from sparkdl_tpu_torch.analysis.rules_jit import rule_sdl007
from sparkdl_tpu_torch.analysis.rules_obs import (rule_sdl005_names,
                                            rule_sdl005_pairing)
from sparkdl_tpu_torch.analysis.rules_sites import (load_site_registry,
                                              load_site_registry_file,
                                              rule_sdl004)
from sparkdl_tpu_torch.analysis.rules_threads import rule_sdl001, rule_sdl002

__all__ = [
    "Finding",
    "LintContext",
    "ALL_RULES",
    "RULE_HELP",
    "lint_source",
    "lint_paths",
    "load_site_registry",
    "load_site_registry_file",
    "load_event_registry",
    "load_event_registry_file",
]

ALL_RULES = (
    rule_sdl001,
    rule_sdl002,
    rule_sdl003,
    rule_sdl004,
    rule_sdl005_names,
    rule_sdl005_pairing,
    rule_sdl006,
    rule_sdl007,
    rule_sdl008,
)

RULE_HELP = {
    "SDL000": "allow pragmas must carry reason=<why>",
    "SDL001": "started threads must be daemonized or joined",
    "SDL002": "lock-guarded attributes are never written lock-free",
    "SDL003": "broad except must re-raise, log, or carry a pragma",
    "SDL004": "fault-site strings must exist in faults/sites.py",
    "SDL005": "metric/span names dotted-lowercase; spans always closed",
    "SDL006": "time.time() never feeds a latency subtraction",
    "SDL007": "every CUDA-graph capture site decides its memory pool",
    "SDL008": "flight-event strings must exist in obs/flight.py",
}


def lint_source(source: str, path: str = "<string>",
                sites: Optional[Set[str]] = None,
                events: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one in-memory snippet (the test-fixture entry point).
    ``sites``/``events`` are the fault-site registry and flight-event
    catalog SDL004/SDL008 check against; None means "no registry
    found", which each rule reports on any use."""
    try:
        module = load_module(source, path)
    except SyntaxError as e:
        return [Finding("SDL000", path, e.lineno or 1,
                        f"syntax error: {e.msg}")]
    return run_rules(module, ALL_RULES,
                     LintContext(sites=sites, events=events))


def lint_paths(targets: Iterable[str],
               sites: Optional[Set[str]] = None,
               events: Optional[Set[str]] = None) -> List[Finding]:
    """Lint files/directories.  The fault-site registry and flight-event
    catalog are auto-located under the targets unless passed
    explicitly."""
    targets = list(targets)
    if sites is None:
        sites = load_site_registry(targets)
    if events is None:
        events = load_event_registry(targets)
    ctx = LintContext(sites=sites, events=events)
    findings: List[Finding] = []
    for path in collect_files(targets):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        try:
            module = load_module(source, path)
        except SyntaxError as e:
            findings.append(Finding("SDL000", path, e.lineno or 1,
                                    f"syntax error: {e.msg}"))
            continue
        findings.extend(run_rules(module, ALL_RULES, ctx))
    return findings
