"""graftlint core (port of ``sparkdl_tpu/analysis/core.py``): file
loading, pragma handling, rule dispatch.

A dependency-free (stdlib ``ast``) analysis engine in the
fixpoint-on-every-commit spirit of Facebook Infer (Calcagno et al.,
NASA FM 2015): the rules encode this project's invariants — joined
threads, guarded attributes, registered fault sites, paired spans,
monotonic timing, decided graph memory pools — so a refactor that
silently reintroduces one of those bug classes fails the tests instead
of waiting for the next incident.

Suppression pragma (one per line, reason REQUIRED)::

    risky_thing()  # graftlint: allow=SDL003 reason=probe must not raise

The pragma suppresses the named rule(s) on its own line and on the line
directly below it (so a pragma can sit on its own line above a long
statement).  A pragma with no reason is itself a finding (``SDL000``) —
an unexplained exemption is exactly the "memory of whoever wrote it"
this tool exists to replace.

The engine imports nothing from the rest of ``sparkdl_tpu_torch`` and
never imports the code under analysis — linting a file cannot initialize
torch or CUDA, load weights, or run module side effects.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

__all__ = [
    "Finding",
    "Module",
    "LintContext",
    "load_module",
    "collect_files",
    "run_rules",
]

#: pragma grammar (after a comment-leading "graftlint:" marker):
#: ``allow=SDL001[,SDL005] reason=<text>``
_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*allow=(?P<codes>[A-Za-z0-9_,]+)"
    r"(?:\s+reason=(?P<reason>\S.*))?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    code: str       # e.g. "SDL003"
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


@dataclass
class Module:
    """One parsed source file plus its pragma table."""

    path: str
    source: str
    tree: ast.AST
    lines: List[str]
    # line number -> codes allowed on that line (and the line below)
    pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    # pragma lines missing the mandatory reason
    bad_pragmas: List[int] = field(default_factory=list)
    parents: Dict[int, ast.AST] = field(default_factory=dict)

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))


@dataclass
class LintContext:
    """Cross-file state the rules share: the canonical fault-site
    registry (None = SDL004 cannot run and reports that once) and the
    flight-event catalog (None = SDL008 likewise)."""

    sites: Optional[Set[str]] = None
    events: Optional[Set[str]] = None


def _scan_pragmas(source: str) -> tuple:
    """Pragmas from REAL comment tokens (``tokenize``), so pragma-shaped
    text inside string literals neither suppresses nor triggers
    anything."""
    pragmas: Dict[int, Set[str]] = {}
    bad: List[int] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [(tok.start[0], tok.string) for tok in tokens
                    if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return pragmas, bad  # unparseable source is reported elsewhere
    for line, text in comments:
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        if not m.group("reason"):
            bad.append(line)
            continue
        codes = {c.strip().upper() for c in m.group("codes").split(",")
                 if c.strip()}
        pragmas[line] = codes
    return pragmas, bad


def load_module(source: str, path: str) -> Module:
    """Parse one file into a :class:`Module` (raises ``SyntaxError`` on
    unparseable input — callers surface it as an ``SDL000`` finding)."""
    tree = ast.parse(source, filename=path)
    lines = source.splitlines()
    pragmas, bad = _scan_pragmas(source)
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return Module(path=path, source=source, tree=tree, lines=lines,
                  pragmas=pragmas, bad_pragmas=bad, parents=parents)


def collect_files(targets: Iterable[str]) -> List[str]:
    """Expand file/directory targets into a sorted ``*.py`` list
    (skipping ``__pycache__`` and hidden directories)."""
    out: List[str] = []
    for target in targets:
        if os.path.isfile(target):
            out.append(target)
            continue
        for dirpath, dirnames, filenames in os.walk(target):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def load_name_registry_file(path: str, dict_name: str,
                            tuple_name: str) -> Optional[Set[str]]:
    """Parse ONE registry file with ``ast`` (never by import): the keys
    of a ``dict_name`` dict literal, falling back to a ``tuple_name``
    tuple literal.  None when the file holds neither.  Shared by the
    SDL004 fault-site and SDL008 flight-event loaders — one
    implementation, so a blind spot (e.g. annotated assignments are
    invisible) exists once, not per registry."""
    with open(path, "r", encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if dict_name in names and isinstance(node.value, ast.Dict):
            keys = {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
            if keys:
                return keys
        if tuple_name in names and isinstance(node.value, ast.Tuple):
            keys = {e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)}
            if keys:
                return keys
    return None


def locate_name_registry(targets: Iterable[str], parent_dir: str,
                         basename: str, dict_name: str,
                         tuple_name: str) -> Optional[Set[str]]:
    """Auto-locate ``<parent_dir>/<basename>`` under the DIRECTORY
    targets and extract its name set (plain-file targets contribute
    only when they ARE a ``basename`` — linting ``bench.py`` must not
    walk the whole checkout).  None when no registry file is found."""
    candidates: List[str] = []
    for t in targets:
        if os.path.isfile(t):
            if os.path.basename(t) == basename:
                candidates.append(t)
            continue
        direct = os.path.join(t, parent_dir, basename)
        if os.path.isfile(direct):
            candidates.append(direct)
            continue
        for dirpath, dirnames, filenames in os.walk(t):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            if basename in filenames and \
                    os.path.basename(dirpath) == parent_dir:
                candidates.append(os.path.join(dirpath, basename))
    for path in candidates:
        names = load_name_registry_file(path, dict_name, tuple_name)
        if names:
            return names
    return None


def _suppressed(module: Module, finding: Finding) -> bool:
    for line in (finding.line, finding.line - 1):
        codes = module.pragmas.get(line)
        if codes and finding.code in codes:
            return True
    return False


def run_rules(module: Module, rules, ctx: LintContext) -> List[Finding]:
    """All findings for one module: rule output minus pragma-suppressed,
    plus ``SDL000`` for every reason-less pragma (never suppressible —
    the whole point is that exemptions carry their why)."""
    findings: List[Finding] = []
    for rule in rules:
        for f in rule(module, ctx):
            if not _suppressed(module, f):
                findings.append(f)
    for line in module.bad_pragmas:
        findings.append(Finding(
            "SDL000", module.path, line,
            "graftlint pragma without a reason= clause; every exemption "
            "must say why (allow=SDLxxx reason=<text>)"))
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings
