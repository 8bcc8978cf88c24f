"""Persistent compile cache of the port's Hopper kernel libraries (the
port's counterpart of ``sparkdl_tpu/parallel/compile_cache.py``).

What the port compiles that outlives a process is each hand-written CUDA
kernel library, built by ``nvcc`` at first use (:mod:`sparkdl_tpu_torch.
ops.build`).  Under the ``SPARKDL_COMPILE_CACHE`` gate those libraries
(their ``.so`` and nvcc's ``.log``) are built into, and loaded from, one
cache directory that carries a manifest: the toolchain that built them
(torch, CUDA, nvcc's release, the card's capability), every library's
content hash (its sources, the shared ``csrc/*.cuh`` headers and nvcc's
flags, as ``ops/build.py`` names it), the port's committed program
lockfile's records (``programs``, each program's record by name, and
``lockfile_programs``, their count: ``PROGRAMS_TORCH.lock.json``, or
``lockfile_path``) and the set of engine sharding policies the deployment
used.  A manifest that no longer matches the live process invalidates the
population CLEANLY: every entry but the manifest is purged before a single
library loads, and the drift is classified so an operator reading the
``compile.invalidate`` flight event knows why the cold start got slow
again:

  * ``["toolchain"]``: another torch, CUDA, nvcc or card capability;
  * ``["kernel:<name>", ...]``: the libraries whose hash moved (a kernel
    name of ``ops/sepconv.py KERNELS``);
  * GC codes (``["GC000"]``, ``["GC004"]``, ...): the programs moved, as
    the port's ``analysis.program.lockfile.diff_records`` classifies the
    stored records against the live lockfile (the JAX package's
    classification);
  * ``["GC005"]`` alone: same toolchain, libraries and programs, but a
    sharding policy the stored set never held (a changed weight layout);
  * ``["manifest"]``: an unreadable or foreign manifest.

``toolchain`` and ``kernel:<name>`` are the port's own labels (what nvcc
built has no JAX counterpart); labels of several kinds are reported
together.  Not cached: CUDA graphs and cuDNN's plans live and die with
their process, so a restarted process still pays its graph captures (the
engine's ``captures``); only nvcc's work is saved.

Gate: ``SPARKDL_COMPILE_CACHE`` (the JAX package's grammar)
  * ``""``/``0``/``false``/``off``/``no``: DISABLED (the default): the
    libraries build into ``build/sparkdl_tpu_torch/`` at the root of the
    checkout, named by their hash as before, and nothing is counted;
  * ``1``/``true``/``on``/``yes``: enabled at the default directory
    (``~/.cache/sparkdl_tpu_torch/compile``, the port's own, so the two
    packages never purge each other's entries);
  * anything else: the cache DIRECTORY.

Resolution is a process singleton: the first library build
(``ops/build.py``, which resolves before it chooses a directory, so a
process that builds kernels before any engine exists is covered) or the
first :class:`~sparkdl_tpu_torch.parallel.engine.InferenceEngine`
consults the env exactly once (:func:`ensure_from_env`, serialised under
the configure lock), and every later caller sees the resolved state.  A
failed configure (an unwritable directory, a manifest that cannot be
rewritten, the injected ``compile.cache`` fault) disables the cache with
a warning: the libraries are then built by nvcc into
``build/sparkdl_tpu_torch/`` exactly as with the gate off, and a failed
nvcc still raises.

:func:`stats` counts, while the cache is enabled, ``misses`` (nvcc runs)
and ``hits`` (libraries loaded from the cache with no nvcc run): a
restarted process over an unchanged toolchain and sources shows
``misses == 0``.

Sharing contract: one directory serves ONE deployment configuration.  The
manifest's ``sharding_policies`` set gathers every engine policy the
deployment's processes note, but a configure whose policy the set has
never held purges the whole population, so unrelated deployments should
use separate directories.  A process's library builds resolve the cache
with no policy (a wildcard), and its engines' policies then join the set
(:func:`note_policy`) without a purge.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from sparkdl_tpu_torch.analysis.lockcheck import named_lock
from sparkdl_tpu_torch.faults import inject
from sparkdl_tpu_torch.obs.flight import emit as flight_emit
from sparkdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "MANIFEST_NAME",
    "DEFAULT_DIR",
    "dir_from_env",
    "configure",
    "configure_from_env",
    "ensure_from_env",
    "note_policy",
    "state",
    "stats",
    "enabled",
    "toolchain",
    "kernel_hashes",
]

#: the manifest written next to the cached libraries; upper-cased so it
#: can never collide with a ``lib<name>_<hash>.so`` entry
MANIFEST_NAME = "SPARKDL_COMPILE_CACHE_MANIFEST.json"
MANIFEST_SCHEMA = 1

DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                           "sparkdl_tpu_torch", "compile")

_OFF = ("", "0", "false", "off", "no")
_ON = ("1", "true", "on", "yes")
_TOOLCHAIN_KEYS = ("torch_version", "cuda_version", "nvcc", "capability")
_RELEASE = re.compile(rb"release [0-9]+\.[0-9]+, V[0-9][0-9.]*[0-9]")

# -- process singleton -------------------------------------------------------
_UNSET = object()
_state: Any = _UNSET    # None = disabled; dict = the resolved snapshot
_lock = named_lock("parallel.compile_cache")
_counts = {"hits": 0, "misses": 0}
_toolchain: Dict[str, Optional[str]] = {}


def dir_from_env() -> Optional[str]:
    """The cache directory per the ``SPARKDL_COMPILE_CACHE`` grammar
    (module docstring), or None when the knob is off or unset."""
    raw = os.environ.get("SPARKDL_COMPILE_CACHE", "").strip()
    low = raw.lower()
    if low in _OFF:
        return None
    if low in _ON:
        return DEFAULT_DIR
    return os.path.expanduser(raw)


def _nvcc_release(nvcc: str) -> Optional[str]:
    """nvcc's release (``"release 12.9, V12.9.86"``), read from the string
    the nvcc binary carries for ``--version``, so that reading it runs no
    nvcc; None if the binary holds none."""
    try:
        found = _RELEASE.search(Path(nvcc).resolve().read_bytes())
    except OSError:
        return None
    return found.group(0).decode() if found is not None else None


def toolchain() -> Dict[str, Optional[str]]:
    """What built the libraries: ``torch_version``, ``cuda_version``
    (``torch.version.cuda``), ``nvcc`` (its release) and ``capability``
    (the card's, ``"sm_90"``); each None on a machine without it.  Read
    once per process."""
    if not _toolchain:
        import torch

        from sparkdl_tpu_torch.ops import build

        nvcc = build.nvcc_path()
        cap = None
        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability()
            cap = f"sm_{major}{minor}"
        _toolchain.update(
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            nvcc=_nvcc_release(nvcc) if nvcc is not None else None,
            capability=cap)
    return dict(_toolchain)


def kernel_hashes() -> Dict[str, str]:
    """Kernel name (``ops/sepconv.py KERNELS``) -> the hash its library is
    named by (sources, shared headers, flags): computed from the sources
    alone, no nvcc needed."""
    from sparkdl_tpu_torch.ops import build
    from sparkdl_tpu_torch.ops.sepconv import KERNELS

    return {kernel: build.library_hash(name, sources)
            for kernel, (name, sources, _, _) in sorted(KERNELS.items())}


def record_hit() -> None:
    """A library loaded from the cache with no nvcc run
    (``ops/build.py``)."""
    with _lock:
        _counts["hits"] += 1


def record_miss() -> None:
    """One nvcc run into the cache (``ops/build.py``)."""
    with _lock:
        _counts["misses"] += 1


def _purge(dir_path: str) -> int:
    """Drop every cache entry (the caller rewrites the manifest) so
    nothing stale can load after an invalidation; returns the number of
    entries removed."""
    removed = 0
    for name in os.listdir(dir_path):
        if name == MANIFEST_NAME:
            continue
        try:
            os.unlink(os.path.join(dir_path, name))
            removed += 1
        except OSError:
            logger.warning("compile cache: could not purge stale entry "
                           "%s", name)
            raise  # a stale library we cannot remove must disable
    return removed


def _write_manifest(path: str, doc: Dict[str, Any]) -> None:
    """Atomic manifest write: a temporary file, fsync'd, then renamed."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _norm(value: Any) -> Any:
    """JSON round-trip (tuples become lists), so a stored manifest compares
    equal to the live records it was written from."""
    return json.loads(json.dumps(value, sort_keys=True))


def _drift(stored: Any, env: Dict[str, Optional[str]],
           kernels: Dict[str, str], programs: Dict[str, Any]) -> List[str]:
    """The drift labels of a stored manifest against this process (module
    docstring); ``[]`` when it matches (the policy is checked apart)."""
    if (not isinstance(stored, dict)
            or stored.get("schema_version") != MANIFEST_SCHEMA
            or not isinstance(stored.get("kernels"), dict)
            or not isinstance(stored.get("programs"), dict)
            or any(k not in stored for k in _TOOLCHAIN_KEYS)):
        return ["manifest"]
    labels = []
    if any(stored[k] != env[k] for k in _TOOLCHAIN_KEYS):
        labels.append("toolchain")
    old = stored["kernels"]
    labels += [f"kernel:{name}" for name in sorted(set(old) | set(kernels))
               if old.get(name) != kernels.get(name)]
    if _norm(stored["programs"]) != _norm(programs):
        from sparkdl_tpu_torch.analysis.program.lockfile import diff_records

        current = [{"name": n, **rec} for n, rec in sorted(programs.items())]
        codes = {f.code for f in diff_records(
            {"programs": stored["programs"]}, current)}
        labels += sorted(codes) or ["GC000"]
    return sorted(labels)


def lockfile_programs(lockfile_path: Optional[str] = None
                      ) -> Dict[str, Any]:
    """The committed program lockfile's records by name (``{}`` when the
    file is missing): what the manifest pins."""
    from sparkdl_tpu_torch.analysis.program.lockfile import (
        DEFAULT_LOCKFILE, read_lockfile)

    path = lockfile_path or DEFAULT_LOCKFILE
    if not os.path.isfile(path):
        return {}
    return read_lockfile(path).get("programs", {})


def _validate_manifest(dir_path: str, policy: Optional[str] = None,
                       lockfile_path: Optional[str] = None
                       ) -> Tuple[Dict[str, Any], List[Tuple[str, dict]]]:
    """Hold the directory's manifest to this process's toolchain, its
    libraries' hashes, the committed program lockfile and the engine's
    sharding ``policy`` (``None`` is a wildcard that never invalidates a
    stored set); purge and classify on drift, then rewrite the manifest.
    Returns the state fields and the flight events to emit AFTER the
    configure lock is released."""
    manifest_path = os.path.join(dir_path, MANIFEST_NAME)
    env = toolchain()
    kernels = kernel_hashes()
    programs = lockfile_programs(lockfile_path)
    reused = False
    invalidated = False
    drift_rules: List[str] = []
    purged = 0
    events: List[Tuple[str, dict]] = []
    policies: List[str] = [policy] if policy else []
    if os.path.isfile(manifest_path):
        stored: Any = None
        try:
            with open(manifest_path, "r", encoding="utf-8") as fh:
                stored = json.load(fh)
        except (OSError, ValueError):
            stored = None  # a corrupt manifest proves nothing
        drift_rules = _drift(stored, env, kernels, programs)
        stored_policies = (list(stored.get("sharding_policies") or [])
                           if drift_rules != ["manifest"] else [])
        policy_ok = policy is None or policy in stored_policies
        if not drift_rules and not policy_ok:
            # same toolchain and libraries under a weight layout this
            # directory's deployment never used
            drift_rules = ["GC005"]
        if not drift_rules:
            reused = True
            policies = sorted(set(stored_policies)
                              | ({policy} if policy else set()))
        else:
            invalidated = True
            purged = _purge(dir_path)
            events.append(("compile.invalidate", {
                "dir": dir_path, "purged_entries": purged,
                "drift_rules": drift_rules,
            }))
            logger.warning(
                "persistent compile cache at %s invalidated: drift %s; "
                "purged %d stale entries (nvcc rebuilds ahead)", dir_path,
                drift_rules, purged)
    doc = {"schema_version": MANIFEST_SCHEMA, **env, "kernels": kernels,
           "programs": programs, "lockfile_programs": len(programs),
           "sharding_policies": policies}
    _write_manifest(manifest_path, doc)
    fields = {"reused": reused, "invalidated": invalidated,
              "drift_rules": drift_rules, "purged_entries": purged,
              "lockfile_programs": len(programs),
              "sharding_policy": policy,
              "sharding_policies": policies, **env,
              "kernels": kernels}
    events.append(("compile.persist", {
        "dir": dir_path, "reused": reused,
        "lockfile_programs": len(programs)}))
    return fields, events


def _configure_locked(dir_path: Optional[str], policy: Optional[str] = None,
                      lockfile_path: Optional[str] = None
                      ) -> Tuple[Optional[Dict[str, Any]],
                                 List[Tuple[str, dict]]]:
    """Resolve the cache state (called under the configure lock); returns
    (state, flight events to emit after release).  Any failure disables
    the cache: the libraries then build into ``build/`` as with the gate
    off."""
    if dir_path is None:
        return None, []
    try:
        # chaos hook: an injected error here is a corrupt cache directory
        # or manifest, which configure must absorb
        inject("compile.cache")
        os.makedirs(dir_path, exist_ok=True)
        fields, events = _validate_manifest(dir_path, policy, lockfile_path)
        return {"dir": dir_path, **fields}, events
    except Exception as e:  # noqa: BLE001 — logged, the cache disabled
        logger.warning("persistent compile cache disabled: %s: %s "
                       "(kernel libraries build into build/ instead)",
                       type(e).__name__, e)
        return None, []


def configure(dir_path: Optional[str],
              policy: Optional[str] = None,
              lockfile_path: Optional[str] = None
              ) -> Optional[Dict[str, Any]]:
    """Install (or disable, with ``None``) the persistent compile cache at
    ``dir_path``, validating its manifest against this process, the
    program lockfile at ``lockfile_path`` (default: the committed
    ``PROGRAMS_TORCH.lock.json``) and the engine sharding ``policy``
    (``None``: no policy recorded)."""
    global _state
    with _lock:
        st, events = _configure_locked(dir_path, policy, lockfile_path)
        _state = st
    for name, attrs in events:
        flight_emit(name, **attrs)
    return st


def configure_from_env() -> Optional[Dict[str, Any]]:
    """(Re-)configure from ``SPARKDL_COMPILE_CACHE``."""
    return configure(dir_from_env())


def ensure_from_env(policy: Optional[str] = None
                    ) -> Optional[Dict[str, Any]]:
    """The per-build and per-engine probe: resolve
    ``SPARKDL_COMPILE_CACHE`` exactly once per process, then one
    module-global read (plus a policy-set membership check) ever after.
    An engine passes its ``compile_policy()``: the first resolution
    validates it against the stored set, and later policies join the set
    through :func:`note_policy`."""
    global _state
    if _state is not _UNSET:
        if policy is not None:
            note_policy(policy)
        return _state if isinstance(_state, dict) else None
    with _lock:
        if _state is _UNSET:
            st, events = _configure_locked(dir_from_env(), policy)
            _state = st
        else:
            events = []
    for name, attrs in events:
        flight_emit(name, **attrs)
    if policy is not None:
        note_policy(policy)
    return _state if isinstance(_state, dict) else None


def note_policy(policy: str) -> None:
    """Record one engine's mesh and partition policy in the manifest's
    policy SET (no purge: adding a layout to a live deployment only widens
    what a restart may reuse).  No-op while disabled or when the policy is
    already recorded (the per-engine fast path)."""
    global _state
    st = _state
    if (not isinstance(st, dict)
            or policy in st.get("sharding_policies", [])):
        return
    with _lock:
        st = _state
        if (not isinstance(st, dict)
                or policy in st.get("sharding_policies", [])):
            return
        manifest_path = os.path.join(st["dir"], MANIFEST_NAME)
        try:
            with open(manifest_path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
            policies = sorted(set(doc.get("sharding_policies") or [])
                              | {policy})
            doc["sharding_policies"] = policies
            _write_manifest(manifest_path, doc)
            _state = dict(st, sharding_policies=policies)
        except (OSError, ValueError) as e:
            logger.warning(
                "compile cache: could not record sharding policy in the "
                "manifest (%s: %s); a restart whose engines resolve this "
                "layout first will purge once", type(e).__name__, e)


def state() -> Optional[Dict[str, Any]]:
    """The resolved cache state (None while disabled or unresolved),
    JSON-serializable: the directory, ``reused``, ``invalidated``,
    ``drift_rules``, ``purged_entries``, ``lockfile_programs``, the
    policies, the toolchain fields and the libraries' hashes."""
    st = _state
    return json.loads(json.dumps(st)) if isinstance(st, dict) else None


def stats() -> Dict[str, int]:
    """This process's ``hits`` (libraries loaded from the cache, no nvcc)
    and ``misses`` (nvcc runs into the cache)."""
    with _lock:
        return dict(_counts)


def enabled() -> bool:
    return isinstance(_state, dict)


def _reset_for_tests() -> None:
    """Forget the resolved state, the counters and the toolchain (tests
    re-resolve under another env)."""
    global _state
    with _lock:
        _state = _UNSET
        _counts["hits"] = 0
        _counts["misses"] = 0
        _toolchain.clear()
