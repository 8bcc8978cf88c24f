"""The port's lock-order checker (``sparkdl_tpu_torch.analysis.lockcheck``)
held against the JAX package's on the CPU, and the port's locks against
the JAX package's names.

The same acquisition scripts run under both checkers: the order graphs,
the cycles and the ``LockOrderError`` messages must be equal, and with the
gate off both hand out plain ``threading`` primitives.  Then an ``ast``
walk of both trees: every lock name a JAX module creates is a lock name of
its counterpart in the port (the port's own locks, which have no JAX
counterpart, are listed here and in ROADMAP.md queue C), and no module of
the port creates a bare ``threading`` lock.  Last, a served run under
``SPARKDL_LOCKCHECK=1`` in a child process (a fleet with a canary, eight
clients, a stream scorer): no ``LockOrderError``.
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys
import threading

import pytest

from sparkdl_tpu.analysis import lockcheck as jlc
from sparkdl_tpu_torch.analysis import lockcheck as plc

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the port's locks that guard what only the port has (the kernels' launch
#: counts and nvcc builds, the CUDA-graph capture and the engine core it
#: shares with its siblings, the H1 fan-out callables, the train step's
#: side streams): named in the same dotted style, listed in ROADMAP.md
PORT_ONLY_LOCKS = {"ops.launch_counts", "ops.build", "ops.build.library",
                   "engine.capture", "engine.core", "engine.fanout_cache",
                   "train.side_streams"}


@pytest.fixture
def both_checked():
    for lc in (plc, jlc):
        lc.enable()
        lc.reset()
    try:
        yield
    finally:
        for lc in (plc, jlc):
            lc.reset()
            lc.disable()


def _script(lc, steps):
    """Run ``steps`` (lists of lock names, each acquired nested in order,
    a fresh instance of each) under ``lc``; returns (order graph,
    [(wanted, held, cycle, message)] of every refused acquisition)."""
    errors = []
    for names in steps:
        held = []
        try:
            for name in names:
                # a new instance each time: two instances of one lock class
                # nest without a self-edge
                lk = (lc.named_condition(name) if name.endswith(".cond")
                      else lc.named_lock(name))
                lk.acquire()
                held.append(lk)
        except lc.LockOrderError as e:
            errors.append((e.wanted, e.held, e.cycle, str(e)))
        finally:
            for lk in reversed(held):
                lk.release()
    return lc.order_graph(), errors


SCRIPTS = [
    [["a", "b"], ["b", "a"]],
    [["a", "b"], ["b", "c"], ["c", "a"]],
    [["a", "b"], ["a", "b"], ["b", "b"], ["a", "c"], ["b", "c"]],
    [["x.cond", "y"], ["y", "x.cond"], ["y", "z"]],
    [["serving.engines", "engine.breaker"], ["fleet.state", "fleet.rollout"],
     ["fleet.rollout", "fleet.state"]],
]


@pytest.mark.parametrize("steps", SCRIPTS)
def test_same_scripts_same_graphs_and_cycles(both_checked, steps):
    assert _script(plc, steps) == _script(jlc, steps)


def test_condition_wait_keeps_stack_consistent(both_checked):
    for lc in (plc, jlc):
        cond = lc.named_condition("t.cond")
        inner = lc.named_lock("t.inner")
        state = []

        def waiter():
            with cond:
                while not state:
                    cond.wait(timeout=5.0)
                with inner:
                    state.append("woke")

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        with cond:
            state.append("go")
            cond.notify_all()
        t.join(timeout=5.0)
        assert not t.is_alive() and state == ["go", "woke"]
    assert plc.order_graph() == jlc.order_graph() == {"t.cond": ["t.inner"]}


def test_disabled_gate_gives_plain_primitives():
    for lc in (plc, jlc):
        lc.disable()
        try:
            assert type(lc.named_lock("t")) is type(threading.Lock())
            assert type(lc.named_rlock("t")) is type(threading.RLock())
            assert isinstance(lc.named_condition("t"), threading.Condition)
        finally:
            lc.reset()
    assert plc.order_graph() == {}


def test_env_gate_matches_jax(monkeypatch):
    for raw in ("", "0", "1", "true", "on", "yes", "off", "no"):
        monkeypatch.setenv("SPARKDL_LOCKCHECK", raw)
        for lc in (plc, jlc):
            monkeypatch.setattr(lc, "_enabled", None)
        assert plc.enabled() == jlc.enabled(), raw


# -- the trees' lock names ---------------------------------------------------

_FACTORIES = {"named_lock", "named_rlock", "named_condition"}


def _lock_names(path: pathlib.Path):
    """(named lock names, bare threading lock lines) of one module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, bare = set(), []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        fname = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        if fname in _FACTORIES and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(node.args[0].value)
        if (isinstance(f, ast.Attribute)
                and f.attr in ("Lock", "RLock", "Condition")
                and isinstance(f.value, ast.Name)
                and f.value.id == "threading"):
            bare.append(node.lineno)
        # a dataclass field's default_factory=threading.Lock
        for kw in node.keywords:
            v = kw.value
            if (kw.arg == "default_factory" and isinstance(v, ast.Attribute)
                    and v.attr in ("Lock", "RLock", "Condition")):
                bare.append(node.lineno)
    return names, bare


def test_port_locks_carry_jax_names_and_none_is_bare():
    jax_root, port_root = ROOT / "sparkdl_tpu", ROOT / "sparkdl_tpu_torch"
    port_names, compared = set(), 0
    for jpath in sorted(jax_root.rglob("*.py")):
        rel = jpath.relative_to(jax_root)
        if rel.parts[0] == "analysis":
            continue
        jnames, _ = _lock_names(jpath)
        ppath = port_root / rel
        if not jnames or not ppath.exists():
            continue
        pnames, _ = _lock_names(ppath)
        assert jnames <= pnames, (str(rel), jnames - pnames)
        assert pnames - jnames <= PORT_ONLY_LOCKS, (str(rel),
                                                    pnames - jnames)
        compared += 1
    assert compared >= 20
    for ppath in sorted(port_root.rglob("*.py")):
        rel = ppath.relative_to(port_root)
        names, bare = _lock_names(ppath)
        port_names |= names
        if rel.parts[0] != "analysis":
            assert bare == [], (str(rel), bare)
    assert PORT_ONLY_LOCKS <= port_names


# -- a served run under the checker ------------------------------------------

def test_served_fleet_and_stream_raise_no_lock_order_error():
    """``chip_smoke.lockcheck_workload`` (the card's ``[audit]`` child runs
    it around the zoo Xception) around a small dense model on the CPU: a
    fleet with a v2 canary, eight clients of three tenants, a promote, and
    a stream scorer, under ``SPARKDL_LOCKCHECK=1``."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "out = chip_smoke.lockcheck_workload(device='cpu', seconds=1.0)\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, SPARKDL_LOCKCHECK="1", CUDA_VISIBLE_DEVICES="-1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=str(ROOT), env=env)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["lock_order_errors"] == [] and out["checked"] is True
    assert out["requests"] > 0 and out["stream_commits"] > 0
    edges = out["order_graph"]
    assert sum(len(v) for v in edges.values()) >= 1
