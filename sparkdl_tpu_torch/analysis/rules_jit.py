"""SDL007 — every CUDA-graph capture site makes an explicit memory-pool
decision (port of ``sparkdl_tpu/analysis/rules_jit.py``, retargeted).

The JAX rule asks every ``jax.jit`` site to decide buffer donation: how
much device memory the compiled program holds.  The port has no
``jax.jit``; what decides its device residency is the memory pool a CUDA
graph captures into.  A captured graph keeps every block it allocated
for as long as the graph lives, and graphs that share one pool
(``torch.cuda.graph_pool_handle()``) reuse each other's blocks, so the
pool argument sets a bucket's resident memory, and nothing at runtime
ever complains when a site forgets to choose.  The rule keeps the
decision VISIBLE at every capture site:

* every ``torch.cuda.graph(...)`` call and every
  ``<graph>.capture_begin(...)`` call passes ``pool=...`` explicitly;
  ``pool=None`` counts: it says "considered, and this graph gets a
  private pool", which is a decision, not an omission; or
* the site carries ``# graftlint: allow=SDL007 reason=<why the pool
  does not matter here>``.

``torch.cuda.graph`` is matched through the names ``torch`` and
``torch.cuda`` are bound to (``import torch``, ``import torch as t``,
``from torch import cuda``) and through ``from torch.cuda import graph
[as g]``; ``capture_begin`` is matched on any receiver (it is
``torch.cuda.CUDAGraph``'s own method name).  The file keeps the JAX
rule's name so a reader finds the counterpart; the retarget is listed
among the port's deviations in ROADMAP.md queue C.
"""

from __future__ import annotations

import ast
from typing import List, Set

from sparkdl_tpu_torch.analysis.core import Finding, LintContext, Module

_POOL_KW = "pool"


def _graph_name_tables(tree: ast.AST) -> tuple:
    """``(torch_aliases, cuda_aliases, direct_graph_names)``: names the
    ``torch`` module is bound to, names ``torch.cuda`` is bound to, and
    names ``torch.cuda.graph`` itself is bound to."""
    torch_mods: Set[str] = set()
    cuda_mods: Set[str] = set()
    direct: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for alias in n.names:
                if alias.name == "torch":
                    torch_mods.add(alias.asname or "torch")
                elif alias.name == "torch.cuda":
                    if alias.asname:
                        cuda_mods.add(alias.asname)
                    else:
                        torch_mods.add("torch")
        elif isinstance(n, ast.ImportFrom):
            if n.module == "torch":
                for alias in n.names:
                    if alias.name == "cuda":
                        cuda_mods.add(alias.asname or "cuda")
            elif n.module == "torch.cuda":
                for alias in n.names:
                    if alias.name == "graph":
                        direct.add(alias.asname or "graph")
    return torch_mods, cuda_mods, direct


def rule_sdl007(module: Module, ctx: LintContext) -> List[Finding]:
    torch_mods, cuda_mods, direct = _graph_name_tables(module.tree)

    def is_cuda_ref(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            return (node.attr == "cuda" and isinstance(node.value, ast.Name)
                    and node.value.id in torch_mods)
        return isinstance(node, ast.Name) and node.id in cuda_mods

    def is_graph_ref(node: ast.AST) -> bool:
        if isinstance(node, ast.Attribute):
            return node.attr == "graph" and is_cuda_ref(node.value)
        return isinstance(node, ast.Name) and node.id in direct

    findings: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if is_graph_ref(node.func):
            form = "torch.cuda.graph(...)"
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr == "capture_begin"):
            form = "CUDAGraph.capture_begin(...)"
        else:
            continue
        if any(kw.arg == _POOL_KW for kw in node.keywords):
            continue
        findings.append(Finding(
            "SDL007", module.path, node.lineno,
            f"{form} without an explicit pool=; decide the graph's memory "
            f"pool at every capture site (pool=None records 'a private "
            f"pool for this graph') or annotate why the question does not "
            f"apply"))
    return findings
