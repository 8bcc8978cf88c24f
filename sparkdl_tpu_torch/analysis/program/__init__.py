"""graftcheck for the port — program auditing (port of
``sparkdl_tpu/analysis/program``).

graftlint (``sparkdl_tpu_torch.analysis``) checks the port's PYTHON
source; this package checks the PROGRAMS the port runs.  Every program
the serving and training layers build (the full zoo x the serving bucket
plan, the generic and wide-dense serving programs, the head fan-out pair,
the train steps, the three Hopper kernels at their audit shapes) is built
on the meta device (no weights, no card, no compute) and audited against
JAX's program rules:

====== ==================================================================
code   invariant
====== ==================================================================
GC000  committed program fingerprint (sha256 of the meta-traced call
       list) matches the audit
GC001  dispatch/train programs donate their consumable inputs, and a
       DECLARED donation finds an output leaf of its shape and dtype —
       or the program carries a recorded reason
GC002  under a declared bf16 compute dtype no convolution or matrix
       product runs on f32 operands
GC003  the programs' input keys contain no weak types, no duplicates,
       and no same-shape dtype churn within one program
GC004  pad-to-bucket waste stays inside budget: per-bucket FLOPs split
       into useful vs pad rows, adjacent buckets within the budget
GC005  every program's declared shardings are consistent with its mesh
       axes (batch divisible by the data axis, split dims divide), and
       no large param is fully replicated while a usable model axis
       exists
====== ==================================================================

Records are serialized into the committed ``PROGRAMS_TORCH.lock.json``
at the repo root, so any drift fails ``tools/port_graftcheck.py`` and the
tests deterministically, without a card; ``--write-baseline``
regenerates the lockfile after a reviewed, deliberate program change.
The serving cache (``lockfile_model_fingerprint``), the cost ledger and
the compile cache's manifest read it.
"""

from __future__ import annotations

from sparkdl_tpu_torch.analysis.program.audit import (GC_RULE_HELP,
                                                      ProgramSpec,
                                                      audit_inventory,
                                                      audit_program,
                                                      pad_waste_audit,
                                                      retrace_audit)
from sparkdl_tpu_torch.analysis.program.inventory import (
    fleet_dispatch_specs, headfanout_dispatch_specs, stack_programs)
from sparkdl_tpu_torch.analysis.program.lockfile import (DEFAULT_LOCKFILE,
                                                         diff_records,
                                                         read_lockfile,
                                                         write_lockfile,
                                                         zoo_gflop_per_img)

__all__ = [
    "GC_RULE_HELP",
    "ProgramSpec",
    "audit_program",
    "audit_inventory",
    "retrace_audit",
    "pad_waste_audit",
    "stack_programs",
    "fleet_dispatch_specs",
    "headfanout_dispatch_specs",
    "DEFAULT_LOCKFILE",
    "read_lockfile",
    "write_lockfile",
    "diff_records",
    "zoo_gflop_per_img",
]
