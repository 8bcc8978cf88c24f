"""The serving fleet (port of ``sparkdl_tpu.serving.fleet``), in part.

Ported: ``rollout.head_swap_report``, the head fan-out's no-recompile
report.  Not ported yet (ROADMAP.md queue A item 5.2): ``Fleet``,
``ModelRegistry``, ``ModelVersion``, ``Rollout`` and ``TenantQuota``.
"""
