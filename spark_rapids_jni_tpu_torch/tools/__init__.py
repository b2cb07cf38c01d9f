"""Command-line entry points of the port, each run as
``python -m spark_rapids_jni_tpu_torch.tools.<name>``:

- ``srjt_fuzz``: the plan-space fuzzer's corpus (``engine/fuzz.py``) on a
  device, exit 1 on a soundness violation;
- ``srjt_blackbox``: list, show and grep post-mortem bundles;
- ``srjt_profile``: list, show, diff the query-profile store, a profile's
  decision ledger, SLO burn rates;
- ``srjt_export``: Prometheus text of a server's ``OP_METRICS`` or of this
  process's registries;
- ``trace_join_check``: one trace id across the client, the server's
  metrics, profiles and bundles;
- ``chaos_soak``: the fault-injection matrix against the pipeline and the
  server;
- ``srjt_lint``: the repo lint of the port's invariants (AST rules,
  dispatch tables, the metric catalog ``METRICS.md`` beside it) and, with
  ``--segments``, the sync pass on a device.

Settings come from flags (``--dir``, ``--slo-ms``, ``--set field=value``),
never from the environment.  The entry points that execute plans take
``--device`` (default ``cuda``: on a host without a card they raise).
"""
