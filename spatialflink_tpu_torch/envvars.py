"""The SFT_* environment-variable registry of the port: one owner and
hazard class per var.

Every ``SFT_*`` variable that ``spatialflink_tpu_torch/`` or
``chip_smoke.py`` reads is declared here, and nothing else is
(``tests/test_torch_envvars.py`` scans both sources in both
directions). A var the JAX package reads too keeps the JAX package's
hazard class. A CI stage that runs the port derives its
ambient-environment scrub from :func:`gate_scrub_vars`, so an armed-plan
var registered here can never leak an injected fault into a healthy run.

Hazard classes:

- ``armed`` — arms faults or policies; an ambient value changes any run
  that did not set it (the fault, overload, pipeline, serving and
  ablation plans). A gate scrubs these from every stage.
- ``capture`` — selects artifact outputs (ledgers, streams); an ambient
  value redirects captures but never changes a result.
- ``tuning`` — behaviour knobs with safe defaults (deadlines).
- ``internal`` — process-internal markers a parent sets for its own
  children; never user-facing.

This module is stdlib-only and imports nothing, so a gate can load it
by file path without importing the package (whose modules import torch).
"""

from __future__ import annotations

HAZARD_CLASSES = ("armed", "capture", "tuning", "internal")

#: name → {"owner": reading module, "hazard": class, "doc": one line}
ENV_VARS = {
    "SFT_FAULT_PLAN": {
        "owner": "spatialflink_tpu_torch/faults.py", "hazard": "armed",
        "doc": "fault plan (inline JSON or path), armed at import; the "
               "driver's and chip_smoke.py's children get it set or "
               "scrubbed by their parent",
    },
    "SFT_OVERLOAD_POLICY": {
        "owner": "spatialflink_tpu_torch/overload.py", "hazard": "armed",
        "doc": "overload policy (inline JSON or path), "
               "OverloadPolicy.from_env",
    },
    "SFT_PIPELINE": {
        "owner": "spatialflink_tpu_torch/pipeline.py", "hazard": "armed",
        "doc": "pipelined-ingest policy (inline JSON or path), armed at "
               "import; results stay bit-identical, but an ambient value "
               "flips every pipeline-off baseline",
    },
    "SFT_QSERVE": {
        "owner": "spatialflink_tpu_torch/qserve.py", "hazard": "armed",
        "doc": "qserve serving config (inline JSON or path): standing "
               "queries and per-tenant-class budgets",
    },
    "SFT_ABLATE": {
        "owner": "spatialflink_tpu_torch/ablation.py", "hazard": "armed",
        "doc": "kernel-ablation spec (comma list, inline JSON or path), "
               "armed at import; ablated kernels return cached zeros, so "
               "an ambient value falsifies every measurement",
    },
    "SFT_LEDGER_PATH": {
        "owner": "spatialflink_tpu_torch/driver.py", "hazard": "capture",
        "doc": "run-ledger output path; scrubbed from the chaos "
               "children's environment",
    },
    "SFT_LEDGER_STREAM": {
        "owner": "spatialflink_tpu_torch/driver.py", "hazard": "capture",
        "doc": "append-only JSONL ledger stream path of a chaos child "
               "(telemetry.stream_to)",
    },
    "SFT_LEDGER_STREAM_INTERVAL_S": {
        "owner": "spatialflink_tpu_torch/telemetry.py", "hazard": "capture",
        "doc": "stream flush pacing (seconds)",
    },
    "SFT_BLACKBOX": {
        "owner": "spatialflink_tpu_torch/telemetry.py", "hazard": "capture",
        "doc": "flight-recorder ring size (last-N window summaries and "
               "instants dumped on fault fire or stream seal; '0' "
               "disables, default 64)",
    },
    "SFT_DIAL_DEADLINE_S": {
        "owner": "spatialflink_tpu_torch/driver.py", "hazard": "tuning",
        "doc": "when set, bounds the driver's first device-path window "
               "(a resume on a device path that never answers seals the "
               "stream as dial_timeout)",
    },
}


def gate_scrub_vars() -> list:
    """The vars a gate must remove from every stage's ambient
    environment: everything of hazard class ``armed``."""
    return sorted(n for n, meta in ENV_VARS.items()
                  if meta["hazard"] == "armed")


def _selfcheck() -> None:
    for name, meta in ENV_VARS.items():
        if meta["hazard"] not in HAZARD_CLASSES:
            raise ValueError(
                f"ENV_VARS[{name!r}]: unknown hazard class "
                f"{meta['hazard']!r} (classes: {HAZARD_CLASSES})"
            )


_selfcheck()
