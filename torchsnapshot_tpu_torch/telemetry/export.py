"""Metric exporters: Prometheus textfile format and structured JSON-lines.

Two pull-free paths out of the process, both file-based so they work on
a TPU VM with no sidecar:

- **Prometheus textfile** (:func:`write_textfile`): the node_exporter
  ``textfile`` collector convention — write the whole exposition to a
  ``.prom`` file atomically (tmp + rename; the collector must never
  read a torn file). :func:`parse_textfile` is the matching parser, used
  by tests (round-trip validation) and by anyone scraping the file
  without a Prometheus.
- **JSON-lines** (:func:`append_jsonl`): one JSON object per line,
  append-only — flight-record summaries and metric snapshots stream
  into a file that ``jq`` / pandas can fold.

Auto-export env knobs (read per call, so training-script setup code may
set them after import):

- ``TPUSNAPSHOT_METRICS_TEXTFILE=/path/metrics.prom`` — every
  take/restore rewrites the exposition file. One file per process
  (``metrics.pid<N>.prom``, or substitute ``{pid}`` yourself — the
  ``tracing.py`` convention): ranks sharing the env var must not
  clobber each other's registry.
- ``TPUSNAPSHOT_TELEMETRY_JSONL=/path/telemetry.jsonl`` — every
  take/restore appends its flight-record summary (appends are
  line-atomic, so one shared file works across ranks).
"""

import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from .metrics import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    format_sample_name,
)

TEXTFILE_ENV_VAR = "TPUSNAPSHOT_METRICS_TEXTFILE"
JSONL_ENV_VAR = "TPUSNAPSHOT_TELEMETRY_JSONL"

# Serializes whole-file rewrites and JSONL appends across threads (an
# async-take drain and a foreground restore may export concurrently).
_export_lock = threading.Lock()


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _sample_line(
    name: str, labels: List[Tuple[str, str]], value: float
) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label_value(v)}"' for k, v in labels
        )
        return f"{name}{{{inner}}} {value:g}"
    return f"{name} {value:g}"


def render_textfile(registry: Optional[MetricsRegistry] = None) -> str:
    """The registry as a Prometheus text-format exposition string."""
    registry = registry if registry is not None else REGISTRY
    lines: List[str] = []
    seen_types: set = set()
    for name, labels_key, metric in registry.items():
        labels = list(labels_key)
        if isinstance(metric, Counter):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(_sample_line(name, labels, metric.value))
        elif isinstance(metric, Gauge):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(_sample_line(name, labels, metric.value))
        elif isinstance(metric, Histogram):
            if name not in seen_types:
                seen_types.add(name)
                lines.append(f"# TYPE {name} histogram")
            data = metric.collect()
            cumulative = 0
            for le_str, count in data["buckets"].items():
                cumulative += count
                lines.append(
                    _sample_line(
                        f"{name}_bucket",
                        labels + [("le", le_str)],
                        cumulative,
                    )
                )
            lines.append(
                _sample_line(
                    f"{name}_bucket", labels + [("le", "+Inf")], data["count"]
                )
            )
            lines.append(_sample_line(f"{name}_sum", labels, data["sum"]))
            lines.append(
                _sample_line(f"{name}_count", labels, data["count"])
            )
    return "\n".join(lines) + ("\n" if lines else "")


def write_textfile(
    path: str, registry: Optional[MetricsRegistry] = None
) -> str:
    """Atomically (tmp + rename) write the exposition to ``path``; the
    node_exporter textfile collector — or anything tailing the file —
    can never observe a torn exposition."""
    doc = render_textfile(registry)
    with _export_lock:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(doc)
        # No fsync: the exposition is ephemeral observability, rewritten
        # on every take/restore — a crash loses nothing that matters.
        # The rename is for ATOMICITY (no torn scrape), not durability.
        # snapcheck: disable=durability-order -- ephemeral metrics exposition
        os.replace(tmp, path)
    return path


_NAME_RE = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^(?P<name>{_NAME_RE})"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$"
)
_LABEL_RE = re.compile(
    rf'(?P<key>{_NAME_RE})="(?P<value>(?:[^"\\]|\\.)*)"'
)


def _unescape_label_value(value: str) -> str:
    return (
        value.replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")
    )


def parse_textfile(doc: str) -> Dict[str, Dict[str, Any]]:
    """Parse a Prometheus text-format exposition.

    Returns ``{metric_name: {"type": ..., "samples": {sample_key: value}}}``
    where sample keys are the canonical ``name{k="v",...}`` form.
    Raises ``ValueError`` on any malformed line and validates histogram
    internal consistency (bucket monotonicity; ``+Inf`` == ``_count``) —
    this is the round-trip gate for :func:`render_textfile`.
    """
    metrics: Dict[str, Dict[str, Any]] = {}
    declared: Dict[str, str] = {}
    for lineno, raw in enumerate(doc.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                declared[parts[2]] = parts[3]
            continue  # HELP/other comments carry no samples
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        name = m.group("name")
        labels_raw = m.group("labels")
        labels: List[Tuple[str, str]] = []
        if labels_raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(labels_raw):
                labels.append(
                    (lm.group("key"), _unescape_label_value(lm.group("value")))
                )
                consumed = lm.end()
            rest = labels_raw[consumed:].strip().strip(",").strip()
            if rest:
                raise ValueError(
                    f"line {lineno}: malformed labels: {labels_raw!r}"
                )
        value_raw = m.group("value")
        if value_raw == "+Inf":
            value = float("inf")
        elif value_raw == "-Inf":
            value = float("-inf")
        else:
            try:
                value = float(value_raw)
            except ValueError:
                raise ValueError(
                    f"line {lineno}: malformed value: {value_raw!r}"
                ) from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in declared:
                base = name[: -len(suffix)]
                break
        entry = metrics.setdefault(
            base, {"type": declared.get(base, "untyped"), "samples": {}}
        )
        key = format_sample_name(
            name, tuple(sorted((k, v) for k, v in labels))
        )
        entry["samples"][key] = value
    _validate_histograms(metrics)
    return metrics


def _validate_histograms(metrics: Dict[str, Dict[str, Any]]) -> None:
    for name, entry in metrics.items():
        if entry["type"] != "histogram":
            continue
        # Group bucket samples by their non-le labels.
        series: Dict[str, List[Tuple[float, float]]] = {}
        counts: Dict[str, float] = {}
        for key, value in entry["samples"].items():
            if key.startswith(f"{name}_bucket"):
                labels = key[key.index("{") + 1 : -1] if "{" in key else ""
                parts = [p for p in labels.split(",") if p]
                le = None
                rest = []
                for p in parts:
                    if p.startswith('le="'):
                        le = p[4:-1]
                    else:
                        rest.append(p)
                if le is None:
                    raise ValueError(
                        f"{name}: bucket sample without le label: {key}"
                    )
                series.setdefault(",".join(rest), []).append(
                    (float("inf") if le == "+Inf" else float(le), value)
                )
            elif key.startswith(f"{name}_count"):
                labels = key[key.index("{") + 1 : -1] if "{" in key else ""
                counts[labels] = value
        for rest, buckets in series.items():
            buckets.sort()
            prev = 0.0
            for _le, cum in buckets:
                if cum < prev:
                    raise ValueError(
                        f"{name}{{{rest}}}: bucket counts not cumulative"
                    )
                prev = cum
            if buckets and buckets[-1][0] != float("inf"):
                raise ValueError(f"{name}{{{rest}}}: missing +Inf bucket")
            if rest in counts and buckets and buckets[-1][1] != counts[rest]:
                raise ValueError(
                    f"{name}{{{rest}}}: +Inf bucket != _count"
                )


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    """Append ``record`` as one JSON line. A single ``write`` of a
    newline-terminated line keeps concurrent appenders from interleaving
    mid-record on POSIX filesystems."""
    line = json.dumps(record, sort_keys=True, default=str)
    with _export_lock:
        with open(path, "a") as f:
            # No fsync: the JSONL stream is ephemeral observability by
            # contract (best-effort export; a crash loses at most the
            # last line of a convenience file). The DURABLE append-only
            # record is the telemetry ledger, whose appends go through
            # the storage plugin's fsync'd atomic replace (ledger.py).
            # snapcheck: disable=durability-order -- ephemeral telemetry export
            f.write(line + "\n")


def _per_process_path(path: str) -> str:
    """One file per process, same convention as ``tracing.py``'s env
    path: multi-rank hosts sharing the env var must not clobber each
    other's exposition (last writer would win and 7/8 of a host's
    metrics would silently vanish). ``{pid}`` in the path substitutes
    the pid; otherwise ``.pid<N>`` lands before the extension."""
    if "{pid}" in path:
        return path.replace("{pid}", str(os.getpid()))
    root, ext = os.path.splitext(path)
    return f"{root}.pid{os.getpid()}{ext or '.prom'}"


def maybe_export(summary: Optional[Dict[str, Any]] = None) -> None:
    """Honor the auto-export env knobs after a snapshot operation.

    Best-effort by contract: metrics export must never fail the
    take/restore that triggered it.
    """
    import logging

    logger = logging.getLogger(__name__)
    textfile = os.environ.get(TEXTFILE_ENV_VAR)
    if textfile:
        try:
            write_textfile(_per_process_path(textfile))
        except Exception as e:
            logger.warning("metrics textfile export to %s failed: %r", textfile, e)
    jsonl = os.environ.get(JSONL_ENV_VAR)
    if jsonl and summary is not None:
        try:
            append_jsonl(jsonl, summary)
        except Exception as e:
            logger.warning("telemetry jsonl export to %s failed: %r", jsonl, e)
