"""OpenMetrics exposition — the counter tree as a Prometheus scrape, ported
from the reference's ``obs/metrics.py``.

HPX publishes ``/threads{locality#0/total}/idle-rate`` and expects an
operator (or Grafana) to be watching; our equivalent is this module.  A
scrape walks the *fleet-wide* counter tree via the fault-tolerant sweep
form of ``net.query_counter_export`` (one parcel round per locality, dead
peers degrade to ``repro_up 0`` instead of failing the scrape) and
renders Prometheus text format 0.0.4:

- counter-path grammar ``/object{instance}/rest`` maps to a metric name
  ``repro_<object>_<rest>`` plus labels mined from the path —
  ``/scheduler{default}/idle-rate`` → ``repro_scheduler_idle_rate{pool=
  "default",locality="0"}``; ``word#N`` segments anywhere (``engine#3``,
  ``victim#0``, ``peer#2``) become ``word="N"`` labels; ``/obs{blame/
  compute}`` becomes ``tier="compute"``.
- monotonic counters get the ``_total`` suffix and ``# TYPE counter``;
  the log-bucketed :class:`repro_torch.core.counters.Histogram` renders as a
  *native* Prometheus histogram (cumulative ``_bucket{le=...}`` series,
  ``+Inf``, ``_sum``/``_count``), adjacent buckets merged down to
  ``BUCKET_CAP`` so a long-running timer can't bloat a scrape.

The HTTP listener itself lives in :mod:`repro_torch.net.httpd` (only
``repro_torch/net`` may open sockets); :class:`MetricsExporter` glues the two:
``MetricsExporter(net=net).start()`` on locality 0 and every scrape of
``/metrics`` sweeps the fleet live.  ``parse_prometheus_text`` is the
strict round-trip parser the tests (and ``obs.top --metrics``) use — it
enforces the format invariants (escaping, declared types, bucket
monotonicity, ``+Inf == _count``) rather than trusting the renderer.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import counters as _counters

# Prometheus text format 0.0.4 — what /metrics advertises
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# max rendered buckets per histogram series (adjacent-merge above this)
BUCKET_CAP = 32

_COUNTER_RE = re.compile(r"^/(?P<obj>[^{/]+)\{(?P<inst>[^}]*)\}(?P<rest>(?:/.*)?)$")
_SEG_LABEL_RE = re.compile(r"^([A-Za-z_][\w-]*)#(\d+)$")
_NAME_OK_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _sanitize(part: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", part)


def counter_to_metric(name: str) -> Tuple[str, Dict[str, str]]:
    """Map one counter path to ``(metric_base_name, labels)``.

    The base name carries no kind suffix — the renderer appends
    ``_total`` for counters and the histogram suffixes itself.
    """
    m = _COUNTER_RE.match(name)
    if m is None:  # counter outside the /obj{inst}/... grammar
        return "repro_" + _sanitize(name.strip("/")) or "repro_counter", {}
    obj, inst, rest = m.group("obj"), m.group("inst"), m.group("rest")
    labels: Dict[str, str] = {}
    plain_inst: List[str] = []
    if obj == "scheduler":
        labels["pool"] = inst
    elif inst.startswith("blame/"):
        labels["tier"] = inst[len("blame/"):]
    else:
        for seg in inst.split("/"):
            sm = _SEG_LABEL_RE.match(seg)
            if sm:
                labels[_sanitize(sm.group(1))] = sm.group(2)
            elif seg:
                plain_inst.append(seg)
        if plain_inst:
            labels["instance"] = "/".join(plain_inst)
    parts: List[str] = []
    for seg in rest.split("/"):
        if not seg:
            continue
        sm = _SEG_LABEL_RE.match(seg)
        if sm:
            labels[_sanitize(sm.group(1))] = sm.group(2)
        else:
            parts.append(_sanitize(seg))
    base = "repro_" + _sanitize(obj)
    if parts:
        base += "_" + "_".join(parts)
    return base, labels


# --------------------------------------------------------------- rendering
def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _merge_buckets(buckets: List[Tuple[float, int]],
                   cap: int = BUCKET_CAP) -> List[Tuple[float, int]]:
    """Adjacent-merge down to ``cap`` buckets; counts are conserved and
    upper bounds keep their meaning (the survivor keeps the *higher*
    bound of each merged pair)."""
    out = list(buckets)
    while len(out) > cap:
        merged: List[Tuple[float, int]] = []
        it = iter(out)
        for lo in it:
            hi = next(it, None)
            if hi is None:
                merged.append(lo)
            else:
                merged.append((hi[0], lo[1] + hi[1]))
        out = merged
    return out


def _is_error_marker(result: Any) -> bool:
    """A sweep entry for a dead peer is ``{"error": repr}`` — counter
    names always start with ``/`` so the shapes can't collide."""
    return (isinstance(result, dict) and "error" in result
            and not any(str(k).startswith("/") for k in result))


def render_openmetrics(sweep: Dict[int, Any]) -> str:
    """Render one fleet export sweep (``{locality: {name: record}}`` with
    dead peers as ``{"error": ...}``) as Prometheus text format."""
    # family name → (type, help); samples grouped per family for one
    # TYPE/HELP header each, deterministic order for diffable scrapes
    families: Dict[str, Tuple[str, str]] = {}
    scalars: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    hists: Dict[str, List[Tuple[Dict[str, str], Dict[str, Any]]]] = {}
    up: Dict[int, int] = {}
    errors: Dict[int, int] = {}

    for loc in sorted(sweep):
        result = sweep[loc]
        if _is_error_marker(result):
            up[loc] = 0
            continue
        up[loc] = 1
        for cname in sorted(result):
            rec = result[cname]
            kind = rec.get("kind", "gauge")
            if kind == "error":
                errors[loc] = errors.get(loc, 0) + 1
                continue
            base, labels = counter_to_metric(cname)
            labels["locality"] = str(loc)
            if kind in ("histogram", "timer"):
                families.setdefault(base, ("histogram", cname))
                hists.setdefault(base, []).append((labels, rec))
            elif kind == "counter":
                name = base + "_total"
                families.setdefault(name, ("counter", cname))
                scalars.setdefault(name, []).append(
                    (labels, float(rec.get("value", 0.0))))
            else:
                families.setdefault(base, ("gauge", cname))
                scalars.setdefault(base, []).append(
                    (labels, float(rec.get("value", 0.0))))

    for loc, v in up.items():
        families.setdefault("repro_up", ("gauge", "locality reachable"))
        scalars.setdefault("repro_up", []).append(
            ({"locality": str(loc)}, float(v)))
    for loc, n in errors.items():
        families.setdefault("repro_scrape_counter_errors",
                            ("gauge", "counters that raised during export"))
        scalars.setdefault("repro_scrape_counter_errors", []).append(
            ({"locality": str(loc)}, float(n)))

    lines: List[str] = []
    for fam in sorted(families):
        ftype, fhelp = families[fam]
        lines.append(f"# HELP {fam} {_escape_help(fhelp)}")
        lines.append(f"# TYPE {fam} {ftype}")
        if ftype == "histogram":
            for labels, rec in hists[fam]:
                raw = rec.get("buckets") or []
                merged = _merge_buckets(raw)
                cum = 0
                for ub, cnt in merged:
                    cum += cnt
                    bl = dict(labels)
                    bl["le"] = _fmt(float(ub))
                    lines.append(f"{fam}_bucket{_labels_str(bl)} {cum}")
                bl = dict(labels)
                bl["le"] = "+Inf"
                count = int(rec.get("count", cum))
                lines.append(f"{fam}_bucket{_labels_str(bl)} {count}")
                lines.append(f"{fam}_sum{_labels_str(labels)} "
                             f"{_fmt(float(rec.get('sum', 0.0)))}")
                lines.append(f"{fam}_count{_labels_str(labels)} {count}")
        else:
            for labels, value in scalars[fam]:
                lines.append(f"{fam}{_labels_str(labels)} {_fmt(value)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------ the exporter
class MetricsExporter:
    """Serve ``/metrics`` from this process (locality 0 by convention).

    Each scrape is a *live* fleet sweep — no cache, no staleness window;
    Prometheus's own scrape interval is the sampling cadence.  With no
    net runtime the exporter degrades to single-locality (local registry
    only), which is what the bench harness and unit tests use.
    """

    def __init__(self, pattern: str = "*", host: str = "127.0.0.1",
                 port: int = 0, net=None,
                 registry: Optional[_counters.CounterRegistry] = None):
        self.pattern = pattern
        self.net = net
        self.registry = registry or _counters.default()
        self._host, self._port = host, port
        self._endpoint = None
        self._lock = threading.Lock()
        self.scrapes = 0

    def sweep(self) -> Dict[int, Any]:
        if self.net is None:
            return {0: self.registry.snapshot_export(self.pattern)}
        from repro_torch.net import remote as _remote

        return _remote.query_counter_export(None, self.pattern)

    def scrape(self) -> str:
        with self._lock:
            self.scrapes += 1
        return render_openmetrics(self.sweep())

    # handler given to the net-tier listener
    def _handle(self, path: str):
        if path in ("/metrics", "/"):
            return 200, CONTENT_TYPE, self.scrape().encode("utf-8")
        return 404, "text/plain; charset=utf-8", b"try /metrics\n"

    @property
    def port(self) -> int:
        if self._endpoint is None:
            raise RuntimeError("exporter not started")
        return self._endpoint.port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}/metrics"

    def start(self) -> "MetricsExporter":
        if self._endpoint is None:
            from repro_torch.net.httpd import HttpEndpoint

            self._endpoint = HttpEndpoint(self._handle, host=self._host,
                                          port=self._port).start()
        return self

    def close(self) -> None:
        ep, self._endpoint = self._endpoint, None
        if ep is not None:
            ep.close()

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------- strict re-parser
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\d+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(raw: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ValueError(f"malformed label pair at {raw[pos:]!r}")
        labels[m.group(1)] = _unescape_label(m.group(2))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                raise ValueError(f"expected ',' in labels at {raw[pos:]!r}")
            pos += 1
    return labels


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    return float(raw)


def _family_of(sample_name: str, declared: Dict[str, str]) -> Optional[str]:
    if sample_name in declared:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[:-len(suffix)]
            if declared.get(base) == "histogram":
                return base
    return None


def parse_prometheus_text(text: str, strict: bool = True) -> Dict[str, Dict[str, Any]]:
    """Parse (and, when ``strict``, *validate*) Prometheus text format.

    Returns ``{family: {"type", "help", "samples": [(name, labels,
    value), ...]}}``.  Strict mode enforces what a real scraper would:
    every sample belongs to a declared ``# TYPE`` family, metric/label
    names are well-formed, histogram ``_bucket`` series are cumulative
    and monotone with a ``+Inf`` bucket equal to ``_count``, and counter
    samples carry the ``_total`` suffix with non-negative values.
    """
    declared: Dict[str, str] = {}
    families: Dict[str, Dict[str, Any]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_text = rest.partition(" ")
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": []})["help"] = help_text
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, ftype = rest.partition(" ")
            if strict and ftype not in ("counter", "gauge", "histogram",
                                        "summary", "untyped"):
                raise ValueError(f"line {lineno}: unknown type {ftype!r}")
            if strict and declared.get(name) not in (None, ftype):
                raise ValueError(f"line {lineno}: type redeclared for {name}")
            declared[name] = ftype
            families.setdefault(name, {"type": None, "help": None,
                                       "samples": []})["type"] = ftype
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels") or "")
        value = _parse_value(m.group("value"))
        fam = _family_of(name, declared)
        if fam is None:
            if strict:
                raise ValueError(
                    f"line {lineno}: sample {name!r} has no declared family")
            fam = name
            families.setdefault(fam, {"type": None, "help": None,
                                      "samples": []})
        if strict and not _NAME_OK_RE.match(name):
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        families[fam]["samples"].append((name, labels, value))

    if strict:
        _validate_families(families)
    return families


def _validate_families(families: Dict[str, Dict[str, Any]]) -> None:
    for fam, info in families.items():
        ftype = info["type"]
        if ftype == "counter":
            for name, _labels, value in info["samples"]:
                if not name.endswith("_total"):
                    raise ValueError(f"{fam}: counter sample {name!r} "
                                     "lacks _total suffix")
                if value < 0:
                    raise ValueError(f"{fam}: negative counter {value}")
        elif ftype == "histogram":
            # group by label-set minus 'le'
            series: Dict[Tuple, Dict[str, Any]] = {}
            for name, labels, value in info["samples"]:
                key = tuple(sorted((k, v) for k, v in labels.items()
                                   if k != "le"))
                s = series.setdefault(key, {"buckets": [], "sum": None,
                                            "count": None})
                if name.endswith("_bucket"):
                    if "le" not in labels:
                        raise ValueError(f"{fam}: _bucket without le label")
                    s["buckets"].append((_parse_value(labels["le"]), value))
                elif name.endswith("_sum"):
                    s["sum"] = value
                elif name.endswith("_count"):
                    s["count"] = value
            for key, s in series.items():
                buckets = sorted(s["buckets"])
                if not buckets or buckets[-1][0] != math.inf:
                    raise ValueError(f"{fam}{dict(key)}: missing +Inf bucket")
                last = -1.0
                for _ub, cum in buckets:
                    if cum < last:
                        raise ValueError(
                            f"{fam}{dict(key)}: non-monotone buckets")
                    last = cum
                if s["count"] is None or buckets[-1][1] != s["count"]:
                    raise ValueError(
                        f"{fam}{dict(key)}: +Inf bucket != _count")
