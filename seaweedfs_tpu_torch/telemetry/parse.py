"""Prometheus text exposition format 0.0.4 parser.

The collector scrapes /metrics from daemons that render through
stats/metrics.Registry, but the parser accepts the full text format
(escaped label values, exponent floats, +Inf/NaN) so a node running a
different exporter — or a future Go-reference sidecar — scrapes the
same way. Deliberately allocation-light: one pass per line, no regex.

The port of seaweedfs_tpu/telemetry/parse.py. It reads the port's own
exposition too, the port-only `weed_kernel_launches` family and
histogram exemplars included.
"""

from __future__ import annotations

Sample = tuple[str, tuple[tuple[str, str], ...], float]


def _close_brace(line: str, start: int) -> int:
    """Index of the first UNQUOTED '}' at/after `start`, or -1.

    rfind('}') is wrong since weedscope: a bucket line may carry an
    exemplar suffix (`... {trace_id="..."} 0.09`) whose closing brace
    sits AFTER the value — rfind would swallow the sample value into
    the label body and drop the line. Quote-aware forward scan instead
    (a label VALUE may legally contain '}')."""
    i, n = start, len(line)
    in_quotes = False
    while i < n:
        c = line[i]
        if c == "\\" and in_quotes:
            i += 2
            continue
        if c == '"':
            in_quotes = not in_quotes
        elif c == "}" and not in_quotes:
            return i
        i += 1
    return -1


def _parse_labels(body: str) -> tuple[tuple[str, str], ...]:
    """`k="v",k2="v2"` → sorted ((k, v), ...) with \\" \\\\ \\n unescaped."""
    labels: list[tuple[str, str]] = []
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            break
        name = body[i:eq].strip().lstrip(",").strip()
        i = eq + 1
        if i >= n or body[i] != '"':
            break  # malformed; keep what we have
        i += 1
        out: list[str] = []
        while i < n:
            c = body[i]
            if c == "\\" and i + 1 < n:
                nxt = body[i + 1]
                out.append("\n" if nxt == "n" else nxt)
                i += 2
                continue
            if c == '"':
                i += 1
                break
            out.append(c)
            i += 1
        labels.append((name, "".join(out)))
        while i < n and body[i] in ", ":
            i += 1
    labels.sort()
    return tuple(labels)


def parse_prometheus_text(text: str) -> list[Sample]:
    """Parse exposition text into (name, sorted label tuple, value)
    samples. Comment/HELP/TYPE lines and malformed lines are skipped —
    a scrape must degrade, not raise, on one bad line."""
    samples: list[Sample] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{labels} value [timestamp] [# {exemplar labels} ev]
        #   |   name value [timestamp]
        if "{" in line:
            brace = line.index("{")
            name = line[:brace]
            close = _close_brace(line, brace + 1)
            if close < brace:
                continue
            label_body = line[brace + 1 : close]
            rest = line[close + 1 :].strip()
            labels = _parse_labels(label_body)
        else:
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            name, rest = parts
            labels = ()
        # an exemplar suffix (`# {...} v`) is not part of the sample
        rest = rest.partition("#")[0].strip()
        value_str = rest.split()[0] if rest else ""
        try:
            value = float(value_str)  # handles +Inf/-Inf/NaN spellings
        except ValueError:
            continue
        if name:
            samples.append((name, labels, value))
    return samples
