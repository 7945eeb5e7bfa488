"""Minimal Prometheus text-exposition parser (paddle_tpu/obs/promparse.py).

A renderer is only as trustworthy as something that parses it back:
this module is the consumer side of `obs.metrics` — a small, strict
parser for the text exposition format (version 0.0.4) used by the
tier-1 smoke test (scrape `/metrics` twice, assert every family parses
and every counter is monotonic) and by the
autoscaler's and the tests' scrapes. Deliberately dependency-free and narrower than the
official client: exactly the grammar the unified renderer emits —
`# HELP`/`# TYPE` comments, optional `{label="value"}` sets with
escaped values, float samples including +Inf/-Inf/NaN.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["Family", "ParseError", "parse_text"]

_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}


class ParseError(ValueError):
    """A line did not parse as Prometheus text exposition."""

    def __init__(self, lineno: int, line: str, why: str):
        super().__init__(f"line {lineno}: {why}: {line!r}")
        self.lineno = lineno
        self.line = line


class Family:
    """One metric family: its declared type/help plus every sample that
    belongs to it (for histograms that includes the `_bucket`/`_sum`/
    `_count` series)."""

    def __init__(self, name: str, type: str = "untyped", help: str = ""):
        self.name = name
        self.type = type
        self.help = help
        # [(sample_name, labels, value)]
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        """The single sample matching `labels` (exact match; {}/None for
        the unlabeled series). Raises KeyError when absent."""
        want = dict(labels or {})
        for name, lb, v in self.samples:
            if name == self.name and lb == want:
                return v
        raise KeyError(f"{self.name}{want}")

    def __repr__(self):
        return (f"Family({self.name!r}, type={self.type!r}, "
                f"samples={len(self.samples)})")


def _parse_value(tok: str, lineno: int, line: str) -> float:
    t = tok.strip()
    if t in ("+Inf", "Inf"):
        return float("inf")
    if t == "-Inf":
        return float("-inf")
    if t == "NaN":
        return float("nan")
    try:
        return float(t)
    except ValueError:
        raise ParseError(lineno, line, f"bad sample value {tok!r}") from None


def _parse_labels(body: str, lineno: int, line: str) -> Dict[str, str]:
    """body is the text between {{ and }} — label pairs with escaped
    values: name="va\\"lue",other="x"."""
    labels: Dict[str, str] = {}
    i, n = 0, len(body)
    while i < n:
        eq = body.find("=", i)
        if eq < 0:
            raise ParseError(lineno, line, "label without '='")
        name = body[i:eq].strip().lstrip(",").strip()
        if not name or not all(c.isalnum() or c == "_" for c in name):
            raise ParseError(lineno, line, f"bad label name {name!r}")
        if eq + 1 >= n or body[eq + 1] != '"':
            raise ParseError(lineno, line, "label value must be quoted")
        j = eq + 2
        out = []
        while j < n:
            c = body[j]
            if c == "\\":
                if j + 1 >= n:
                    raise ParseError(lineno, line, "dangling escape")
                nxt = body[j + 1]
                out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt))
                if out[-1] is None:
                    raise ParseError(lineno, line,
                                     f"bad escape \\{nxt} in label value")
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        else:
            raise ParseError(lineno, line, "unterminated label value")
        labels[name] = "".join(out)
        i = j + 1
        if i < n and body[i] == ",":
            i += 1
    return labels


def _family_of(sample_name: str, declared: Dict[str, Family]) -> str:
    """Map a sample to its family: exact name, or the histogram series
    suffixes of a declared histogram family."""
    if sample_name in declared:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            fam = declared.get(base)
            if fam is not None and fam.type in ("histogram", "summary"):
                return base
    return sample_name


def parse_text(text: str) -> Dict[str, Family]:
    """Parse one exposition into {family_name: Family}. Strict: any
    malformed line raises ParseError; a family re-declared with a
    DIFFERENT type raises too (duplicate TYPE lines are the renderer
    bug the smoke test exists to catch)."""
    families: Dict[str, Family] = {}

    def fam(name: str) -> Family:
        f = families.get(name)
        if f is None:
            f = families[name] = Family(name)
        return f

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                name = parts[2]
                if parts[1] == "TYPE":
                    typ = parts[3].strip() if len(parts) > 3 else ""
                    if typ not in _TYPES:
                        raise ParseError(lineno, raw,
                                         f"unknown metric type {typ!r}")
                    f = fam(name)
                    if f.type not in ("untyped", typ):
                        raise ParseError(
                            lineno, raw,
                            f"family {name} re-declared as {typ} "
                            f"(was {f.type})")
                    f.type = typ
                else:
                    fam(name).help = parts[3] if len(parts) > 3 else ""
            continue  # other comments are legal and ignored
        # sample line: name[{labels}] value
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < brace:
                raise ParseError(lineno, raw, "unbalanced braces")
            name = line[:brace].strip()
            labels = _parse_labels(line[brace + 1:close], lineno, raw)
            rest = line[close + 1:]
        else:
            toks = line.split(None, 1)
            if len(toks) != 2:
                raise ParseError(lineno, raw, "sample without value")
            name, rest = toks
            labels = {}
        if not name or not (name[0].isalpha() or name[0] == "_"):
            raise ParseError(lineno, raw, f"bad metric name {name!r}")
        if not all(c.isalnum() or c in "_:" for c in name):
            raise ParseError(lineno, raw, f"bad metric name {name!r}")
        value = _parse_value(rest, lineno, raw)
        fname = _family_of(name, families)
        families.setdefault(fname, Family(fname)).samples.append(
            (name, labels, value))
    return families
