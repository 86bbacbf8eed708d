"""JSON-lines filter + projection.

Behavioral match of reference weed/query/json/query_json.go:18-105
(gjson-based): a Query(field, op, value) filters each JSON line by the
field's *runtime type* — string ops compare lexically, number ops
numerically, booleans have the reference's quirky ordering table — and
projections pull dotted-path fields from passing lines. The `%` / `!%`
ops are glob matches (tidwall/match → fnmatch).

The port of seaweedfs_tpu/query/json_query.py."""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass
from typing import Any

_MISSING = object()


@dataclass
class Query:
    field: str = ""
    op: str = ""
    value: str = ""


def get_path(obj: Any, path: str):
    """gjson-style path lookup (gjson.Get role, query_json.go:18).

    Supported path syntax (the subset the reference's queries use):
      a.b.c    dotted descent through objects
      a.2.c    integer segments index arrays (no negative indices,
               matching gjson)
      a.*.c    `*`/`?` glob segments match object keys; the FIRST
               matching key wins (gjson's wildcard rule)
      a.#      length of the array at `a`
      a.#.c    collects `c` from every element of `a` (elements where
               the sub-path is absent are skipped, like gjson)
    Returns _MISSING when any segment can't resolve."""
    return _get(obj, path.split("."))


def _get(cur: Any, segs: list[str]):
    for i, seg in enumerate(segs):
        if isinstance(cur, dict):
            if seg in cur:
                cur = cur[seg]
                continue
            if "*" in seg or "?" in seg:
                rest = segs[i + 1 :]
                for k in cur:
                    if fnmatch.fnmatchcase(k, seg):
                        v = _get(cur[k], rest)
                        if v is not _MISSING:
                            return v
                return _MISSING
            return _MISSING
        if isinstance(cur, list):
            if seg == "#":
                rest = segs[i + 1 :]
                if not rest:
                    return len(cur)
                return [
                    v
                    for el in cur
                    if (v := _get(el, rest)) is not _MISSING
                ]
            try:
                idx = int(seg)
            except ValueError:
                return _MISSING
            if idx < 0 or idx >= len(cur):
                return _MISSING
            cur = cur[idx]
            continue
        return _MISSING
    return cur


def _filter(doc: Any, q: Query) -> bool:
    if not q.field:
        return True  # no filter: projection-only select passes all
    value = get_path(doc, q.field)
    if value is _MISSING:
        return False
    if q.op == "":
        return True  # existence check
    rpv = q.value
    if isinstance(value, str):
        table = {
            "=": value == rpv,
            "!=": value != rpv,
            "<": value < rpv,
            "<=": value <= rpv,
            ">": value > rpv,
            ">=": value >= rpv,
            "%": fnmatch.fnmatchcase(value, rpv),
            "!%": not fnmatch.fnmatchcase(value, rpv),
        }
        return table.get(q.op, False)
    if isinstance(value, bool):
        # gjson True/False tables (query_json.go:81-104)
        if value:
            return {
                "=": rpv == "true",
                "!=": rpv != "true",
                ">": rpv == "false",
                ">=": True,
            }.get(q.op, False)
        return {
            "=": rpv == "false",
            "!=": rpv != "false",
            "<": rpv == "true",
            "<=": True,
        }.get(q.op, False)
    if isinstance(value, (int, float)):
        try:
            rpvn = float(rpv)
        except ValueError:
            rpvn = 0.0
        table = {
            "=": value == rpvn,
            "!=": value != rpvn,
            "<": value < rpvn,
            "<=": value <= rpvn,
            ">": value > rpvn,
            ">=": value >= rpvn,
        }
        return table.get(q.op, False)
    return False


def query_json(
    json_line: str, projections: list[str], query: Query
) -> tuple[bool, list]:
    """(passed_filter, projected values) for one JSON line
    (QueryJson, query_json.go:18)."""
    try:
        doc = json.loads(json_line)
    except ValueError:
        return False, []
    if not _filter(doc, query):
        return False, []
    values = []
    for p in projections:
        v = get_path(doc, p)
        values.append(None if v is _MISSING else v)
    return True, values
