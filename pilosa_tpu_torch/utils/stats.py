"""Prometheus text rendering for ``GET /metrics`` (the port's copy of the
renderer half of ``pilosa_tpu.utils.stats``; the stats registry comes
with the serving planes).

Every block renders through ``prometheus_block``: each family leads with
``# HELP`` and ``# TYPE`` (names ending in ``_total`` are counters, the
rest gauges), ints print exactly, and ``seen`` dedupes family metadata
across the blocks of one page.
"""

from __future__ import annotations


def escape_label(value) -> str:
    """Prometheus label-value escaping: backslash, double quote and
    newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: dict | None) -> str:
    if not tags:
        return ""
    inner = ",".join(f'{k}="{escape_label(v)}"'
                     for k, v in sorted(tags.items()))
    return "{" + inner + "}"


def _meta_lines(family: str, mtype: str, help_text: str | None,
                seen: set) -> list[str]:
    """``# HELP`` and ``# TYPE`` of one family, once a page."""
    if family in seen:
        return []
    seen.add(family)
    return [
        f"# HELP {family} {help_text or family.replace('_', ' ')}",
        f"# TYPE {family} {mtype}",
    ]


def prometheus_block(pairs: dict, prefix: str, subsystem: str = "",
                     help_map: dict | None = None,
                     seen: set | None = None) -> str:
    """A name -> value dict as Prometheus lines with their metadata."""
    seen = seen if seen is not None else set()
    lines: list[str] = []
    middle = f"{subsystem}_" if subsystem else ""
    for name, value in sorted(pairs.items()):
        family = f"{prefix}_{middle}{name}"
        mtype = "counter" if name.endswith("_total") else "gauge"
        lines.extend(_meta_lines(
            family, mtype, (help_map or {}).get(name), seen
        ))
        # ints exactly: %g would round large counters to 6 digits
        rendered = value if isinstance(value, int) else f"{value:g}"
        lines.append(f"{family} {rendered}")
    return "\n".join(lines) + ("\n" if lines else "")
