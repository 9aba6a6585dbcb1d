"""PQL AST (reference: pql/ast.go — Query / Call / Condition)."""

from __future__ import annotations


class Condition:
    """A comparison argument: ``field <op> value`` inside Range/Row calls.

    op ∈ {'<', '<=', '>', '>=', '==', '!=', '><'}; '><' is between and
    carries a [low, high] pair.
    """

    __slots__ = ("op", "value")

    def __init__(self, op: str, value):
        self.op = op
        self.value = value

    def __repr__(self):
        return f"Condition({self.op!r}, {self.value!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Condition)
            and self.op == other.op
            and self.value == other.value
        )


class Call:
    __slots__ = ("name", "args", "children")

    def __init__(self, name: str, args: dict | None = None, children: list | None = None):
        self.name = name
        self.args = args or {}
        self.children = children or []

    def arg(self, key, default=None):
        return self.args.get(key, default)

    def condition_field(self):
        """The (field, Condition) pair if this call carries a comparison."""
        for k, v in self.args.items():
            if isinstance(v, Condition):
                return k, v
        return None, None

    def __repr__(self):
        parts = [repr(c) for c in self.children]
        parts += [f"{k}={v!r}" for k, v in self.args.items()]
        return f"{self.name}({', '.join(parts)})"

    def to_pql(self) -> str:
        """Serialize back to PQL text (used to forward sub-queries to other
        nodes — the reference ships the protobuf AST; PQL text is our
        canonical wire form)."""
        parts = [c.to_pql() for c in self.children]
        for k, v in self.args.items():
            if k == "_field":
                parts.append(str(v))
            elif k == "_col":
                parts.append(_value_to_pql(v))
            elif isinstance(v, Condition):
                if v.op == "><":
                    parts.append(f"{k} >< {_value_to_pql(v.value)}")
                else:
                    parts.append(f"{k} {v.op} {_value_to_pql(v.value)}")
            else:
                parts.append(f"{k}={_value_to_pql(v)}")
        return f"{self.name}({', '.join(parts)})"

    def __eq__(self, other):
        return (
            isinstance(other, Call)
            and self.name == other.name
            and self.args == other.args
            and self.children == other.children
        )


def _value_to_pql(v) -> str:
    if isinstance(v, Call):
        return v.to_pql()
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        escaped = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{escaped}"'
    if isinstance(v, list):
        return "[" + ", ".join(_value_to_pql(x) for x in v) + "]"
    return str(v)


class Query:
    __slots__ = ("calls",)

    def __init__(self, calls: list[Call]):
        self.calls = calls

    def __repr__(self):
        return f"Query({self.calls!r})"

    def __eq__(self, other):
        return isinstance(other, Query) and self.calls == other.calls

    def write_calls(self):
        from pilosa_tpu_torch.pql.parser import WRITE_CALLS

        return [c for c in self.calls if c.name in WRITE_CALLS]
