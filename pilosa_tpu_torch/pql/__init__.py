"""PQL: the Pilosa Query Language.

Reference: pql/ (SURVEY.md §2 #11) — upstream generates a PEG parser
(pigeon) from pql.peg; the grammar is an implementation detail, so this is
a compact hand-written recursive-descent parser (SURVEY.md §7.2 M2)
producing the same AST shape: a Query is a list of Calls, each with a
name, named args (ints/floats/strings/bools/lists/conditions) and child
calls. v0.x-era call names (SetBit/ClearBit/Bitmap) are accepted as
aliases for Set/Clear/Row per SURVEY.md EVIDENCE STATUS §4.
"""

from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.pql.parser import ParseError, parse
