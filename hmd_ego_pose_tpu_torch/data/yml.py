"""The YAML subset of the dataset files, read and written without PyYAML.

The LINEMOD layout keeps its annotations in YAML (``gt_{fold}.yml``,
``info_{fold}.yml``, ``models_info.yml``, ``mask_values.yml``).  The JAX
package reads and writes them with PyYAML's ``safe_load``/``safe_dump``; the
port runs where PyYAML is not installed, so it carries this copy of what
those two calls do for these files:

* block mappings and block sequences (a sequence under a mapping key may sit
  at the key's own indent, as ``safe_dump`` writes it), and one-line flow
  sequences ``[a, b]`` (LINEMOD's own ``gt.yml`` style);
* scalars: null, bool, decimal int and float resolved by YAML 1.1's rules as
  PyYAML applies them (so ``1e-5``, with no dot, stays a string), and plain
  strings;
* anchors and aliases (``&id001`` / ``*id001``): ``safe_dump`` anchors every
  list or dict that occurs more than once, as the generator's per-object
  ``drill_tip_transform`` does in every frame.

``dump`` writes byte for byte what ``yaml.safe_dump`` writes for such data
(sorted keys, floats as ``repr``), so a file hashes the same whichever package
wrote it.  Anything outside the subset raises ``ValueError``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Tuple

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")})
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# the forms YAML 1.1 resolves to something this subset does not take
# (binary, octal, hex and base-60 ints and floats, timestamps, merge keys)
_REFUSED = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$"
)
_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)
_INDICATORS = set("[]{}!&*|>'\"%@`#,?")
_KEY = re.compile(r"^([^\s\[\]{}!&*|>'\"%@`#,?-][^:#]*?|-[^\s:#][^:#]*?):(?:\s+(.*))?$")
_ANCHOR = re.compile(r"^&([A-Za-z0-9_-]+)(?:\s+(.*))?$")
_ALIAS = re.compile(r"^\*([A-Za-z0-9_-]+)$")
_PLAIN_STR = re.compile(r"^[A-Za-z_][A-Za-z0-9_./-]*$")


def _scalar(text: str) -> Any:
    """A plain scalar resolved as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _REFUSED.match(text):
        raise ValueError(f"YAML scalar {text!r} is outside the supported subset")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return -math.inf if value.startswith("-") else math.inf
        if value == ".nan":
            return math.nan
        return float(value)
    if text[0] in _INDICATORS or ": " in text or " #" in text or text.endswith(":"):
        raise ValueError(f"YAML scalar {text!r} is outside the supported subset")
    return text


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        raw_lines = text.splitlines()
        while raw_lines and raw_lines[-1].strip() in ("", "..."):
            raw_lines.pop()  # the document-end marker of a scalar document
        for n, raw in enumerate(raw_lines, 1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {n}: tab in indentation")
            content = raw.strip()
            if not content or content.startswith("#") or (not self.lines and content == "---"):
                continue
            if content in ("---", "...") or " #" in content:
                raise ValueError(f"line {n}: documents and comments after content are not supported")
            self.lines.append((len(raw) - len(raw.lstrip(" ")), content))
        self.anchors: Dict[str, Any] = {}
        self.pos = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        indent, content = self.lines[0]
        if indent != 0:
            raise ValueError("the document must start at column 0")
        if not _is_block_start(content):
            if len(self.lines) > 1:
                raise ValueError("a scalar document must be one line")
            return self._inline(content)
        value = self._block(0)
        if self.pos != len(self.lines):
            raise ValueError(f"unexpected content: {self.lines[self.pos][1]!r}")
        return value

    def _block(self, indent: int) -> Any:
        content = self.lines[self.pos][1]
        if content == "-" or content.startswith("- "):
            return self._sequence(indent)
        return self._mapping(indent)

    def _child(self, parent_indent: int, indentless_seq: bool) -> Any:
        """The block value after ``key:`` or ``-`` with nothing after it on the line."""
        if self.pos < len(self.lines):
            indent, content = self.lines[self.pos]
            if indent > parent_indent:
                return self._block(indent)
            if indentless_seq and indent == parent_indent and (content == "-" or content.startswith("- ")):
                return self._sequence(indent)
        return None

    def _value(self, rest: Optional[str], indent: int, indentless_seq: bool) -> Any:
        """The value after ``key:`` or ``- ``: inline, anchored, aliased or a block below."""
        anchor = None
        if rest:
            m = _ANCHOR.match(rest)
            if m:
                anchor, rest = m.group(1), m.group(2)
        if rest:
            value = self._inline(rest)
        else:
            value = self._child(indent, indentless_seq)
        if anchor is not None:
            self.anchors[anchor] = value
        return value

    def _inline(self, text: str) -> Any:
        m = _ALIAS.match(text)
        if m:
            if m.group(1) not in self.anchors:
                raise ValueError(f"alias *{m.group(1)} before its anchor")
            return self.anchors[m.group(1)]
        if text.startswith("["):
            if not text.endswith("]"):
                raise ValueError(f"flow sequence must close on its line: {text!r}")
            inner = text[1:-1].strip()
            if not inner:
                return []
            if any(c in inner for c in "[]{}&*'\""):
                raise ValueError(f"nested or quoted flow content is not supported: {text!r}")
            return [_scalar(item.strip()) for item in inner.split(",")]
        if text == "{}":
            return {}
        return _scalar(text)

    def _mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.pos < len(self.lines):
            line_indent, content = self.lines[self.pos]
            if line_indent < indent:
                break
            if line_indent > indent:
                raise ValueError(f"bad indentation at {content!r}")
            if content == "-" or content.startswith("- "):
                break
            m = _KEY.match(content)
            if m is None:
                raise ValueError(f"expected 'key: value', got {content!r}")
            key = _scalar(m.group(1).strip())
            if isinstance(key, (list, dict)) or key in out:
                raise ValueError(f"bad or repeated mapping key {m.group(1)!r}")
            self.pos += 1
            out[key] = self._value(m.group(2), indent, indentless_seq=True)
        return out

    def _sequence(self, indent: int) -> List[Any]:
        out: List[Any] = []
        while self.pos < len(self.lines):
            line_indent, content = self.lines[self.pos]
            if line_indent != indent or not (content == "-" or content.startswith("- ")):
                if line_indent > indent:
                    raise ValueError(f"bad indentation at {content!r}")
                break
            rest = content[1:].strip()
            if rest and (_is_block_start(rest) and not rest.startswith("[")):
                # "- key: v" or "- - v": a compact block that starts on this line
                self.lines[self.pos] = (indent + 2 + (len(content) - 2 - len(content[2:].lstrip())), rest)
                out.append(self._block(self.lines[self.pos][0]))
            else:
                self.pos += 1
                out.append(self._value(rest, indent, indentless_seq=False))
        return out


def _is_block_start(content: str) -> bool:
    return content == "-" or content.startswith("- ") or _KEY.match(content) is not None


def loads(text: str) -> Any:
    """Parse YAML text in the supported subset (``yaml.safe_load`` semantics)."""
    return _Reader(text).parse()


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# -- writing --------------------------------------------------------------------

def _format_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str) and _PLAIN_STR.match(value) and isinstance(_scalar(value), str):
        return value
    raise ValueError(f"cannot write {type(value).__name__} {value!r} in the YAML subset")


def _items(mapping: dict) -> list:
    items = list(mapping.items())
    try:
        return sorted(items)
    except TypeError:
        return items


class _Writer:
    def __init__(self, data: Any):
        self.anchors: Dict[int, str] = {}
        self.emitted: set = set()
        self._keep: list = []  # holds every container so ids stay unique
        seen: set = set()

        def visit(node):
            if not isinstance(node, (list, dict)):
                return
            self._keep.append(node)
            if id(node) in seen:
                if id(node) not in self.anchors:
                    self.anchors[id(node)] = f"id{len(self.anchors) + 1:03d}"
                return
            seen.add(id(node))
            for child in (node if isinstance(node, list) else [v for _, v in _items(node)]):
                visit(child)

        visit(data)
        self.out: List[str] = []

    def _head(self, node: Any) -> Optional[str]:
        """The text after ``key:``/``-`` for ``node`` if it fits on that line, else None."""
        if isinstance(node, (list, dict)):
            if id(node) in self.emitted:
                return f"*{self.anchors[id(node)]}"
            if not node:
                return "[]" if isinstance(node, list) else "{}"
            return None
        return _format_scalar(node)

    def _anchor(self, node: Any) -> str:
        if id(node) in self.anchors:
            self.emitted.add(id(node))
            return f" &{self.anchors[id(node)]}"
        return ""

    def mapping(self, node: dict, indent: int, first_prefix: Optional[str] = None) -> None:
        for n, (key, value) in enumerate(_items(node)):
            if isinstance(key, (list, dict)):
                raise ValueError("complex mapping keys are not supported")
            prefix = first_prefix if (n == 0 and first_prefix is not None) else " " * indent
            line = f"{prefix}{_format_scalar(key)}:"
            head = self._head(value)
            if head is not None:
                self.out.append(f"{line} {head}")
                continue
            self.out.append(line + self._anchor(value))
            if isinstance(value, dict):
                self.mapping(value, indent + 2)
            else:
                self.sequence(value, indent)

    def sequence(self, node: list, indent: int, first_prefix: Optional[str] = None) -> None:
        for n, item in enumerate(node):
            prefix = (first_prefix if (n == 0 and first_prefix is not None) else " " * indent) + "- "
            head = self._head(item)
            if head is not None:
                self.out.append(prefix + head)
            elif id(item) in self.anchors:
                raise ValueError("an anchored list item is outside the supported subset")
            elif isinstance(item, dict):
                self.mapping(item, indent + 2, first_prefix=prefix)
            else:
                self.sequence(item, indent + 2, first_prefix=prefix)


def dumps(data: Any) -> str:
    """YAML text of ``data``, byte-equal to ``yaml.safe_dump(data)`` within the subset."""
    writer = _Writer(data)
    head = writer._head(data)
    if head is not None:
        return head + "\n" + ("...\n" if not isinstance(data, (list, dict)) else "")
    if isinstance(data, dict):
        writer.mapping(data, 0)
    else:
        writer.sequence(data, 0)
    return "\n".join(writer.out) + "\n"


def dump(data: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(data))
