"""Copy of ``recmv_tpu/config/hocon.py``, kept byte-for-byte apart from this note and
its imports: the port runs where JAX is absent, and importing any
``recmv_tpu`` module imports JAX.

Minimal HOCON parser with the pyhocon API surface REC-MV configs use.

The reference parses its configs with pyhocon (``train.py:82`` in the
reference repo); the configs themselves only exercise a small HOCON
subset: nested object blocks, ``key = value`` pairs, multiline lists,
``#``/``//`` comments, and quoted-number strings like ``"60."`` that are
later consumed through ``get_float``. This module implements exactly that
subset plus dotted-path lookup, so reference ``.conf`` files parse
unchanged without the pyhocon dependency.
"""

from __future__ import annotations

import re
from typing import Any, Iterator


class ConfigTree(dict):
    """A nested dict with pyhocon-style typed getters and dotted paths."""

    def _resolve(self, path: str) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigTree) and part in dict.keys(node):
                node = dict.__getitem__(node, part)
            else:
                raise KeyError(path)
        return node

    # -- membership with dotted paths (the reference uses `'a.b' in conf`)
    def __contains__(self, path) -> bool:  # type: ignore[override]
        try:
            self._resolve(str(path))
            return True
        except KeyError:
            return False

    def get(self, path, default=None):
        try:
            return self._resolve(str(path))
        except KeyError:
            return default

    def get_config(self, path: str) -> "ConfigTree":
        v = self._resolve(path)
        if not isinstance(v, ConfigTree):
            raise TypeError(f"{path} is not a config object: {v!r}")
        return v

    def get_int(self, path: str, default=None) -> int:
        try:
            return int(float(self._resolve(path)))
        except KeyError:
            if default is not None:
                return default
            raise

    def get_float(self, path: str, default=None) -> float:
        try:
            return float(self._resolve(path))
        except KeyError:
            if default is not None:
                return default
            raise

    def get_string(self, path: str, default=None) -> str:
        try:
            return str(self._resolve(path))
        except KeyError:
            if default is not None:
                return default
            raise

    def get_bool(self, path: str, default=None) -> bool:
        try:
            v = self._resolve(path)
        except KeyError:
            if default is not None:
                return default
            raise
        if isinstance(v, bool):
            return v
        if isinstance(v, str):
            return v.strip().lower() in ("true", "yes", "on", "1")
        return bool(v)

    def get_list(self, path: str, default=None) -> list:
        try:
            v = self._resolve(path)
        except KeyError:
            if default is not None:
                return default
            raise
        if not isinstance(v, list):
            raise TypeError(f"{path} is not a list: {v!r}")
        return v

    def put(self, path: str, value) -> None:
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            nxt = dict.get(node, p)
            if not isinstance(nxt, ConfigTree):
                nxt = ConfigTree()
                dict.__setitem__(node, p, nxt)
            node = nxt
        dict.__setitem__(node, parts[-1], value)

    def as_plain_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.as_plain_dict() if isinstance(v, ConfigTree) else v
        return out


_TOKEN_RE = re.compile(
    r"""
    (?P<lbrace>\{) | (?P<rbrace>\}) |
    (?P<lbrack>\[) | (?P<rbrack>\]) |
    (?P<assign>[=:]) |
    (?P<comma>,) |
    (?P<newline>\n) |
    (?P<dqstring>"(?:[^"\\]|\\.)*") |
    (?P<ws>[ \t\r]+) |
    (?P<bare>[^\s{}\[\],=:]+)
    """,
    re.VERBOSE,
)


def _strip_comments(text: str) -> str:
    out_lines = []
    for line in text.split("\n"):
        in_str = False
        cut = len(line)
        i = 0
        while i < len(line):
            c = line[i]
            if c == '"' and (i == 0 or line[i - 1] != "\\"):
                in_str = not in_str
            elif not in_str:
                if c == "#":
                    cut = i
                    break
                if c == "/" and i + 1 < len(line) and line[i + 1] == "/":
                    cut = i
                    break
            i += 1
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def _tokens(text: str) -> Iterator[tuple[str, str]]:
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"HOCON tokenize error at offset {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        yield kind, m.group()


class _Parser:
    def __init__(self, text: str):
        self.toks = list(_tokens(_strip_comments(text)))
        self.i = 0

    def _peek(self):
        while self.i < len(self.toks) and self.toks[self.i][0] == "newline":
            self.i += 1
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def _next(self):
        tok = self._peek()
        self.i += 1
        return tok

    def parse_root(self) -> ConfigTree:
        tree = ConfigTree()
        while self._peek()[0] is not None:
            self._parse_entry(tree)
        return tree

    def _parse_entry(self, tree: ConfigTree) -> None:
        kind, val = self._next()
        if kind == "comma":
            return
        if kind not in ("bare", "dqstring"):
            raise ValueError(f"expected key, got {kind} {val!r}")
        key = val[1:-1] if kind == "dqstring" else val
        kind2, _ = self._peek()
        if kind2 == "lbrace":
            self._next()
            sub = dict.get(tree, key)
            if not isinstance(sub, ConfigTree):
                sub = ConfigTree()
            self._parse_object_body(sub)
            tree.put(key, sub)
        elif kind2 == "assign":
            self._next()
            value = self._parse_value()
            tree.put(key, value)
        else:
            raise ValueError(f"expected '=' or '{{' after key {key!r}, got {kind2}")

    def _parse_object_body(self, tree: ConfigTree) -> None:
        while True:
            kind, _ = self._peek()
            if kind is None:
                raise ValueError("unexpected EOF inside object")
            if kind == "rbrace":
                self._next()
                return
            self._parse_entry(tree)

    def _parse_value(self):
        kind, val = self._peek()
        if kind == "lbrace":
            self._next()
            sub = ConfigTree()
            self._parse_object_body(sub)
            return sub
        if kind == "lbrack":
            self._next()
            return self._parse_list()
        if kind == "dqstring":
            self._next()
            return val[1:-1].replace('\\"', '"')
        if kind == "bare":
            # Bare values run until end-of-line in HOCON; configs here only
            # use single-token scalars, so a single token suffices.
            self._next()
            return _coerce_scalar(val)
        raise ValueError(f"unexpected token for value: {kind} {val!r}")

    def _parse_list(self) -> list:
        items: list = []
        while True:
            kind, _ = self._peek()
            if kind is None:
                raise ValueError("unexpected EOF inside list")
            if kind == "rbrack":
                self._next()
                return items
            if kind == "comma":
                self._next()
                continue
            items.append(self._parse_value())


def _coerce_scalar(tok: str):
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


class ConfigFactory:
    """Drop-in for ``pyhocon.ConfigFactory`` over the supported subset."""

    @staticmethod
    def parse_file(path: str) -> ConfigTree:
        with open(path, "r") as f:
            return _Parser(f.read()).parse_root()

    @staticmethod
    def parse_string(text: str) -> ConfigTree:
        return _Parser(text).parse_root()


def dump_config(tree: ConfigTree, indent: int = 0) -> str:
    """Serialize a ConfigTree back to HOCON text (for saving the active
    config next to outputs, mirroring reference train.py:103)."""
    pad = "  " * indent
    lines = []
    for k, v in tree.items():
        if isinstance(v, ConfigTree):
            lines.append(f"{pad}{k} {{")
            lines.append(dump_config(v, indent + 1))
            lines.append(f"{pad}}}")
        elif isinstance(v, list):
            lines.append(f"{pad}{k} = [")
            for item in v:
                lines.append(f"{pad}  {_fmt_scalar(item)}")
            lines.append(f"{pad}]")
        else:
            lines.append(f"{pad}{k} = {_fmt_scalar(v)}")
    return "\n".join(lines)


def _fmt_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return f'"{v}"'
    return str(v)
