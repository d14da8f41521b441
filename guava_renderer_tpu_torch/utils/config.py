"""Read-only dot-access configs (counterpart of `guava_renderer_tpu/utils/config.py`).

`ConfigDict` is a nested mapping with attribute access, read-only unless
unlocked, with a recursive merge of overrides and a dump that
`load_config` reads back.

Configs are read by this module's own reader of a YAML subset, with no
YAML package behind it. It covers what `configs/train/*.yaml` use:
  * block mappings nested by indentation (any consistent width);
  * block sequences (`- 16`), also at the indent of their key;
  * flow sequences (`[[173, 256], [892, 100]]`), nested, over several lines;
  * plain, 'single-quoted' and "double-quoted" strings, and `#` comments;
  * YAML 1.1 booleans (`True`, `true`, `false`, `yes`, `off`, ...) and nulls
    (`~`, `null`, an empty value);
  * decimal ints and floats with a decimal point (`0.001`, `1.0e-4`,
    `.inf`, `.nan`), read as PyYAML's safe loader reads them.
Anything else (anchors, aliases, tags, flow mappings, block scalars,
mappings inside sequences, several documents, tabs in indentation,
duplicate keys, and number forms PyYAML would read otherwise, such as
`1e-4` (a string there), `017` (octal), `1_000` or `1:30`) is refused with
its line number: the reader never reads a construct in a way PyYAML would
not.
"""

from __future__ import annotations

import copy
import io
import math
import numbers
import re
from collections.abc import Mapping
from typing import Any


class FrozenConfigError(AttributeError):
    pass


class ConfigSyntaxError(ValueError):
    """A construct outside the reader's YAML subset, or malformed YAML."""

    def __init__(self, lineno: int, msg: str, source: str = "<string>"):
        super().__init__(f"{source}:{lineno}: {msg}")
        self.lineno = lineno


class ConfigDict:
    """Nested mapping with attribute access; read-only unless unlocked."""

    def __init__(self, data: Mapping[str, Any] | str | None = None, _readonly: bool = True):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_readonly", False)
        if isinstance(data, str):
            data = _load_yaml(data)
        if data:
            for k, v in dict(data).items():
                self._data[k] = _wrap(v, readonly=False)
        if _readonly:
            self.set_readonly(True)

    # -- access ------------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"config has no key {name!r}; keys: {sorted(data)}")

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    # -- mutation ----------------------------------------------------------
    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_readonly"):
            raise FrozenConfigError(
                f"config is read-only; call set_readonly(False) before assigning {name!r}")
        self._data[name] = _wrap(value, readonly=False)

    __setitem__ = __setattr__

    def set_readonly(self, readonly: bool) -> None:
        object.__setattr__(self, "_readonly", readonly)
        for v in self._data.values():
            if isinstance(v, ConfigDict):
                v.set_readonly(readonly)

    def merge(self, other: "ConfigDict | Mapping[str, Any]") -> "ConfigDict":
        """Recursive merge; `other` wins. Returns a new read-only config."""
        return ConfigDict(_merge_dicts(self.to_dict(), _to_plain(other)))

    # -- export ------------------------------------------------------------
    def to_dict(self) -> dict:
        return _to_plain(self)

    def _raw_string(self) -> str:
        return dump_yaml(self.to_dict())

    def _dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self._raw_string())

    def __repr__(self) -> str:
        return f"ConfigDict({self.to_dict()!r})"

    def __deepcopy__(self, memo):
        return ConfigDict(copy.deepcopy(self.to_dict(), memo))


def _wrap(value: Any, readonly: bool) -> Any:
    if isinstance(value, Mapping):
        return ConfigDict(value, _readonly=readonly)
    if isinstance(value, (list, tuple)):
        return [_wrap(v, readonly) for v in value]
    return value


def _to_plain(value: Any) -> Any:
    if isinstance(value, (ConfigDict, Mapping)):
        return {k: _to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_plain(v) for v in value]
    return value


def _merge_dicts(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_yaml(f.read(), source=path)


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> ConfigDict:
    cfg = ConfigDict(path)
    if overrides:
        cfg = cfg.merge(overrides)
    return cfg


def pretty_config(cfg: ConfigDict, indent: int = 0) -> str:
    """Plain-text pretty printer (reference: utils/general_utils.py:93-121)."""
    buf = io.StringIO()
    pad = "  " * indent
    for k, v in cfg.items():
        if isinstance(v, ConfigDict):
            buf.write(f"{pad}{k}:\n")
            buf.write(pretty_config(v, indent + 1))
        else:
            buf.write(f"{pad}{k}: {v}\n")
    return buf.getvalue()


def to8b(x):
    """float [0,1] image -> uint8 (ref: utils/general_utils.py:316)."""
    import numpy as np

    return (np.clip(np.asarray(x), 0, 1) * 255).astype(np.uint8)


def inverse_sigmoid(x):
    """logit (ref: utils/general_utils.py:318-320)."""
    import numpy as np

    x = np.clip(np.asarray(x), 1e-7, 1 - 1e-7)
    return np.log(x / (1 - x))


def calc_parameters(params) -> int:
    """Total element count of an `nn.Module`'s parameters, or of the tensors
    and arrays of a (nested) state dict (ref: general_utils.py:284-292)."""
    if hasattr(params, "parameters"):
        return sum(int(p.numel()) for p in params.parameters())
    if isinstance(params, Mapping):
        return sum(calc_parameters(v) for v in params.values())
    shape = getattr(params, "shape", None)
    return math.prod(shape) if shape is not None else 0


# ---- the YAML subset ---------------------------------------------------------

_BOOLS = {w: b for b, words in ((True, "yes Yes YES true True TRUE on On ON"),
                                (False, "no No NO false False FALSE off Off OFF"))
          for w in words.split()}
_NULLS = ("~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?|\.[0-9]+(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# what PyYAML's resolvers might read as a number, a date or a time
_NUMBERISH = re.compile(r"[-+]?\.?[0-9]")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0",
            " ": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    __slots__ = ("lineno", "indent", "text")

    def __init__(self, lineno: int, indent: int, text: str):
        self.lineno, self.indent, self.text = lineno, indent, text


def _strip_comment(line: str, lineno: int, err) -> str:
    """The line without its comment; a `#` begins one outside quotes, at the
    start or after whitespace."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    if quote is not None:
        raise err(lineno, "a quoted string must end on its line")
    return line.rstrip()


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: list[_Line] = []
        for lineno, raw in enumerate(text.splitlines(), 1):
            raw = raw.rstrip("\r")
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise self.err(lineno, "tabs are not allowed in indentation")
            text_ = _strip_comment(body, lineno, self.err)
            if not text_:
                continue
            if text_ in ("---", "...") or text_.startswith(("--- ", "%")):
                raise self.err(lineno, "document markers and directives are not supported")
            self.lines.append(_Line(lineno, len(raw) - len(body), text_))
        self.i = 0

    def err(self, lineno: int, msg: str) -> ConfigSyntaxError:
        return ConfigSyntaxError(lineno, msg, self.source)

    # -- blocks ----------------------------------------------------------------
    def document(self) -> dict:
        if not self.lines:
            return {}
        first = self.lines[0]
        if first.indent != 0:
            raise self.err(first.lineno, "the document must start at column 0")
        if _is_item(first.text):
            raise self.err(first.lineno, "the document must be a mapping")
        out = self.mapping(0)
        if self.i < len(self.lines):
            ln = self.lines[self.i]
            raise self.err(ln.lineno, "unexpected indentation")
        return out

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            if ln.indent < indent:
                break
            if ln.indent > indent:
                raise self.err(ln.lineno, "unexpected indentation")
            if _is_item(ln.text):
                raise self.err(ln.lineno, "a sequence item where a key was expected")
            key, rest = self.split_key(ln)
            if key in out:
                raise self.err(ln.lineno, f"duplicate key {key!r}")
            self.i += 1
            if rest:
                out[key] = self.inline(rest, ln)
                self.no_block_below(ln)
                continue
            nxt = self.lines[self.i] if self.i < len(self.lines) else None
            if nxt is not None and nxt.indent > indent:
                out[key] = (self.sequence(nxt.indent) if _is_item(nxt.text)
                            else self.mapping(nxt.indent))
            elif nxt is not None and nxt.indent == indent and _is_item(nxt.text):
                out[key] = self.sequence(indent)
            else:
                out[key] = None
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ln = self.lines[self.i]
            if ln.indent != indent or not _is_item(ln.text):
                if ln.indent > indent:
                    raise self.err(ln.lineno, "unexpected indentation")
                break
            item = ln.text[1:].strip()
            if not item:
                raise self.err(ln.lineno, "an empty sequence item is not supported")
            if _is_item(item):
                raise self.err(ln.lineno, "nested block sequences are not supported")
            if self.find_colon(item) is not None:
                raise self.err(ln.lineno, "mappings inside sequences are not supported")
            self.i += 1
            out.append(self.inline(item, ln))
            self.no_block_below(ln)
        return out

    def no_block_below(self, ln: _Line) -> None:
        if self.i < len(self.lines) and self.lines[self.i].indent > ln.indent:
            raise self.err(self.lines[self.i].lineno, "unexpected indentation")

    def find_colon(self, text: str) -> int | None:
        """Index of the `:` that ends a key (followed by a space or the end),
        outside quotes; None when there is none."""
        quote = None
        for j, c in enumerate(text):
            if quote:
                if c == quote:
                    quote = None
            elif c in "'\"" and j == 0:
                quote = c
            elif c == ":" and (j + 1 == len(text) or text[j + 1] == " "):
                return j
        return None

    def split_key(self, ln: _Line) -> tuple[str, str]:
        j = self.find_colon(ln.text)
        if j is None:
            raise self.err(ln.lineno, "expected 'key: value'")
        raw = ln.text[:j].strip()
        if raw[:1] in "'\"":
            key = self.quoted(raw, ln)
        elif _KEY.fullmatch(raw) and raw not in _BOOLS and raw not in _NULLS:
            key = raw
        else:
            raise self.err(ln.lineno, f"unsupported key {raw!r}")
        return key, ln.text[j + 1:].strip()

    # -- scalars and flow sequences ---------------------------------------------
    def inline(self, text: str, ln: _Line):
        if text.startswith("["):
            while _depth(text) > 0:
                if self.i >= len(self.lines):
                    raise self.err(ln.lineno, "unterminated flow sequence")
                text += " " + self.lines[self.i].text
                self.i += 1
            value, pos = self.flow(text, 0, ln)
            if text[pos:].strip():
                raise self.err(ln.lineno, f"unexpected text after a flow sequence: {text[pos:]!r}")
            return value
        if text == "{}":
            return {}
        return self.scalar(text, ln, flow=False)

    def flow(self, text: str, pos: int, ln: _Line):
        """Parse the flow sequence starting at text[pos] == '['."""
        out = []
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise self.err(ln.lineno, "unterminated flow sequence")
            if text[pos] == "]":
                return out, pos + 1
            if text[pos] == "[":
                item, pos = self.flow(text, pos, ln)
            elif text[pos] in "'\"":
                end = _quote_end(text, pos)
                if end is None:
                    raise self.err(ln.lineno, "unterminated quoted string")
                item, pos = self.quoted(text[pos:end], ln), end
            else:
                end = pos
                while end < len(text) and text[end] not in ",]":
                    end += 1
                item, pos = self.scalar(text[pos:end].strip(), ln, flow=True), end
            out.append(item)
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos < len(text) and text[pos] == ",":
                pos += 1
            elif pos < len(text) and text[pos] != "]":
                raise self.err(ln.lineno, f"expected ',' or ']' in a flow sequence at {text[pos:]!r}")

    def scalar(self, text: str, ln: _Line, flow: bool):
        if text[:1] in "'\"":
            return self.quoted(text, ln)
        if not text:
            raise self.err(ln.lineno, "an empty flow sequence item is not supported")
        if text[0] in "&*!|>%@`{}],#?" or (text[0] in "-:" and (len(text) == 1 or text[1] == " ")):
            raise self.err(ln.lineno, f"unsupported construct {text!r}")
        if ": " in text or text.endswith(":") or (flow and "[" in text):
            raise self.err(ln.lineno, f"unsupported plain scalar {text!r}")
        if text in _BOOLS:
            return _BOOLS[text]
        if text in _NULLS:
            return None
        if _INT.fullmatch(text):
            return int(text)
        if _FLOAT.fullmatch(text):
            return float(text)
        m = _INF.fullmatch(text)
        if m:
            return -math.inf if m.group(1) == "-" else math.inf
        if _NAN.fullmatch(text):
            return math.nan
        if _NUMBERISH.match(text) or text in ("=", "<<"):
            raise self.err(ln.lineno, f"unsupported number, date or special form {text!r} "
                                      "(write floats with a decimal point, e.g. 1.0e-4, "
                                      "or quote the string)")
        return text

    def quoted(self, text: str, ln: _Line) -> str:
        end = _quote_end(text, 0)
        if end != len(text):
            raise self.err(ln.lineno, f"unexpected text after a quoted string: {text!r}")
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        out, j = [], 0
        while j < len(body):
            c = body[j]
            if c != "\\":
                out.append(c)
                j += 1
                continue
            e = body[j + 1] if j + 1 < len(body) else ""
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = body[j + 2:j + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise self.err(ln.lineno, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise self.err(ln.lineno, f"unsupported escape \\{e}")
        return "".join(out)


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _quote_end(text: str, pos: int) -> int | None:
    """Index just past the quoted string that starts at text[pos]."""
    q = text[pos]
    j = pos + 1
    while j < len(text):
        if q == "'" and text[j] == "'":
            if j + 1 < len(text) and text[j + 1] == "'":
                j += 2
                continue
            return j + 1
        if q == '"':
            if text[j] == "\\":
                j += 2
                continue
            if text[j] == '"':
                return j + 1
        j += 1
    return None


def _depth(text: str) -> int:
    """Open '[' minus ']' outside quotes."""
    depth, j = 0, 0
    while j < len(text):
        c = text[j]
        if c in "'\"":
            end = _quote_end(text, j)
            if end is None:
                return depth
            j = end
            continue
        depth += (c == "[") - (c == "]")
        j += 1
    return depth


def parse_yaml(text: str, source: str = "<string>") -> dict:
    """The mapping a config file holds (the subset in the module docstring)."""
    return _Reader(text, source).document()


# ---- the writer --------------------------------------------------------------

def _reads_back(s: str, flow: bool) -> bool:
    """Whether `s` written plain reads back as the string `s`."""
    text = f"k: [{s}]" if flow else f"k: {s}"
    try:
        return parse_yaml(text) == {"k": [s] if flow else s}
    except ConfigSyntaxError:
        return False


def _dump_str(s: str, flow: bool) -> str:
    if s and s.isprintable() and _reads_back(s, flow):
        return s
    if s.isprintable():
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c == "\\" or c == '"':
            out.append("\\" + c)
        elif c.isprintable():
            out.append(c)
        else:
            out.append(f"\\U{ord(c):08x}")
    return '"' + "".join(out) + '"'


def _dump_scalar(v, flow: bool) -> str:
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        v = v.item()                  # a numpy or torch scalar
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, numbers.Integral):
        return str(int(v))
    if isinstance(v, numbers.Real):
        v = float(v)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        elif "." not in r:
            r += ".0"
        return r
    if isinstance(v, str):
        return _dump_str(v, flow)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x, True) for x in v) + "]"
    if isinstance(v, Mapping):
        if v:
            raise TypeError("a mapping inside a sequence cannot be written")
        return "{}"
    raise TypeError(f"cannot write a {type(v).__name__} to a config")


def _dump_key(k) -> str:
    if not isinstance(k, str):
        raise TypeError(f"config keys must be strings, got {k!r}")
    if _KEY.fullmatch(k) and k not in _BOOLS and k not in _NULLS:
        return k
    if not k.isprintable():
        raise TypeError(f"config key {k!r} cannot be written")
    return "'" + k.replace("'", "''") + "'"


def dump_yaml(data: Mapping, indent: int = 0) -> str:
    """YAML text that `parse_yaml` reads back to `data` (ints, floats,
    bools, None, strings, lists of those, nested mappings)."""
    pad = " " * indent
    lines = []
    for k, v in data.items():
        key = _dump_key(k)
        if isinstance(v, Mapping) and v:
            lines.append(f"{pad}{key}:\n" + dump_yaml(v, indent + 2))
        else:
            lines.append(f"{pad}{key}: {_dump_scalar(v, False)}\n")
    return "".join(lines)
