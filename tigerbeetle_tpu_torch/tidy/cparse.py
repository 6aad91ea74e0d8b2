"""Minimal C front end for the nativecheck passes (tidy/nativecheck.py).

Three services over the `csrc/` sources, each deliberately smaller than a
real C compiler front end because the inputs are the repo's own shims
(C99, no macros-with-arguments on the paths we analyze):

  - `parse_defines` — object-like `#define NAME <const-expr>` constants,
    folded with the same tiny evaluator the absint pass uses for Python
    (`(1u << 21)`, sums, ors). The layout-parity pass compares these
    against the authoritative Python dtypes.
  - `parse_functions` — top-level function declarations/definitions:
    return type, parameter types (width / signedness / pointer depth),
    static-ness, and the body token range for definitions. The ctypes-ABI
    pass checks `native/__init__.py` against the non-static ones; the C
    absint pass parses the bodies of the manifest-listed ones.
  - `parse_body` — a recursive-descent statement/expression parser for
    the analyzed function bodies (declarations, if/while/for, assignment,
    ++/--, calls, subscripts, casts, ternary, member access). Constructs
    the small AST interpreted by nativecheck's interval analysis and by
    tidy/absint.py's CUDA front end.

The CUDA device helpers (`csrc/*.cuh` under the package) are read as the
same subset plus what they use of C++: `namespace` blocks (transparent),
`__device__` / `__forceinline__` / `constexpr` / `__restrict__`
qualifiers, reference parameters (`CParam.ref`), `bool`, `unsigned
__int128`, `reinterpret_cast<T>(e)` / `static_cast<T>(e)`, and the
`typedef_types` / `parse_constexprs` / `collect_structs` tables. Casts
keep their target type and literals their suffix, which the width-aware
absint needs.

`/* tidy: ... */` and `// tidy: ...` comments are collected into the same
`LineAnnotations` objects the Python annotation module produces, so
`range=` / `bound=` / `allow=` carry identical grammar and lookup
semantics on both sides of the language boundary.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy.annotations import (
    KNOWN_KEYS,
    LineAnnotations,
    _parse_comment,
)

# `bound=` declares element counts for pointer parameters (C has no
# array lengths to read); everything else mirrors the Python key set.
C_KNOWN_KEYS = frozenset(KNOWN_KEYS | {"bound"})


# --- lexer ---------------------------------------------------------------

@dataclass(frozen=True)
class Tok:
    kind: str  # "id" | "num" | "str" | "punct" | "eof"
    text: str
    line: int


_PUNCTS = (
    ">>=", "<<=", "...", "->", "++", "--", "<<", ">>", "<=", ">=", "==",
    "!=", "&&", "||", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
)

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<blockcomment>/\*.*?\*/)
  | (?P<linecomment>//[^\n]*)
  | (?P<num>(?:0[xX][0-9a-fA-F]+|\d+\.\d+[fF]?|\d+)(?:[uUlL]+)?)
  | (?P<id>[A-Za-z_]\w*)
  | (?P<str>"(?:\\.|[^"\\])*")
  | (?P<char>'(?:\\.|[^'\\])+')
  | (?P<punct>%s|[-+*/%%<>=!&|^~?:;,.(){}\[\]#])
    """
    % "|".join(re.escape(p) for p in _PUNCTS),
    re.VERBOSE | re.DOTALL,
)

_TIDY_RE = re.compile(r"tidy:\s*(.*)$", re.DOTALL)


def lex(source: str) -> Tuple[List[Tok], Dict[int, LineAnnotations]]:
    """Tokens (preprocessor lines skipped) + tidy annotations by line.
    A tidy comment alone on its source line binds to the NEXT line
    (`own_line`), exactly like the Python tokenizer's convention."""
    toks: List[Tok] = []
    anns: Dict[int, LineAnnotations] = {}
    lines = source.splitlines()
    # Blank out preprocessor lines (incl. backslash continuations) so the
    # token stream is pure C; parse_defines reads them separately.
    clean = []
    cont = False
    for ln in lines:
        is_pp = cont or ln.lstrip().startswith("#")
        cont = is_pp and ln.rstrip().endswith("\\")
        clean.append("" if is_pp else ln)
    text = "\n".join(clean)
    pos, line = 0, 1
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:  # stray byte: skip, keep line count honest
            if text[pos] == "\n":
                line += 1
            pos += 1
            continue
        kind = m.lastgroup
        tok = m.group()
        if kind in ("blockcomment", "linecomment"):
            body = tok[2:-2] if kind == "blockcomment" else tok[2:]
            tm = _TIDY_RE.search(body.strip())
            if tm:
                clauses, reason = _parse_comment(
                    " ".join(tm.group(1).split())
                )
                src_line = lines[line - 1] if line <= len(lines) else ""
                own = src_line.lstrip().startswith(("/*", "//"))
                anns[line] = LineAnnotations(
                    line, clauses, reason, own_line=own
                )
        elif kind == "ws":
            pass
        else:
            k = {"char": "num"}.get(kind, kind)
            toks.append(Tok(k, tok, line))
        line += tok.count("\n")
        pos = m.end()
    toks.append(Tok("eof", "", line))
    return toks, anns


# --- #define constants ---------------------------------------------------

_DEFINE_RE = re.compile(r"^\s*#\s*define\s+(\w+)(\(?)\s*(.*?)\s*$")


def _fold_const(expr: str, env: Dict[str, int]) -> Optional[int]:
    """Fold a constant C expression (ints with u/l suffixes, + - * << >>
    | & ^ ~, parens, names already folded into `env`). None if not
    constant."""
    toks, _ = lex(expr + "\n")
    vals: List[str] = []
    for t in toks:
        if t.kind == "num":
            body = t.text.rstrip("uUlL")
            if "." in body or body.lower().rstrip("f").count(".") or (
                body.endswith(("f", "F")) and "x" not in body.lower()
            ):
                return None
            try:
                vals.append(str(int(body, 0)))
            except ValueError:
                return None
        elif t.kind == "id":
            if t.text not in env:
                return None
            vals.append(str(env[t.text]))
        elif t.kind == "punct":
            if t.text not in ("+", "-", "*", "<<", ">>", "|", "&", "^",
                              "~", "(", ")", "/", "%"):
                return None
            vals.append(t.text)
        elif t.kind == "eof":
            break
        else:
            return None
    if not vals:
        return None
    try:
        v = eval(" ".join(vals), {"__builtins__": {}}, {})  # noqa: S307
        return v if isinstance(v, int) else None
    except Exception:  # noqa: BLE001 — non-constant define: skip
        return None


def parse_defines(source: str) -> Dict[str, Tuple[int, int]]:
    """Object-like defines that fold to ints: name -> (value, line)."""
    out: Dict[str, Tuple[int, int]] = {}
    env: Dict[str, int] = {}
    buf, start = None, 0
    for i, raw in enumerate(source.splitlines(), start=1):
        if buf is not None:
            buf += " " + raw.rstrip("\\")
            if not raw.rstrip().endswith("\\"):
                m = _DEFINE_RE.match(buf)
                buf = None
                if m and m.group(2) != "(":
                    v = _fold_const(m.group(3), env)
                    if v is not None:
                        out[m.group(1)] = (v, start)
                        env[m.group(1)] = v
            continue
        if raw.lstrip().startswith("#"):
            if raw.rstrip().endswith("\\"):
                buf, start = raw.rstrip("\\"), i
                continue
            m = _DEFINE_RE.match(raw)
            if m and m.group(2) != "(":
                v = _fold_const(m.group(3), env)
                if v is not None:
                    out[m.group(1)] = (v, i)
                    env[m.group(1)] = v
    return out


# --- types ---------------------------------------------------------------

@dataclass(frozen=True)
class CType:
    """base: 'void' | 'int' | 'float' | 'named:<id>'; width in bits for
    ints; ptr = pointer depth (char* has base int/width 8/ptr 1)."""

    base: str
    width: Optional[int] = None
    signed: Optional[bool] = None
    ptr: int = 0
    boolean: bool = False  # C++ `bool` (an 8-bit int whose values are 0, 1)

    @property
    def is_pointer(self) -> bool:
        return self.ptr > 0


_FIXED = {
    "uint8_t": (8, False), "uint16_t": (16, False),
    "uint32_t": (32, False), "uint64_t": (64, False),
    "int8_t": (8, True), "int16_t": (16, True),
    "int32_t": (32, True), "int64_t": (64, True),
    "size_t": (64, False), "ssize_t": (64, True),
    "uintptr_t": (64, False), "intptr_t": (64, True),
    "off_t": (64, True),
}
_QUALIFIERS = frozenset((
    "const", "volatile", "restrict", "static", "inline", "extern",
    "register", "_Thread_local", "struct", "union", "enum",
    # CUDA C++ function and pointer qualifiers.
    "__device__", "__host__", "__global__", "__forceinline__",
    "__noinline__", "constexpr", "__restrict__", "__restrict",
))
_BASE_WORDS = frozenset((
    "void", "char", "short", "int", "long", "unsigned", "signed",
    "float", "double", "_Bool", "bool", "__int128",
))
TYPE_START = _QUALIFIERS | _BASE_WORDS | frozenset(_FIXED)


def type_from_tokens(words: List[str], ptr: int) -> CType:
    """CType from the identifier words of a declaration specifier."""
    ws = [w for w in words if w not in _QUALIFIERS]
    for w in ws:
        if w in _FIXED:
            width, signed = _FIXED[w]
            return CType("int", width, signed, ptr)
    if "void" in ws:
        return CType("void", None, None, ptr)
    if "float" in ws or "double" in ws:
        return CType("float", 64 if "double" in ws else 32, True, ptr)
    if "bool" in ws or "_Bool" in ws:
        return CType("int", 8, False, ptr, boolean=True)
    if any(w in ("char", "short", "int", "long", "unsigned", "signed",
                 "__int128") for w in ws):
        signed = "unsigned" not in ws
        if "__int128" in ws:
            width = 128
        elif "char" in ws:
            width = 8
        elif "short" in ws:
            width = 16
        elif ws.count("long"):
            width = 64
        else:
            width = 32
        return CType("int", width, signed, ptr)
    named = next((w for w in ws), "")
    return CType(f"named:{named}", None, None, ptr)


def collect_typedefs(source: str) -> frozenset:
    """Names introduced by `typedef ... name;` (incl. `} name;`)."""
    names = set()
    for m in re.finditer(r"typedef\b[^;{]*?(\w+)\s*;", source):
        names.add(m.group(1))
    for m in re.finditer(r"typedef\s+struct\s*\{.*?\}\s*(\w+)\s*;",
                         source, re.DOTALL):
        names.add(m.group(1))
    return frozenset(names)


def typedef_types(source: str) -> Dict[str, CType]:
    """Scalar typedefs, `typedef <type words> name;` -> the aliased type
    (`typedef unsigned __int128 u128;`)."""
    out: Dict[str, CType] = {}
    for m in re.finditer(r"\btypedef\s+([\w\s\*]+?)\b(\w+)\s*;", source):
        words = m.group(1).split()
        if words and words[0] not in ("struct", "union", "enum"):
            out[m.group(2)] = type_from_tokens(
                [w.strip("*") for w in words], m.group(1).count("*"))
    return out


_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+([\w\s]+?)\s+(\w+)\s*=\s*([^;{}]+);")


def parse_constexprs(source: str) -> Dict[str, int]:
    """`constexpr <int type> NAME = <const-expr>;` -> value, folded in
    source order and wrapped to the declared width (so `~0x3Fu` is the
    unsigned word it denotes)."""
    out: Dict[str, int] = {}
    for m in _CONSTEXPR_RE.finditer(_strip_comments(source)):
        ct = type_from_tokens(m.group(1).split(), 0)
        v = _fold_const(m.group(3), dict(out))
        if v is None or ct.base != "int":
            continue
        if not ct.signed:
            v &= (1 << ct.width) - 1
        out[m.group(2)] = v
    return out


def _strip_comments(source: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", " ", source, flags=re.DOTALL)


def collect_structs(source: str) -> Dict[str, List[Tuple[str, CType]]]:
    """`struct Name { <fields> };` -> [(field, type)] for the data
    members (member functions and their bodies are skipped)."""
    text = _strip_comments(source)
    out: Dict[str, List[Tuple[str, CType]]] = {}
    for m in re.finditer(r"\bstruct\s+(\w+)\s*\{", text):
        k, depth = m.end(), 1
        while k < len(text) and depth:
            depth += {"{": 1, "}": -1}.get(text[k], 0)
            k += 1
        body = text[m.end():k - 1]
        # Drop nested bodies (member functions) before splitting fields.
        flat, depth = [], 0
        for ch in body:
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                flat.append(";")
            elif depth == 0:
                flat.append(ch)
        fields = []
        for decl in "".join(flat).split(";"):
            if "(" in decl or not decl.strip():
                continue
            words = decl.replace("*", " * ").split()
            names = [w for w in words if w != "*"]
            if len(names) < 2:
                continue
            fields.append((names[-1], type_from_tokens(
                names[:-1], words.count("*"))))
        out[m.group(1)] = fields
    return out


# --- function declarations ----------------------------------------------

@dataclass(frozen=True)
class CParam:
    name: str
    ctype: CType
    ref: bool = False  # a C++ reference parameter (`T& name`)


@dataclass
class CFunc:
    name: str
    ret: CType
    params: List[CParam]
    line: int
    static: bool
    body: Optional[Tuple[int, int]] = None  # token span of `{...}` or None


def _parse_param(toks: List[Tok], typedefs: frozenset) -> Optional[CParam]:
    words, ptr, name, ref = [], 0, "", False
    for t in toks:
        if t.kind == "punct" and t.text == "=":
            break  # a C++ default argument: the declarator is complete
        if t.kind == "punct" and t.text == "*":
            ptr += 1
        elif t.kind == "punct" and t.text == "&":
            ref = True
        elif t.kind == "punct" and t.text in ("[", "]"):
            if t.text == "[":
                ptr += 1  # `T a[]` parameter decays to pointer
        elif t.kind == "id":
            if (t.text in TYPE_START or t.text in typedefs
                    or not [w for w in words if w not in _QUALIFIERS]):
                words.append(t.text)
                name = t.text  # last id wins as the name
            else:
                name = t.text
        elif t.kind == "num":
            pass  # `T a[16]` in a parameter: still a pointer
    if not words and not name:
        return None
    # The final identifier is the parameter name unless it is the sole
    # type word (unnamed parameter, e.g. prototypes in headers).
    if name in _FIXED or name in _BASE_WORDS or name in typedefs:
        return CParam("", type_from_tokens(words, ptr), ref)
    twords = [w for w in words if w != name] or words
    return CParam(name, type_from_tokens(twords, ptr), ref)


def parse_functions(source: str) -> List[CFunc]:
    """Top-level function declarations and definitions."""
    toks, _ = lex(source)
    typedefs = collect_typedefs(source) | frozenset(collect_structs(source))
    out: List[CFunc] = []
    i, depth = 0, 0
    decl_start = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        if t.kind == "punct" and t.text == "{":
            # `extern "C" {` and `namespace [name] {` are transparent:
            # their contents are top-level.
            extern_c = (i >= 2 and toks[i - 1].kind == "str"
                        and toks[i - 2].kind == "id"
                        and toks[i - 2].text == "extern")
            namespace = depth == 0 and any(
                i >= k and toks[i - k].kind == "id"
                and toks[i - k].text == "namespace" for k in (1, 2)
            )
            if not (extern_c or namespace):
                depth += 1
            else:
                decl_start = i + 1
        elif t.kind == "punct" and t.text == "}":
            depth = max(0, depth - 1)
            if depth == 0:
                decl_start = i + 1
        elif t.kind == "punct" and t.text == ";" and depth == 0:
            decl_start = i + 1
        elif (depth == 0 and t.kind == "id" and i + 1 < n
              and toks[i + 1].kind == "punct" and toks[i + 1].text == "("
              and i > decl_start):
            prev = toks[i - 1]
            if not (prev.kind == "id" or
                    (prev.kind == "punct" and prev.text == "*")):
                i += 1
                continue
            spec = toks[decl_start:i]
            if any(s.kind == "id" and s.text == "typedef" for s in spec):
                i += 1
                continue
            words = [s.text for s in spec if s.kind == "id"]
            ptr = sum(1 for s in spec
                      if s.kind == "punct" and s.text == "*")
            if not words:
                i += 1
                continue
            # Split the parameter list at depth-1 commas.
            j = i + 2
            pdepth = 1
            params_toks: List[List[Tok]] = [[]]
            while j < n and pdepth > 0:
                pt = toks[j]
                if pt.kind == "punct" and pt.text == "(":
                    pdepth += 1
                elif pt.kind == "punct" and pt.text == ")":
                    pdepth -= 1
                    if pdepth == 0:
                        break
                if pt.kind == "punct" and pt.text == "," and pdepth == 1:
                    params_toks.append([])
                else:
                    params_toks[-1].append(pt)
                j += 1
            if j >= n:
                break
            after = toks[j + 1] if j + 1 < n else Tok("eof", "", t.line)
            if not (after.kind == "punct" and after.text in (";", "{")):
                i += 1
                continue
            params: List[CParam] = []
            for ptoks in params_toks:
                if not ptoks or (len(ptoks) == 1 and ptoks[0].text == "void"):
                    continue
                p = _parse_param(ptoks, typedefs)
                if p is not None:
                    params.append(p)
            body = None
            if after.text == "{":
                k, bdepth = j + 1, 0
                while k < n:
                    bt = toks[k]
                    if bt.kind == "punct" and bt.text == "{":
                        bdepth += 1
                    elif bt.kind == "punct" and bt.text == "}":
                        bdepth -= 1
                        if bdepth == 0:
                            break
                    k += 1
                body = (j + 1, k + 1)
                i = k  # the } handler above resets decl_start
                depth = 0
                decl_start = k + 1
            fn = CFunc(
                name=t.text,
                ret=type_from_tokens(
                    [w for w in words if w != t.text], ptr
                ),
                params=params,
                line=t.line,
                static="static" in words,
                body=body,
            )
            out.append(fn)
            if body is None:
                i = j + 1  # at the `;`
                decl_start = j + 2
        i += 1
    return out


# --- expression / statement AST -----------------------------------------

@dataclass(frozen=True)
class Num:
    v: int
    line: int = 0
    suffix: str = ""  # the literal's integer suffix, lower case ("u", "ull")


@dataclass(frozen=True)
class Name:
    n: str
    line: int = 0


@dataclass(frozen=True)
class Bin:
    op: str
    l: object
    r: object
    line: int = 0


@dataclass(frozen=True)
class Un:
    op: str
    e: object
    line: int = 0


@dataclass(frozen=True)
class IncDec:
    op: str  # "++" | "--"
    e: object
    post: bool
    line: int = 0


@dataclass(frozen=True)
class Call:
    fn: object
    args: tuple
    line: int = 0


@dataclass(frozen=True)
class Idx:
    base: object
    idx: object
    line: int = 0


@dataclass(frozen=True)
class Mem:
    base: object
    f: str
    line: int = 0


@dataclass(frozen=True)
class Cast:
    e: object
    line: int = 0
    ctype: Optional[CType] = None  # the target type


@dataclass(frozen=True)
class Cond:
    c: object
    a: object
    b: object
    line: int = 0


@dataclass(frozen=True)
class InitList:
    items: tuple
    line: int = 0


@dataclass(frozen=True)
class Assign:
    target: object
    op: str  # "=", "+=", ...
    value: object
    line: int = 0


@dataclass
class SBlock:
    stmts: list
    line: int = 0


@dataclass
class SIf:
    c: object
    t: object
    e: object
    line: int = 0


@dataclass
class SWhile:
    c: object
    body: object
    line: int = 0


@dataclass
class SFor:
    init: list
    c: object
    step: list
    body: object
    line: int = 0


@dataclass
class SDecl:
    decls: list  # [(CType, name, arrsize:Optional[int], init, line)]
    line: int = 0


@dataclass
class SExpr:
    e: object
    line: int = 0


@dataclass
class SRet:
    e: object
    line: int = 0


@dataclass
class SBrk:
    line: int = 0


@dataclass
class SCont:
    line: int = 0


class CParseError(Exception):
    def __init__(self, msg: str, line: int) -> None:
        super().__init__(msg)
        self.line = line


class _Parser:
    """Recursive-descent parser over one function body's token span."""

    def __init__(self, toks: List[Tok], typedefs: frozenset) -> None:
        self.toks = toks
        self.typedefs = typedefs
        self.i = 0

    def peek(self, k: int = 0) -> Tok:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else Tok("eof", "", 0)

    def next(self) -> Tok:
        t = self.peek()
        self.i += 1
        return t

    def at(self, text: str) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.text == text

    def expect(self, text: str) -> Tok:
        t = self.next()
        if not (t.kind == "punct" and t.text == text):
            raise CParseError(f"expected {text!r}, got {t.text!r}", t.line)
        return t

    def _is_type_ahead(self) -> bool:
        t = self.peek()
        return t.kind == "id" and (
            t.text in TYPE_START or t.text in self.typedefs
        )

    # --- statements ---

    def parse_block(self) -> SBlock:
        t = self.expect("{")
        stmts = []
        while not self.at("}"):
            if self.peek().kind == "eof":
                raise CParseError("unterminated block", t.line)
            stmts.append(self.parse_stmt())
        self.expect("}")
        return SBlock(stmts, t.line)

    def parse_stmt(self):
        t = self.peek()
        if self.at("{"):
            return self.parse_block()
        if t.kind == "id" and t.text == "if":
            self.next()
            self.expect("(")
            c = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            els = None
            if self.peek().kind == "id" and self.peek().text == "else":
                self.next()
                els = self.parse_stmt()
            return SIf(c, then, els, t.line)
        if t.kind == "id" and t.text == "while":
            self.next()
            self.expect("(")
            c = self.parse_expr()
            self.expect(")")
            return SWhile(c, self.parse_stmt(), t.line)
        if t.kind == "id" and t.text == "for":
            self.next()
            self.expect("(")
            init: list = []
            if not self.at(";"):
                if self._is_type_ahead():
                    init = [self.parse_decl(consume_semi=False)]
                else:
                    init = [SExpr(e, t.line)
                            for e in self._expr_list()]
            self.expect(";")
            cond = None if self.at(";") else self.parse_expr()
            self.expect(";")
            step: list = []
            if not self.at(")"):
                step = [SExpr(e, t.line) for e in self._expr_list()]
            self.expect(")")
            return SFor(init, cond, step, self.parse_stmt(), t.line)
        if t.kind == "id" and t.text == "return":
            self.next()
            e = None if self.at(";") else self.parse_expr()
            self.expect(";")
            return SRet(e, t.line)
        if t.kind == "id" and t.text == "break":
            self.next()
            self.expect(";")
            return SBrk(t.line)
        if t.kind == "id" and t.text == "continue":
            self.next()
            self.expect(";")
            return SCont(t.line)
        if self._is_type_ahead():
            return self.parse_decl(consume_semi=True)
        e = self.parse_expr()
        self.expect(";")
        return SExpr(e, t.line)

    def _expr_list(self) -> list:
        out = [self.parse_expr()]
        while self.at(","):
            self.next()
            out.append(self.parse_expr())
        return out

    def parse_decl(self, consume_semi: bool) -> SDecl:
        t = self.peek()
        words = []
        while self._is_type_ahead():
            words.append(self.next().text)
        decls = []
        while True:
            ptr = 0
            while self.at("*") or self.at("&") or (
                    self.peek().kind == "id"
                    and self.peek().text in ("const", "__restrict__")):
                if self.at("*"):
                    ptr += 1
                self.next()
            nt = self.next()
            if nt.kind != "id":
                raise CParseError(
                    f"expected declarator, got {nt.text!r}", nt.line)
            arrsize = None
            if self.at("["):
                self.next()
                st = self.next()
                if st.kind == "num":
                    arrsize = int(st.text.rstrip("uUlL"), 0)
                elif st.kind == "id":
                    arrsize = None  # symbolic size: treated as unbounded
                self.expect("]")
            init = None
            if self.at("="):
                self.next()
                init = (self._init_list() if self.at("{")
                        else self.parse_expr())
            decls.append(
                (type_from_tokens(words, ptr), nt.text, arrsize, init,
                 nt.line)
            )
            if self.at(","):
                self.next()
                continue
            break
        if consume_semi:
            self.expect(";")
        return SDecl(decls, t.line)

    def _init_list(self) -> InitList:
        t = self.expect("{")
        items = []
        while not self.at("}"):
            items.append(self._init_list() if self.at("{")
                         else self.parse_expr())
            if self.at(","):
                self.next()
        self.expect("}")
        return InitList(tuple(items), t.line)

    # --- expressions (C precedence, assignment lowest) ---

    def parse_expr(self):
        e = self.parse_ternary()
        t = self.peek()
        if t.kind == "punct" and t.text in (
            "=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
            "<<=", ">>=",
        ):
            self.next()
            return Assign(e, t.text, self.parse_expr(), t.line)
        return e

    def parse_ternary(self):
        c = self._binary(0)
        if self.at("?"):
            t = self.next()
            a = self.parse_expr()
            self.expect(":")
            return Cond(c, a, self.parse_ternary(), t.line)
        return c

    _LEVELS = (
        ("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
        ("<", ">", "<=", ">="), ("<<", ">>"), ("+", "-"), ("*", "/", "%"),
    )

    def _binary(self, level: int):
        if level >= len(self._LEVELS):
            return self.parse_unary()
        e = self._binary(level + 1)
        ops = self._LEVELS[level]
        while True:
            t = self.peek()
            if t.kind == "punct" and t.text in ops:
                self.next()
                e = Bin(t.text, e, self._binary(level + 1), t.line)
            else:
                return e

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.text in ("!", "~", "-", "+", "*", "&"):
            self.next()
            return Un(t.text, self.parse_unary(), t.line)
        if t.kind == "punct" and t.text in ("++", "--"):
            self.next()
            return IncDec(t.text, self.parse_unary(), post=False,
                          line=t.line)
        if self.at("(") and self._cast_ahead():
            self.next()
            depth = 1
            words, ptr = [], 0
            while depth:
                nt = self.next()
                if nt.kind == "punct" and nt.text == "(":
                    depth += 1
                elif nt.kind == "punct" and nt.text == ")":
                    depth -= 1
                elif nt.kind == "punct" and nt.text == "*":
                    ptr += 1
                elif nt.kind == "id":
                    words.append(nt.text)
                elif nt.kind == "eof":
                    raise CParseError("unterminated cast", t.line)
            return Cast(self.parse_unary(), t.line,
                        type_from_tokens(words, ptr))
        return self.parse_postfix()

    def _cast_ahead(self) -> bool:
        """`(` already peeked: type tokens then `)` then non-operator."""
        j = self.i + 1
        saw_type = False
        while j < len(self.toks):
            t = self.toks[j]
            if t.kind == "id" and (t.text in TYPE_START
                                   or t.text in self.typedefs):
                saw_type = True
                j += 1
            elif t.kind == "punct" and t.text == "*":
                j += 1
            else:
                break
        if not saw_type or j >= len(self.toks):
            return False
        t = self.toks[j]
        return t.kind == "punct" and t.text == ")"

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if self.at("["):
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = Idx(e, idx, t.line)
            elif self.at("("):
                self.next()
                args = []
                while not self.at(")"):
                    args.append(self.parse_expr())
                    if self.at(","):
                        self.next()
                self.expect(")")
                e = Call(e, tuple(args), t.line)
            elif self.at(".") or self.at("->"):
                self.next()
                f = self.next()
                e = Mem(e, f.text, t.line)
            elif t.kind == "punct" and t.text in ("++", "--"):
                self.next()
                e = IncDec(t.text, e, post=True, line=t.line)
            else:
                return e

    _CXX_CASTS = frozenset(("reinterpret_cast", "static_cast", "const_cast"))

    def parse_primary(self):
        t = self.next()
        if t.kind == "num":
            body = t.text.rstrip("uUlL")
            if body.startswith("'"):
                return Num(0, t.line)  # char literal: value irrelevant
            try:
                return Num(int(body, 0), t.line,
                           t.text[len(body):].lower())
            except ValueError:
                return Num(0, t.line)  # float literal
        if t.kind == "id" and t.text in self._CXX_CASTS and self.at("<"):
            self.next()
            words, ptr = [], 0
            while not self.at(">"):
                nt = self.next()
                if nt.kind == "punct" and nt.text == "*":
                    ptr += 1
                elif nt.kind == "id":
                    words.append(nt.text)
                elif nt.kind == "eof":
                    raise CParseError("unterminated cast", t.line)
            self.next()
            self.expect("(")
            e = self.parse_expr()
            self.expect(")")
            return Cast(e, t.line, type_from_tokens(words, ptr))
        if t.kind == "id":
            return Name(t.text, t.line)
        if t.kind == "str":
            return Name("<str>", t.line)
        if t.kind == "punct" and t.text == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        raise CParseError(f"unexpected token {t.text!r}", t.line)


def parse_body(toks: List[Tok], span: Tuple[int, int],
               typedefs: frozenset) -> SBlock:
    """Parse a function definition's `{...}` token span into statements."""
    p = _Parser(toks[span[0]:span[1]], typedefs)
    return p.parse_block()
