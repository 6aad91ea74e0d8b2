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

The CUDA sources under the package are read as the same subset plus
what they use of C++: `namespace` blocks (transparent) and `ns::name`
identifiers, `__device__` / `__global__` / `__forceinline__` /
`constexpr` / `__restrict__` / `__shared__` / `__grid_constant__`
qualifiers, `template <...>` headers (`CFunc.tparams`) and
`__launch_bounds__` (`CFunc.launch_bounds`), reference parameters
(`CParam.ref`, `CParam.const`), `bool`, `auto`, `unsigned __int128`,
`reinterpret_cast<T>(e)` / `static_cast<T>(e)`, template calls
(`TplName`), `[&]` lambdas (`Lambda`), aggregate initialisers
(`Compound`, brace-initialised declarations), multi-dimensional local
arrays (`SDecl.dims`), `do ... while` (`SDo`), inline `asm` statements
(`SAsm`, their outputs), and the `typedef_types` / `parse_constexprs` /
`parse_constexpr_types` / `collect_structs` / `struct_fields` tables.
Casts keep their target type and literals their suffix, which the
width-aware absint needs.

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
    "!=", "&&", "||", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "::",
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
                # A comment-only annotation binds to the line after its
                # end: a block comment may span several lines.
                at = line + tok.count("\n") if own else line
                anns[at] = LineAnnotations(
                    at, clauses, reason, own_line=own
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
    "__shared__", "__constant__", "__managed__", "__grid_constant__",
    "typename",
))
_BASE_WORDS = frozenset((
    "void", "char", "short", "int", "long", "unsigned", "signed",
    "float", "double", "_Bool", "bool", "__int128", "auto",
))
TYPE_START = _QUALIFIERS | _BASE_WORDS | frozenset(_FIXED)


def type_from_tokens(words: List[str], ptr: int) -> CType:
    """CType from the identifier words of a declaration specifier."""
    ws = [w.split("::")[-1] for w in words if w not in _QUALIFIERS]
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
    return {k: v for k, (v, _t) in parse_constexpr_types(source).items()}


def parse_constexpr_types(source: str) -> Dict[str, Tuple[int, CType]]:
    """`parse_constexprs` with each constant's declared type."""
    out: Dict[str, Tuple[int, CType]] = {}
    for m in _CONSTEXPR_RE.finditer(_strip_comments(source)):
        ct = type_from_tokens(m.group(1).split(), 0)
        v = _fold_const(m.group(3), {k: x for k, (x, _t) in out.items()})
        if v is None or ct.base != "int":
            continue
        if not ct.signed:
            v &= (1 << ct.width) - 1
        out[m.group(2)] = (v, ct)
    return out


def _strip_comments(source: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", " ", source, flags=re.DOTALL)


def collect_structs(source: str) -> Dict[str, List[Tuple[str, CType]]]:
    """`struct Name { <fields> };` -> [(field, type)] for the data
    members (member functions and their bodies are skipped)."""
    return {k: [(f, t) for f, t, _d in v] for k, v in struct_fields(source).items()}


def struct_fields(source: str) -> Dict[str, List[Tuple[str, CType, tuple]]]:
    """`[template <...>] struct Name { <fields> };` -> [(field, type,
    dims)] in declaration order, for the data members: `u128 a[K], b[K];`
    declares two array fields (dims hold each bound's text), a template
    argument of a field's type (`Lanes<K> v;`) is dropped, and member
    functions are skipped."""
    text = _strip_comments(source)
    out: Dict[str, List[Tuple[str, CType, tuple]]] = {}
    for m in re.finditer(r"\bstruct\s+(\w+)\s*\{", text):
        k, depth = m.end(), 1
        while k < len(text) and depth:
            depth += {"{": 1, "}": -1}.get(text[k], 0)
            k += 1
        body = text[m.end():k - 1]
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
            decl = re.sub(r"<[^<>]*>", " ", decl).replace("*", " * ")
            head = re.match(r"\s*((?:[\w:]+\s+)+?)((?:\*\s*)*\w+\s*(?:\[[^\]]*\]\s*)*)"
                            r"((?:,\s*(?:\*\s*)*\w+\s*(?:\[[^\]]*\]\s*)*)*)\s*$", decl)
            if head is None:
                continue
            words = head.group(1).split()
            for d in [head.group(2)] + [x for x in head.group(3).split(",") if x.strip()]:
                name = re.search(r"\w+", d).group(0)
                dims = tuple(x.strip() for x in re.findall(r"\[([^\]]*)\]", d))
                fields.append((name, type_from_tokens(words, d.count("*")), dims))
        out[m.group(1)] = fields
    return out


# --- function declarations ----------------------------------------------

@dataclass(frozen=True)
class CParam:
    name: str
    ctype: CType
    ref: bool = False  # a C++ reference parameter (`T& name`)
    const: bool = False  # declared `const` (a const reference is read-only)


@dataclass
class CFunc:
    name: str
    ret: CType
    params: List[CParam]
    line: int
    static: bool
    body: Optional[Tuple[int, int]] = None  # token span of `{...}` or None
    # `template <int K, class T>`: (("int", "K"), ("type", "T")).
    tparams: tuple = ()
    # `__launch_bounds__(max_threads, ...)`: the first argument's text.
    launch_bounds: Optional[str] = None
    # The line the declaration starts on (its `template` header, or its
    # first specifier), where a contract above it binds.
    head_line: Optional[int] = None


def _skip_angles(toks: List[Tok], i: int) -> int:
    """Index just past the `>` matching the `<` at toks[i]."""
    depth = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "punct" and t.text == "<":
            depth += 1
        elif t.kind == "punct" and t.text == ">":
            depth -= 1
            if depth == 0:
                return i + 1
        elif t.kind == "punct" and t.text == ">>":
            depth -= 2
            if depth <= 0:
                return i + 1
        i += 1
    return i


def _parse_param(toks: List[Tok], typedefs: frozenset) -> Optional[CParam]:
    words, ptr, name, ref = [], 0, "", False
    const = any(t.kind == "id" and t.text == "const" for t in toks)
    # A template argument list of a parameter's type (`Lanes<K>& v`) says
    # nothing the front end reads.
    kept, j = [], 0
    while j < len(toks):
        if toks[j].kind == "punct" and toks[j].text == "<" and kept:
            j = _skip_angles(toks, j)
            continue
        kept.append(toks[j])
        j += 1
    toks = kept
    bracket = 0
    for t in toks:
        if t.kind == "punct" and t.text == "=":
            break  # a C++ default argument: the declarator is complete
        if bracket and not (t.kind == "punct" and t.text == "]"):
            continue  # an array bound (`unsigned (&hs)[Steps]`)
        if t.kind == "punct" and t.text == "*":
            ptr += 1
        elif t.kind == "punct" and t.text == "&":
            ref = True
        elif t.kind == "punct" and t.text in ("[", "]"):
            if t.text == "[":
                ptr += 1  # `T a[]` parameter decays to pointer
                bracket += 1
            else:
                bracket -= 1
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
        return CParam("", type_from_tokens(words, ptr), ref, const)
    twords = [w for w in words if w != name] or words
    return CParam(name, type_from_tokens(twords, ptr), ref, const)


def parse_functions(source: str) -> List[CFunc]:
    """Top-level function declarations and definitions."""
    toks, _ = lex(source)
    typedefs = collect_typedefs(source) | frozenset(collect_structs(source))
    out: List[CFunc] = []
    i, depth = 0, 0
    decl_start = 0
    n = len(toks)
    tparams: tuple = ()  # the pending `template <...>` header
    tmpl_line = 0
    bounds, bounds_span = None, (-1, -1)  # the pending __launch_bounds__
    while i < n:
        t = toks[i]
        if (depth == 0 and t.kind == "id" and t.text == "template"
                and i + 1 < n and toks[i + 1].text == "<"):
            end = _skip_angles(toks, i + 1)
            params = []
            for part in _split_commas(toks[i + 2:end - 1]):
                words = [x.text for x in part if x.kind == "id"]
                if len(words) >= 2:
                    kind = "type" if words[0] in ("class", "typename") else "int"
                    params.append((kind, words[-1]))
            tparams = tuple(params)
            tmpl_line = t.line
            i = end
            decl_start = end
            continue
        if (depth == 0 and t.kind == "id" and t.text == "__launch_bounds__"
                and i + 1 < n and toks[i + 1].text == "("):
            k, pd = i + 1, 0
            while k < n:
                if toks[k].text == "(":
                    pd += 1
                elif toks[k].text == ")":
                    pd -= 1
                    if pd == 0:
                        break
                k += 1
            bounds = toks[i + 2].text if i + 2 < k else None
            bounds_span = (i, k)
            i = k + 1
            continue
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
            tparams, bounds = (), None
        elif (depth == 0 and t.kind == "id" and i + 1 < n
              and toks[i + 1].kind == "punct" and toks[i + 1].text == "("
              and i > decl_start):
            prev = toks[i - 1]
            if not (prev.kind == "id" or i - 1 == bounds_span[1] or
                    (prev.kind == "punct" and prev.text in ("*", "&"))):
                i += 1
                continue
            spec = [x for k, x in enumerate(toks[decl_start:i], decl_start)
                    if not bounds_span[0] <= k <= bounds_span[1]]
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
                tparams=tparams,
                launch_bounds=bounds,
                head_line=tmpl_line if tparams else (
                    spec[0].line if spec else t.line),
            )
            tparams, bounds = (), None
            out.append(fn)
            if body is None:
                i = j + 1  # at the `;`
                decl_start = j + 2
        i += 1
    return out


def _split_commas(toks: List[Tok]) -> List[List[Tok]]:
    out: List[List[Tok]] = [[]]
    depth = 0
    for t in toks:
        if t.kind == "punct" and t.text in ("(", "<", "[", "{"):
            depth += 1
        elif t.kind == "punct" and t.text in (")", ">", "]", "}"):
            depth -= 1
        if t.kind == "punct" and t.text == "," and depth == 0:
            out.append([])
        else:
            out[-1].append(t)
    return [p for p in out if p]


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
class TplName:
    """A template function named with its arguments (`warp_seg_scan<5>`):
    each argument a Num, a Name or a CType."""

    n: str
    args: tuple
    line: int = 0


@dataclass(frozen=True)
class Compound:
    """An aggregate initialisation of a named type (`Pair{0, 0, {}}`)."""

    tname: str
    init: object  # InitList
    line: int = 0


@dataclass(frozen=True)
class Lambda:
    """`[&](params) { body }`: params are CParams; the body an SBlock."""

    params: tuple
    body: object
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
    # Per declarator, its array bounds (ints, or None where symbolic);
    # () for a scalar.
    dims: Optional[list] = None


@dataclass
class SDo:
    body: object
    c: object
    line: int = 0


@dataclass
class SAsm:
    """An inline `asm [volatile] (...)`: its outputs, (constraint, lvalue)."""

    outputs: list
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

    def __init__(self, toks: List[Tok], typedefs: frozenset,
                 templates: frozenset = frozenset()) -> None:
        # `ns::name` reads as one identifier.
        merged: List[Tok] = []
        for t in toks:
            if (t.kind == "id" and len(merged) >= 2 and merged[-1].text == "::"
                    and merged[-2].kind == "id"):
                merged.pop()
                head = merged.pop()
                merged.append(Tok("id", f"{head.text}::{t.text}", head.line))
            else:
                merged.append(t)
        self.toks = merged
        self.typedefs = typedefs
        self.templates = templates
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
        if t.kind != "id":
            return False
        last = t.text.split("::")[-1]
        if t.text in TYPE_START or last in self.typedefs:
            return True
        # A qualified type the tables do not know (`cg::grid_group g`).
        nxt = self.peek(1)
        return "::" in t.text and nxt.kind == "id"

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
        if t.kind == "id" and t.text == "do":
            self.next()
            body = self.parse_stmt()
            w = self.next()
            if w.text != "while":
                raise CParseError(f"expected 'while', got {w.text!r}", w.line)
            self.expect("(")
            c = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return SDo(body, c, t.line)
        if t.kind == "id" and t.text in ("asm", "__asm__"):
            return self._parse_asm()
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

    def _parse_asm(self) -> SAsm:
        t = self.next()
        if self.peek().kind == "id" and self.peek().text in ("volatile", "__volatile__"):
            self.next()
        self.expect("(")
        while self.peek().kind == "str":
            self.next()
        outputs = []
        if self.at(":"):
            self.next()
            while self.peek().kind == "str":
                constraint = self.next().text.strip('"')
                self.expect("(")
                outputs.append((constraint, self.parse_expr()))
                self.expect(")")
                if self.at(","):
                    self.next()
        depth = 0  # inputs and clobbers: read nothing the domain tracks
        while not (depth == 0 and self.at(")")):
            nt = self.next()
            if nt.kind == "eof":
                raise CParseError("unterminated asm", t.line)
            depth += {"(": 1, ")": -1}.get(nt.text, 0) if nt.kind == "punct" else 0
        self.expect(")")
        self.expect(";")
        return SAsm(outputs, t.line)

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
            if self.at("<"):  # a template type's arguments (`Lanes<K> v`)
                self.i = _skip_angles(self.toks, self.i)
        decls, dims = [], []
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
            bounds = []
            while self.at("["):
                self.next()
                st = self.next()
                if st.kind == "num":
                    bounds.append(int(st.text.rstrip("uUlL"), 0))
                else:
                    bounds.append(None)  # symbolic size: treated as unbounded
                self.expect("]")
            if bounds:
                arrsize = bounds[0]
            init = None
            if self.at("="):
                self.next()
                init = (self._init_list() if self.at("{")
                        else self.parse_expr())
            elif self.at("{"):  # `Tables t{...}`
                init = self._init_list()
            decls.append(
                (type_from_tokens(words, ptr), nt.text, arrsize, init,
                 nt.line)
            )
            dims.append(tuple(bounds))
            if self.at(","):
                self.next()
                continue
            break
        if consume_semi:
            self.expect(";")
        return SDecl(decls, t.line, dims)

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

    def _template_args(self) -> Optional[tuple]:
        """`<...>` of a template call, at `<`: each argument a Num, a Name
        or a CType; None where the tokens are no argument list."""
        self.expect("<")
        args, cur = [], []
        while True:
            nt = self.next()
            if nt.kind == "eof" or (nt.kind == "punct" and nt.text not in (",", ">", "*")):
                return None
            if nt.kind == "punct" and nt.text in (",", ">"):
                if len(cur) == 1 and cur[0].kind == "num":
                    args.append(Num(int(cur[0].text.rstrip("uUlL"), 0), cur[0].line))
                elif len(cur) == 1 and cur[0].kind == "id" and not (
                        cur[0].text in TYPE_START or cur[0].text in self.typedefs):
                    args.append(Name(cur[0].text, cur[0].line))
                elif cur:
                    args.append(type_from_tokens(
                        [x.text for x in cur if x.kind == "id"],
                        sum(1 for x in cur if x.text == "*")))
                cur = []
                if nt.text == ">":
                    return tuple(args)
                continue
            cur.append(nt)

    def _lambda(self, t: Tok) -> Lambda:
        """`[captures](params) { body }`, after the `[`: every capture is
        by reference (`[&]`), which is how the body is read."""
        while not self.at("]"):
            if self.next().kind == "eof":
                raise CParseError("unterminated lambda capture", t.line)
        self.next()
        params = []
        if self.at("("):
            self.next()
            depth, part, parts = 0, [], []
            while not (depth == 0 and self.at(")")):
                nt = self.next()
                if nt.kind == "eof":
                    raise CParseError("unterminated lambda parameters", t.line)
                if nt.kind == "punct" and nt.text == "," and depth == 0:
                    parts.append(part)
                    part = []
                    continue
                depth += {"(": 1, ")": -1}.get(nt.text, 0) if nt.kind == "punct" else 0
                part.append(nt)
            self.next()
            if part:
                parts.append(part)
            for ptoks in parts:
                prm = _parse_param(ptoks, self.typedefs)
                if prm is not None:
                    params.append(prm)
        return Lambda(tuple(params), self.parse_block(), t.line)

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
        if t.kind == "id" and t.text.split("::")[-1] in self.templates \
                and self.at("<"):
            save = self.i
            targs = self._template_args()
            if targs is not None and self.at("("):
                return TplName(t.text.split("::")[-1], targs, t.line)
            self.i = save
        if t.kind == "id" and self.at("{") and (
                t.text.split("::")[-1] in self.typedefs):
            return Compound(t.text.split("::")[-1], self._init_list(), t.line)
        if t.kind == "id":
            return Name(t.text, t.line)
        if t.kind == "punct" and t.text == "[":
            return self._lambda(t)
        if t.kind == "str":
            return Name("<str>", t.line)
        if t.kind == "punct" and t.text == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        raise CParseError(f"unexpected token {t.text!r}", t.line)


def parse_body(toks: List[Tok], span: Tuple[int, int],
               typedefs: frozenset, templates: frozenset = frozenset()) -> SBlock:
    """Parse a function definition's `{...}` token span into statements.
    `templates` names the template functions a call may instantiate
    (`f<5>(x)`)."""
    p = _Parser(toks[span[0]:span[1]], typedefs, templates)
    return p.parse_block()
