"""Tokenizer for the jsvm JavaScript subset.

Produces a flat token list; regex-vs-division ambiguity is resolved with the
standard previous-significant-token heuristic (a `/` after a value token is
division, anywhere else it opens a regex literal). Template literals without
substitutions are lexed as plain strings; `${` inside one is rejected —
web/kjarni.js does not use interpolation and silently mis-lexing it would be
worse than failing loudly.

A verbatim copy of kjarni_tpu/export/jsvm/lexer.py (the port imports nothing
of the JAX package); only this paragraph differs.
"""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "for", "while",
    "do", "break", "continue", "new", "class", "extends", "super", "this",
    "typeof", "instanceof", "in", "of", "true", "false", "null", "undefined",
    "throw", "try", "catch", "finally", "delete", "void", "switch", "case",
    "default", "async", "await", "yield", "static", "get", "set",
}

# Longest first so the scanner can greedily match.
PUNCT = [
    ">>>=", "...", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=",
    "??=", "=>", "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++", "--",
    "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "**", "<<", ">>",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/",
    "%", "&", "|", "^", "!", "~", "?", ":", "=", ".",
]


class JSSyntaxError(SyntaxError):
    pass


@dataclass
class Token:
    kind: str      # "num" | "str" | "regex" | "ident" | "kw" | "punct" | "eof"
    value: object  # parsed value for num/str; (pattern, flags) for regex
    line: int
    nl_before: bool  # a newline separates this token from the previous one


_ID_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_$")
_ID_CONT = _ID_START | set("0123456789")

# After these, a `/` begins a regex literal (expression position).
_REGEX_AFTER_PUNCT = {
    "=", "(", ",", "[", "{", "}", ";", ":", "!", "&", "|", "?", "+", "-",
    "*", "/", "%", "<", ">", "==", "===", "!=", "!==", "<=", ">=", "&&",
    "||", "??", "=>", "+=", "-=", "*=", "/=", "return", "typeof", "new",
    "in", "of", "case", "throw", "await", "void", "delete", "do", "else",
}

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f",
            "v": "\v", "0": "\0", "\\": "\\", "'": "'", '"': '"', "`": "`",
            "\n": ""}


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i, n = 0, len(src)
    line = 1
    nl = False

    def prev_allows_regex() -> bool:
        if not toks:
            return True
        t = toks[-1]
        if t.kind in ("num", "str", "regex"):
            return False
        if t.kind == "ident":
            return False
        if t.kind == "kw":
            return t.value in _REGEX_AFTER_PUNCT or t.value not in (
                "this", "true", "false", "null", "undefined", "super")
        return t.value in _REGEX_AFTER_PUNCT

    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            nl = True
            i += 1
            continue
        if c in " \t\r\f\v":
            i += 1
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            if j < 0:
                raise JSSyntaxError(f"unterminated block comment at line {line}")
            line += src.count("\n", i, j)
            i = j + 2
            continue

        # string literal (template literals without ${} lex as strings)
        if c in "'\"`":
            quote = c
            j = i + 1
            buf = []
            while j < n and src[j] != quote:
                ch = src[j]
                if ch == "\\":
                    if j + 1 >= n:
                        raise JSSyntaxError(f"bad escape at line {line}")
                    e = src[j + 1]
                    if e == "u":
                        if src[j + 2] == "{":
                            k = src.find("}", j + 3)
                            buf.append(chr(int(src[j + 3:k], 16)))
                            j = k + 1
                        else:
                            buf.append(chr(int(src[j + 2:j + 6], 16)))
                            j += 6
                        continue
                    if e == "x":
                        buf.append(chr(int(src[j + 2:j + 4], 16)))
                        j += 4
                        continue
                    buf.append(_ESCAPES.get(e, e))
                    j += 2
                    continue
                if quote == "`" and ch == "$" and j + 1 < n and src[j + 1] == "{":
                    raise JSSyntaxError(
                        f"template interpolation unsupported at line {line}")
                if ch == "\n":
                    if quote != "`":
                        raise JSSyntaxError(f"unterminated string at line {line}")
                    line += 1
                buf.append(ch)
                j += 1
            if j >= n:
                raise JSSyntaxError(f"unterminated string at line {line}")
            toks.append(Token("str", "".join(buf), line, nl))
            nl = False
            i = j + 1
            continue

        # regex literal
        if c == "/" and prev_allows_regex():
            j = i + 1
            in_class = False
            while j < n:
                ch = src[j]
                if ch == "\\":
                    j += 2
                    continue
                if ch == "\n":
                    raise JSSyntaxError(f"unterminated regex at line {line}")
                if ch == "[":
                    in_class = True
                elif ch == "]":
                    in_class = False
                elif ch == "/" and not in_class:
                    break
                j += 1
            if j >= n:
                raise JSSyntaxError(f"unterminated regex at line {line}")
            pattern = src[i + 1:j]
            k = j + 1
            while k < n and src[k] in _ID_CONT:
                k += 1
            flags = src[j + 1:k]
            toks.append(Token("regex", (pattern, flags), line, nl))
            nl = False
            i = k
            continue

        # number
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if c == "0" and i + 1 < n and src[i + 1] in "xX":
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF_":
                    j += 1
                val = int(src[i + 2:j].replace("_", ""), 16)
            elif c == "0" and i + 1 < n and src[i + 1] in "bB":
                j = i + 2
                while j < n and src[j] in "01_":
                    j += 1
                val = int(src[i + 2:j].replace("_", ""), 2)
            elif c == "0" and i + 1 < n and src[i + 1] in "oO":
                j = i + 2
                while j < n and src[j] in "01234567_":
                    j += 1
                val = int(src[i + 2:j].replace("_", ""), 8)
            else:
                seen_dot = seen_exp = False
                while j < n:
                    ch = src[j]
                    if ch.isdigit() or ch == "_":
                        j += 1
                    elif ch == "." and not seen_dot and not seen_exp:
                        seen_dot = True
                        j += 1
                    elif ch in "eE" and not seen_exp:
                        seen_exp = True
                        j += 1
                        if j < n and src[j] in "+-":
                            j += 1
                    else:
                        break
                text = src[i:j].replace("_", "")
                val = float(text) if (seen_dot or seen_exp) else int(text)
            toks.append(Token("num", val, line, nl))
            nl = False
            i = j
            continue

        # identifier / keyword
        if c in _ID_START:
            j = i + 1
            while j < n and src[j] in _ID_CONT:
                j += 1
            word = src[i:j]
            kind = "kw" if word in KEYWORDS else "ident"
            toks.append(Token(kind, word, line, nl))
            nl = False
            i = j
            continue

        # punctuation
        for p in PUNCT:
            if src.startswith(p, i):
                toks.append(Token("punct", p, line, nl))
                nl = False
                i += len(p)
                break
        else:
            raise JSSyntaxError(f"unexpected character {c!r} at line {line}")

    toks.append(Token("eof", None, line, nl))
    return toks
