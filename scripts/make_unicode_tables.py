"""Writes ``multimodal_tpu_torch/transforms/_unicode_tables.py``: the code
points where the third-party ``regex`` module's ``\\p{L}`` and ``\\p{N}``
disagree with Python's ``unicodedata`` (letters: ``str.isalpha()``;
numbers: a category ``N*``), as sorted ``(first, last)`` ranges, both ways.

    python scripts/make_unicode_tables.py

Needs ``regex``; the port reads the written table and never ``regex``.
"""

from __future__ import annotations

import sys
import unicodedata
from pathlib import Path

import regex

OUT = Path(__file__).resolve().parents[1] / "multimodal_tpu_torch" / "transforms" / \
    "_unicode_tables.py"


# Unicode's count of assigned characters (less private use and surrogates;
# the 65 controls are counted here too) by version: how ``regex``, which
# names no version, is placed
CHARACTERS = {149186 + 65: "15.0.0", 149813 + 65: "15.1.0", 154998 + 65: "16.0.0",
              159801 + 65: "17.0.0"}


def _unicode_version(assigned: int) -> str:
    return CHARACTERS.get(assigned, f"unknown ({assigned} code points assigned)")


def _ranges(points):
    out = []
    for cp in points:
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return [tuple(r) for r in out]


def main() -> None:
    letter, number = regex.compile(r"\p{L}"), regex.compile(r"\p{N}")
    unassigned = regex.compile(r"[\p{Cn}\p{Co}]")
    n_regex = n_unicodedata = 0
    tables = {k: [] for k in ("LETTERS_ADDED", "LETTERS_REMOVED", "NUMBERS_ADDED",
                              "NUMBERS_REMOVED")}
    for cp in range(0x110000):
        if 0xD800 <= cp <= 0xDFFF:  # surrogates: no character
            continue
        c = chr(cp)
        n_regex += not unassigned.fullmatch(c)
        n_unicodedata += unicodedata.category(c) not in ("Cn", "Co")
        rl, pl = bool(letter.fullmatch(c)), c.isalpha()
        rn, pn = bool(number.fullmatch(c)), unicodedata.category(c)[0] == "N"
        if rl != pl:
            tables["LETTERS_ADDED" if rl else "LETTERS_REMOVED"].append(cp)
        if rn != pn:
            tables["NUMBERS_ADDED" if rn else "NUMBERS_REMOVED"].append(cp)
    lines = [
        '"""Where the third-party ``regex`` module\'s ``\\\\p{L}`` and ``\\\\p{N}`` differ',
        "from Python's ``unicodedata`` (letters: ``str.isalpha()``; numbers: a",
        "category ``N*``): sorted, inclusive ``(first, last)`` code point ranges.",
        "``*_ADDED``: ``regex`` says yes, ``unicodedata`` no; ``*_REMOVED``: the",
        "reverse. Written by ``scripts/make_unicode_tables.py``; do not edit.",
        "",
        f"regex {regex.__version__}, Unicode {_unicode_version(n_regex)} (by its count of",
        f"assigned characters); unicodedata, Unicode {unicodedata.unidata_version} (Python "
        f"{'.'.join(map(str, sys.version_info[:3]))}; {_unicode_version(n_unicodedata)} by",
        "the same count).",
        '"""',
        "",
        f"REGEX_VERSION = {regex.__version__!r}",
        f"UNICODEDATA_VERSION = {unicodedata.unidata_version!r}",
    ]
    for name, points in tables.items():
        ranges = _ranges(points)
        lines.append("")
        lines.append(f"# {len(points)} code points")
        lines.append(f"{name} = (")
        lines += [f"    (0x{a:05X}, 0x{b:05X})," for a, b in ranges]
        lines.append(")")
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT}: " + ", ".join(f"{k} {len(v)}" for k, v in tables.items()))


if __name__ == "__main__":
    main()
