"""CLI display helpers: bar charts, tables (cf. kjarni-cli/src/commands/display.rs).

A copy of kjarni_tpu/cli/display.py.
"""

from __future__ import annotations

import sys

BAR_WIDTH = 20


def bar(score: float, width: int = BAR_WIDTH) -> str:
    filled = int(round(max(0.0, min(1.0, score)) * width))
    return "█" * filled + "░" * (width - filled)


def print_scores(scores: list[tuple[str, float]], marker_first: bool = True,
                 file=None) -> None:
    """README-style classification output:
      ✓       POSITIVE  ████████████████████  100.0%
    """
    file = file or sys.stdout
    width = max((len(l) for l, _ in scores), default=8)
    for i, (label, score) in enumerate(scores):
        mark = "✓" if (i == 0 and marker_first) else " "
        print(f"  {mark} {label:>{width + 6}}  {bar(score)}  {score * 100:5.1f}%",
              file=file)


def print_similarity(a: str, b: str, score: float, file=None) -> None:
    file = file or sys.stdout
    qual = ("highly similar" if score >= 0.8 else
            "similar" if score >= 0.6 else
            "somewhat similar" if score >= 0.4 else
            "not very similar")
    print(f"  {bar(score)}  {score * 100:5.1f}%  {qual}", file=file)
    print(f"  ↔ \"{a}\"", file=file)
    print(f"  ↔ \"{b}\"", file=file)


def print_search_results(results, file=None) -> None:
    file = file or sys.stdout
    if not results:
        print("  (no results)", file=file)
        return
    top = max(r.score for r in results)
    low = min(r.score for r in results)
    span = max(top - low, 1e-9)
    for i, r in enumerate(results, 1):
        rel = (r.score - low) / span if len(results) > 1 else 1.0
        src = r.metadata.get("source", f"doc {r.document_id}")
        import os
        src = os.path.basename(src)
        snippet = r.text.replace("\n", " ")
        if len(snippet) > 72:
            snippet = snippet[:71] + "…"
        print(f"  {i}. {src}", file=file)
        print(f"     {bar(rel)}  {rel * 100:5.1f}%", file=file)
        print(f"     \"{snippet}\"", file=file)
        print(file=file)


def format_table(rows: list[list[str]], headers: list[str]) -> str:
    cols = len(headers)
    widths = [len(h) for h in headers]
    for row in rows:
        for i in range(cols):
            widths[i] = max(widths[i], len(str(row[i])))
    lines = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(headers))]
    lines.append("  ".join("-" * widths[i] for i in range(cols)))
    for row in rows:
        lines.append("  ".join(str(row[i]).ljust(widths[i]) for i in range(cols)))
    return "\n".join(lines)
