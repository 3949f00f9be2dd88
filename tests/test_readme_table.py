"""README benchmark table must equal the rendering of the committed
bench_results.json (one source of truth — the table
drifted from the JSON twice, so drift is now a test failure)."""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_readme_table_matches_bench_results():
    sys.path.insert(0, REPO)
    try:
        from bench_e2e import README_BEGIN, README_END, render_block
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "bench_results.json")) as fh:
        acc = json.load(fh)
    with open(os.path.join(REPO, "README.md")) as fh:
        text = fh.read()
    b = text.find(README_BEGIN)
    e = text.find(README_END)
    assert b >= 0 and e >= 0, "README.md lacks the generated-table markers"
    committed = text[b:e + len(README_END)]
    assert committed == render_block(acc), (
        "README.md benchmark table is stale — run "
        "`python bench_e2e.py --render-readme`")
