"""scan_rows_per_s: rows scanned by every query of the window over the
window's seconds."""


def read(run):
    rows = run.facts.get("rows_per_query")
    return rows * len(run.queries) / run.window_s if rows and run.queries else None
