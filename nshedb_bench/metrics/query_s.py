"""query_s: the window's seconds over the queries completed in it."""


def read(run):
    return run.window_s / len(run.queries) if run.queries else None
