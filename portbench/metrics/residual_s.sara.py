"""Seconds of the exact residual a major cycle, to its fetch (host clock)."""


def read(run):
    s = run.spans.get("residual", [])
    return sum(s) / len(s) if s else None
