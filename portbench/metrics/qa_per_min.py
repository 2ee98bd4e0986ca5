"""Answers completed in the window over the window's minutes (host
clock; the window closes when the step running at --seconds ends)."""


def read(run):
    qa = [r for r in run.records if r["kind"] == "qa"]
    if not qa:
        return None
    return sum(r["answers"] for r in qa) / (run.window_s / 60.0)
