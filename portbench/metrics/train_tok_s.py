"""Non-pad tokens (video tokens included) of the optimizer steps that
completed in the window, over the window's seconds (host clock; a step
completes when its loss is on the host)."""


def read(run):
    steps = [r for r in run.records if r["kind"] == "train"]
    if not steps:
        return None
    return sum(r["tokens"] for r in steps) / run.window_s
