"""Milliseconds a batch in InferenceEngine.generate_tokens (the prefill
and the decode loop, until the tokens are on the host): the window's
total over its batches."""


def read(run):
    qa = [r for r in run.records if r["kind"] == "qa"]
    if not qa:
        return None
    return 1e3 * sum(r["generate_s"] for r in qa) / len(qa)
