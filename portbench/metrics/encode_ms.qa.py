"""Milliseconds a batch in InferenceEngine.batched_encode (the tower,
the pooling; host clock around the call, ending in a synchronize): the
window's total over its batches."""


def read(run):
    qa = [r for r in run.records if r["kind"] == "qa"]
    if not qa:
        return None
    return 1e3 * sum(r["encode_s"] for r in qa) / len(qa)
