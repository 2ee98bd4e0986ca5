"""The port's benchmark orchestrator (eval/evaluate_benchmark.py) against
the stub judge server of tests/test_evaluate_benchmark.py."""

import json
import threading
from http.server import ThreadingHTTPServer

from test_evaluate_benchmark import _StubJudge
from video_llava_tpu.eval import evaluate_benchmark as jax_bench
from video_llava_tpu_torch.eval import evaluate_benchmark


def test_orchestrator_matches_jax(tmp_path):
    """Over HTTP to a local stub judge (the JAX test's): the per-axis
    summary the JAX package's orchestrator writes, field for field; the
    axis whose predictions are missing (temporal) is skipped."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), _StubJudge)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    api = f"http://127.0.0.1:{server.server_address[1]}/v1"
    try:
        pred_dir = tmp_path / "preds"
        pred_dir.mkdir()
        general = [
            {"video_name": "v1", "question": "q", "answer": "a", "pred": "p"},
            {"video_name": "v2", "question": "q", "answer": "a", "pred": "p"},
        ]
        consistency = [
            {"video_name": "v1", "Q1": "q1", "Q2": "q2", "A": "a",
             "pred1": "p", "pred2": "p"}
        ]
        (pred_dir / "general.json").write_text(json.dumps(general))
        (pred_dir / "consistency.json").write_text(json.dumps(consistency))
        summaries = []
        for mod, side in ((jax_bench, "jax"), (evaluate_benchmark, "port")):
            out_dir = tmp_path / side
            mod.main(["--pred_dir", str(pred_dir), "--output_dir",
                      str(out_dir), "--api_base", api, "--num_tasks", "2"])
            summaries.append(json.loads(
                (out_dir / "benchmark_summary.json").read_text()))
    finally:
        server.shutdown()
    want, got = summaries
    assert got == want
    assert got["correctness"]["average_score"] == 3.0
    assert "temporal" not in got
