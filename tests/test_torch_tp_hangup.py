"""A streaming client that hangs up mid-answer leaves the plain and the
batching server under --mesh_model 2 --dist_backend gloo --device cpu in
step: rank 0's write fails inside the replicated ChatModel.respond,
which parallel/driver.py latches until the call has run to its end on
both ranks, and the next request gets the answer it got before the
hang-up (tests/torch_tp_pair.hangup_leader, on the tiny f32 model with
its logits masked to byte tokens so it answers in text). Rank 0 runs in
a process of its own: ranks out of step hang in mismatched collectives,
and the timeout fails the test instead."""

import os
import subprocess
import sys


def test_tp_stream_hang_up_keeps_serving(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join((here, os.path.dirname(here))))
    done = subprocess.run(
        [sys.executable, "-c", "import sys, torch_tp_pair; "
         "torch_tp_pair.hangup_leader(sys.argv[1])",
         f"file://{tmp_path}/hangup_store"],
        cwd=here, env=env, timeout=120, capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.splitlines()[-1] == "served", done.stdout
