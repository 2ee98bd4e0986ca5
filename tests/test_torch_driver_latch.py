"""parallel/driver.py keeps the ranks in step when a callback passed to
a replicated call raises on rank 0 (a streaming client that hung up):
the followers run it as a no-op, so rank 0 latches it, runs the call to
its end in step with them, then raises; the next call finds the ranks in
step. Rank 0 runs in a process of its own
(tests/torch_tp_pair.latch_leader), since ranks out of step hang in
mismatched collectives: the timeout fails the test instead."""

import os
import subprocess
import sys


def test_driver_latches_a_failing_callback(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        (here, os.path.dirname(here))))
    done = subprocess.run(
        [sys.executable, "-c", "import sys, torch_tp_pair; "
         "torch_tp_pair.latch_leader(sys.argv[1])",
         f"file://{tmp_path}/latch_store"],
        cwd=here, env=env, timeout=60, capture_output=True, text=True)
    assert done.returncode == 0, done.stdout + done.stderr
    assert done.stdout.splitlines()[-1] == "latched", done.stdout
