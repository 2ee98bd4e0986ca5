"""The port of the JAX package's dryrun_multichip (its sharded train step
and decode check), python -m video_llava_tpu_torch.scripts.dryrun_multichip
--ranks 4 --device cpu: 4 gloo ranks on a 2 x 2 mesh with FSDP and
projector+embed tuning take one step with a finite loss (the same on
every rank), and greedy decode on that mesh, each data row of ranks
decoding its own 2 rows, equals one process's decode of the 4 rows token
for token (the script exits non-zero otherwise)."""

import math
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_on_four_ranks():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m",
         "video_llava_tpu_torch.scripts.dryrun_multichip", "--ranks", "4",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    m = re.search(r"dryrun_multichip train: mesh=\[2, 2\], loss=(\S+)",
                  proc.stdout)
    assert m and math.isfinite(float(m.group(1))), proc.stdout
    assert "dryrun_multichip decode parity: OK" in proc.stdout
