"""Two-process multi-host sharding (SURVEY §2.10-3).

Runs tools/multiproc_dryrun.py: two OS processes join one
jax.distributed coordinator over a global 8-device CPU mesh, the
frame-sharded J2K device stage runs across both, and each process
encodes its addressable shard byte-identically to the scalar encoder.
"""

import json
import os
import subprocess
import sys


def test_two_process_sharded_encode_byte_identity():
    env = dict(os.environ)
    # the tool sets its own JAX env per child; the parent needs none
    env.pop("GDCT_MP_ROLE", None)
    r = subprocess.run(
        [sys.executable, "-m", "go_dicom_codec_jax.tools.multiproc_dryrun"],
        capture_output=True, text=True, timeout=560, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert r.returncode == 0, r.stdout + r.stderr
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MP|")][-1]
    payload = json.loads(line[3:])
    assert payload["ok"] and payload["frames"] == list(range(8))
    # each process covered exactly its half of the global batch
    assert payload["per_process"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
