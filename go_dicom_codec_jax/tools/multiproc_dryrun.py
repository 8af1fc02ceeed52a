"""Two-process multi-host dryrun (SURVEY §2.10-3 multi-host sharding).

The single-process mesh story (parallel/mesh.py, __graft_entry__.
dryrun_multichip) validates sharding inside one process; this tool adds
the multi-HOST dimension: two OS processes join one jax.distributed
coordinator, build one global 8-device CPU mesh (4 virtual devices per
process), run the frame-axis-sharded J2K device transform over a global
batch, and each process finishes the host entropy stage for its
ADDRESSABLE shard only. Byte identity with the in-process scalar
encoder is asserted per frame, across the process boundary.

Usage: python -m go_dicom_codec_jax.tools.multiproc_dryrun
Prints one MP| JSON line; exit 0 = both processes byte-identical.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

F, H, W, LEVELS, BITS = 8, 64, 60, 3, 12


def _frames():
    import numpy as np
    rng = np.random.default_rng(11)
    return rng.integers(0, 1 << BITS, size=(F, H, W)).astype(np.int32)


def _child(role: int, port: int, out_path: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=2, process_id=role)
    import hashlib

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
    from ..ops.dwt53 import fwd53_multilevel
    from ..ops.mct import dc_level_shift

    devs = np.array(jax.devices())          # 8 global (4 local each)
    assert devs.size == 2 * jax.local_device_count()
    mesh = Mesh(devs.reshape(-1), ("frames",))
    sharding = NamedSharding(mesh, P("frames"))

    frames = _frames()                       # same on both processes

    def make(idx):
        return jnp.asarray(frames[idx[0]])

    garr = jax.make_array_from_callback((F, H, W), sharding, make)

    @jax.jit
    def stage(x):                            # [F, H, W] int32
        comps = dc_level_shift(x[:, None], BITS, False)
        return fwd53_multilevel(comps, LEVELS, x0=0, y0=0)

    coeffs = jax.jit(stage, out_shardings=sharding)(garr)

    enc = J2KEncoder(J2KEncodeParams(num_levels=LEVELS))
    shas = {}
    for shard in coeffs.addressable_shards:
        data = np.asarray(shard.data)        # [f_local, C, H, W]
        base = shard.index[0].start or 0
        for i in range(data.shape[0]):
            fi = base + i
            stream = enc.encode(frames[fi], W, H, 1, BITS,
                                precomputed_tiles=[data[i]])
            # cross-check vs the fully scalar encoder in this process
            scalar = enc.encode(frames[fi], W, H, 1, BITS)
            assert stream == scalar, f"frame {fi} diverged from scalar"
            shas[fi] = hashlib.sha256(stream).hexdigest()
    with open(out_path, "w") as f:
        json.dump({"role": role, "local_devices": jax.local_device_count(),
                   "shas": shas}, f)


def main(argv=None) -> int:
    if os.environ.get("GDCT_MP_ROLE") is not None:
        _child(int(os.environ["GDCT_MP_ROLE"]),
               int(os.environ["GDCT_MP_PORT"]),
               os.environ["GDCT_MP_OUT"])
        return 0

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="gdct_mp_")
    procs = []
    for role in (0, 1):
        env = dict(os.environ)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
            "GDCT_MP_ROLE": str(role),
            "GDCT_MP_PORT": str(port),
            "GDCT_MP_OUT": os.path.join(tmp, f"r{role}.json"),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "go_dicom_codec_jax.tools.multiproc_dryrun"], env=env))
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        print("MP|" + json.dumps({"ok": False, "rcs": rcs}))
        return 1
    results = [json.load(open(os.path.join(tmp, f"r{r}.json")))
               for r in (0, 1)]
    covered = {}
    for r in results:
        covered.update({int(k): v for k, v in r["shas"].items()})
    ok = (sorted(covered) == list(range(F))
          and all(r["local_devices"] == 4 for r in results)
          and len(results[0]["shas"]) == len(results[1]["shas"]) == F // 2)
    print("MP|" + json.dumps({
        "ok": ok, "frames": sorted(covered),
        "per_process": [sorted(int(k) for k in r["shas"]) for r in results],
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
