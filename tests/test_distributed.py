"""Multi-process distributed simulation (SURVEY.md section 4: multi-device
testing without a multi-card host).

Two localhost processes initialize jax.distributed on the CPU backend,
each encodes its shard of a batch, and the variable-length bitstreams are
gathered in submission order with parallel/api.ragged_gather_ordered.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_WORKER = """
import os, sys
sys.path.insert(0, os.getcwd())
import jax

proc = int(sys.argv[1])
jax.distributed.initialize(coordinator_address="127.0.0.1:{port}",
                           num_processes=2, process_id=proc)
assert jax.process_count() == 2

import numpy as np
from nhwcodec_tpu.parallel import api
from nhwcodec_tpu.utils import fixtures

img = fixtures.near_flat() if proc == 0 else fixtures.gradient_circles()
streams, m = api.encode_batch(np.stack([img]), 20, workers=0)
assert m.failures == 0
all_streams = api.ragged_gather_ordered([streams[0]])
assert len(all_streams) == 2
lens = [len(s) for s in all_streams]
# every process sees both streams, ordered by process id
print("LENS", proc, lens)

import nhwcodec_tpu
for s in all_streams:
    nhwcodec_tpu.decode(s)
print("OK", proc)
"""


_WORKER_SHARDED = """
import os, sys
sys.path.insert(0, os.getcwd())
import jax

proc = int(sys.argv[1])
jax.distributed.initialize(coordinator_address="127.0.0.1:{port}",
                           num_processes=2, process_id=proc)
assert jax.process_count() == 2
assert len(jax.local_devices()) == 2  # 4 global devices, 2 per process

import numpy as np
from nhwcodec_tpu.models import encoder
from nhwcodec_tpu.parallel import api, mesh as M
from nhwcodec_tpu.utils import fixtures

# 8-image global batch, 4 per process, sharded over each process's
# local 2-device mesh (DP inside the process, DCN-analog gather across)
imgs = np.stack(list(fixtures.all_images().values()) * 2)
lo = proc * 4
local = imgs[lo: lo + 4]
m = M.make_mesh(jax.local_devices())
streams, mp = M.encode_batch_sharded(m, local, 20)
assert all(s is not None for s in streams)

all_streams = api.ragged_gather_ordered(streams)
assert len(all_streams) == 8
ref = [encoder.encode(im, 20) for im in imgs]
assert all_streams == ref  # byte-equality vs single-process encode
print("OK", proc, [len(s) for s in all_streams])
"""


def test_two_process_sharded_codec_step(tmp_path):
    """The full sharded codec step under real
    multi-process jax.distributed — 2 processes x 2 local CPU devices,
    encode_batch_sharded per process, ordered cross-process gather,
    byte-equality vs the single-process encoder."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=2")
    code = _WORKER_SHARDED.replace("{port}", str(port))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    oks = [line for o in outs for line in o.splitlines()
           if line.startswith("OK")]
    assert len(oks) == 2
    # both processes gathered the same ordered stream lengths
    assert oks[0].split()[2:] == oks[1].split()[2:]


def test_two_process_ragged_gather(tmp_path):
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = _WORKER.replace("{port}", str(port))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    assert all("OK" in o for o in outs)
    # both processes saw the same ordered length list
    lens = [line for o in outs for line in o.splitlines()
            if line.startswith("LENS")]
    assert len(lens) == 2
    assert lens[0].split()[2:] == lens[1].split()[2:]
