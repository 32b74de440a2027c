"""Multi-host (pod/DCN) helpers: a REAL 2-process run over a TCP
coordinator with Gloo CPU collectives — jax.distributed init, global mesh,
per-host batch slicing, cross-process reduction."""

import socket
import subprocess
import sys
from pathlib import Path

def test_two_process_global_mesh_and_reduction():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = Path(__file__).parent / "multihost_worker.py"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out.decode())
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert "global sum OK 84.0" in out


def test_two_process_sharded_train_step_and_checkpoint(tmp_path):
    """Full DDP train-through: one sharded SSL train step in both processes
    (gradient all-reduce over the Gloo backend), params bit-identical across
    hosts afterwards, then a checkpoint save + restore — the 4-GPU DDP
    role of /root/reference/assets/slurm/ssl-train-av2.sh:3,31."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    worker = Path(__file__).parent / "multihost_train_worker.py"
    ckpt_dir = tmp_path / "mh_ckpts"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(ckpt_dir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outputs.append(out.decode())
    checks = []
    for i, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        line = [ln for ln in out.splitlines() if "train step OK" in ln]
        assert line, out[-2000:]
        checks.append(line[0].split("checksum")[-1].strip())
    assert checks[0] == checks[1], checks


def test_host_local_batch_slice_single_process():
    from himo_tpu.parallel import multihost

    assert multihost.host_local_batch_slice(8) == slice(0, 8)
